"""The multi-card slice of the port: ``repro``'s pod meshes as DeviceMeshes,
parameters, batches and caches placed as DTensors by the sharding rules,
``constrain`` redistributing them, the flash ops' sharding strategies and
the per-device dry run with its collective terms, held against ``repro``.

- Rank 0's shard of every parameter of the ten full archs, placed by
  ``SINGLE_POD_RULES`` on 16 x 16 and ``MULTI_POD_RULES`` on 2 x 16 x 16
  over a fake process group, has the shape GSPMD gives rank 0 for
  ``repro``'s spec on an ``AbstractMesh`` of the same axes (its ceiling
  where the dim does not divide).
- Reduced dry-run steps of every block kind trace on the pod meshes, per
  device: FLOPs at most the one-card count and, times the chips, at least
  it; a training step's collectives positive. On 16 x 16 every kind takes
  its prefill, decode and training step; on 2 x 16 x 16 the dense, MoE,
  VLM and Whisper kinds their prefill and decode. The 3-D mesh's training
  steps and SSD rows take DTensor a minute or more each to place, so they
  are the sweep's (``launch/dryrun.py --mesh both``), not these tests'.
- The counter's wire bytes of each collective kind equal
  ``repro.launch.roofline.collective_bytes`` on an HLO line of the same
  result shape and group.
- Four gloo ranks (``mp``, subprocesses): reduced smollm and OLMoE placed on
  (2, 2) by ``SINGLE_POD_RULES`` and on (2, 1, 2) by ``MULTI_POD_RULES``;
  their prefill logits, loss, gradients and one Adam step's parameters
  equal the single-process port to rtol 1e-5 (values near zero to 1e-5 of
  the largest; parameters within lr, Adam's step on a gradient within
  rounding of zero) and ``repro`` on the same converted weights to 1e-4
  (the conformance record's tolerance); the flash op's
  heads- and batch-sharded calls equal the plain call and a
  sequence-sharded K/V is gathered before it.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_arch as jax_get_arch
from repro.configs.registry import ARCH_IDS
from repro.launch import roofline as repro_roofline
from repro.train import optimizer as jax_opt
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import POD_SHAPES, fake_group, make_mesh, make_production_mesh
from repro_torch.models import sharding as SH
from repro_torch.train import optimizer as opt_lib

pytestmark = pytest.mark.quick

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": (False, SH.SINGLE_POD_RULES), "2x16x16": (True, SH.MULTI_POD_RULES)}
KINDS = ["smollm-135m", "olmoe-1b-7b", "mamba2-1.3b", "jamba-v0.1-52b", "qwen2-vl-7b",
         "whisper-tiny"]
SMALL = {"train": ShapeSpec("t", 256, 64, "train"), "prefill": ShapeSpec("p", 256, 64, "prefill"),
         "decode": ShapeSpec("d", 64, 64, "decode")}
GLOO_ARCHS = ["smollm-135m", "olmoe-1b-7b"]
B, S, LR = 4, 32, 1e-3


@pytest.fixture(params=list(MESHES))
def pod(request):
    """A fake group of the mesh's size, its mesh and rules; destroyed after."""
    multi, rules = MESHES[request.param]
    shape, _ = POD_SHAPES[multi]
    with fake_group(int(np.prod(shape))):
        yield request.param, make_production_mesh(multi_pod=multi, device_type="cpu"), rules


def _gspmd_shard_shape(mesh_shape, axes, entries, shape):
    """Rank 0's shard under ``repro``'s spec: ``shard_shape``, or GSPMD's
    ceiling where a dim does not divide by its tiling."""
    sharding = NamedSharding(AbstractMesh(tuple(mesh_shape), tuple(axes)), P(*entries))
    try:
        return tuple(sharding.shard_shape(tuple(shape)))
    except ValueError:
        tiles = sharding._to_xla_hlo_sharding(len(shape)).tile_assignment_dimensions()
        return tuple(-(-d // t) for d, t in zip(shape, tiles))


# ---------------------------------------------------------- parameter shards
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rank0_parameter_shards_equal_gspmd(pod, arch):
    name, mesh, rules = pod
    multi = name == "2x16x16"
    spec = get_arch(arch)
    with SH.use_rules(rules), FakeTensorMode(allow_non_fake_inputs=True):
        pspecs = spec.param_pspecs()
        model = SH.place_model(spec.abstract_params("cpu"), mesh, pspecs)
        shapes, axes = POD_SHAPES[multi]
        for pname, p in model.named_parameters():
            want = _gspmd_shard_shape(shapes, axes, pspecs[pname], p.shape)
            assert tuple(p.to_local().shape) == want, (arch, pname, p.placements)


def test_placements_of_tuple_entries(pod):
    name, mesh, rules = pod
    from torch.distributed.tensor import Replicate, Shard

    with SH.use_rules(rules):
        got = SH.placements(mesh, SH.spec("batch", "seq", None))
    if name == "16x16":
        assert got == [Shard(0), Shard(1)]
    else:  # ("pod", "data") shards dim 0 over both, in mesh order
        assert got == [Shard(0), Shard(0), Shard(1)]
    with pytest.raises(KeyError):
        SH.placements(mesh, ("pipe", None))
    assert SH.placements(mesh, (None, None)) == [Replicate()] * mesh.ndim


# ------------------------------------------------------- reduced dry-run rows
_ONE_CARD = {}


def _one_card(arch, kind):
    if (arch, kind) not in _ONE_CARD:
        res = dryrun._fake_step(get_arch(arch, reduced=True), SMALL[kind])
        _ONE_CARD[arch, kind] = res["counter"].total_flops
    return _ONE_CARD[arch, kind]


ROWS = [("16x16", a) for a in KINDS] + [
    ("2x16x16", a) for a in KINDS if get_arch(a).family not in ("ssm", "hybrid")]


@pytest.mark.parametrize("name,arch", ROWS)
def test_reduced_rows_every_kind_on_the_pod_meshes(name, arch):
    multi, rules = MESHES[name]
    spec = get_arch(arch, reduced=True)
    kinds = ["prefill", "decode"] + (["train"] if name == "16x16" else [])
    with fake_group(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        chips = mesh.size()
        for kind in kinds:
            res = dryrun._fake_step(spec, SMALL[kind], mesh, rules)
            row = dryrun.row_of(spec, arch, SMALL[kind], res, 0.0, 1.0, 1.0, name, chips)
            assert row["status"] == "ok" and row["chips"] == chips
            flops, one = row["flops_per_device"], _one_card(arch, kind)
            assert 0 < flops <= one and flops * chips >= one, (arch, kind, flops, one)
            assert row["collective_bytes_per_device"] >= 0 and row["collective_s"] >= 0
            if kind == "train":
                assert row["collective_bytes_per_device"] > 0 and row["collective_s"] > 0
                assert row["collectives"] and all(c["mesh_dims"] for c in row["collectives"])


def test_run_one_selects_the_mesh():
    row = dryrun.run_one("smollm-135m", "long_500k", multi_pod=True, reduced=True)
    assert (row["status"], row["mesh"]) == ("skipped", "2x16x16")
    assert dryrun.run_one("smollm-135m", "long_500k", reduced=True)["mesh"] == "1xH100"


# --------------------------------------------------------------- collectives
def _hlo(kind, result, group, world=256):
    op = {"permute": "collective-permute"}.get(kind, kind)
    return (f"  %c = {result} {op}(f32[8]{{0}} %x), "
            f"replica_groups=[{world // group},{group}]<=[{world}]")


@pytest.mark.parametrize("kind", ["all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                                  "permute"])
def test_wire_bytes_equal_repro(kind):
    for group, shape in ((16, (4, 256)), (2, (3, 5, 7)), (256, (1024,))):
        nb = int(np.prod(shape)) * 4
        result = f"f32[{','.join(map(str, shape))}]{{0}}"
        got = roofline.wire_bytes(kind, nb, group)
        want, _ = repro_roofline.collective_bytes(_hlo(kind, result, group), default_group=group)
        assert got == pytest.approx(want, rel=1e-12), (kind, group)


def test_counter_records_each_redistribution():
    """Each redistribution of a DTensor on an 8-rank mesh, under the
    counter: its kind, result bytes, group and wire bytes as ``repro``
    counts the same HLO collective."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    with fake_group(8):
        mesh = make_mesh((8,), ("model",), "cpu")
        cases = [([Shard(0)], [Replicate()], "all-gather"),
                 ([Partial()], [Replicate()], "all-reduce"),
                 ([Partial()], [Shard(0)], "reduce-scatter"),
                 ([Shard(0)], [Shard(1)], "all-to-all")]
        for src, dst, kind in cases:
            with FakeTensorMode(allow_non_fake_inputs=True), roofline.fake_trace_placement():
                from torch.distributed.tensor import DTensor

                x = DTensor.from_local(torch.empty(64, 32), mesh, src, run_check=False)
                counter = roofline.StepCounter(mesh)
                with counter:
                    x.redistribute(mesh, dst)
            (rec,) = counter.collective_table()
            assert (rec["kind"], rec["group_size"], rec["mesh_dims"], rec["calls"]) == (
                kind, 8, ["model"], 1)
            shape = {"all-gather": (512, 32), "all-reduce": (64, 32),
                     "reduce-scatter": (8, 32), "all-to-all": (512, 4)}[kind]
            assert rec["bytes"] == int(np.prod(shape)) * 4
            want, _ = repro_roofline.collective_bytes(
                _hlo(kind, f"f32[{shape[0]},{shape[1]}]{{1,0}}", 8, 8), default_group=8)
            assert rec["wire_bytes"] == pytest.approx(want)
            assert counter.collective_s() == pytest.approx(want / roofline.LINK_BW)


def test_collective_link_by_node():
    """A group within one 8-card node crosses NVLink, one spanning nodes
    the network: 16-rank groups of a 16 x 16 mesh span two nodes."""
    with fake_group(256):
        mesh = make_production_mesh(multi_pod=False, device_type="cpu")
        counter = roofline.StepCounter(mesh)
        size, dims, in_node = counter._group(mesh.get_group("model").group_name)
        assert (size, dims, in_node) == (16, ("model",), False)
    with fake_group(8):
        mesh = make_mesh((2, 4), ("data", "model"), "cpu")
        counter = roofline.StepCounter(mesh)
        assert counter._group(mesh.get_group("model").group_name) == (4, ("model",), True)


def test_fake_group_is_destroyed():
    import torch.distributed as dist

    with fake_group(4):
        assert dist.get_world_size() == 4
        with pytest.raises(RuntimeError):
            with fake_group(4):
                pass
    assert not dist.is_initialized()


# ----------------------------------------------------------- four gloo ranks
WORKER = textwrap.dedent("""
    import dataclasses as dc, pickle, sys
    import torch
    import torch.distributed as dist
    from repro_torch import convert
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch import roofline
    from repro_torch.models import sharding as SH
    from repro_torch.train import optimizer as opt_lib
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    rank, init, data, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=4)
    torch.use_deterministic_algorithms(True)
    with open(data, "rb") as f:
        d = pickle.load(f)
    out = {}
    meshes = {"single": ((2, 2), ("data", "model"), SH.SINGLE_POD_RULES),
              "multi": ((2, 1, 2), ("pod", "data", "model"), SH.MULTI_POD_RULES)}
    for mname in d["meshes"]:
        shape, axes, rules = meshes[mname]
        mesh = make_mesh(shape, axes, "cpu")
        for arch in d["archs"]:
            spec = get_arch(arch, reduced=True)
            spec = dc.replace(spec, lm=dc.replace(spec.lm, dtype="float32"))
            batch = {k: torch.from_numpy(v) for k, v in d["batch"][arch].items()}
            model = convert.lm_params_from_numpy(spec.lm, d["params"][arch], device="cpu")
            with SH.use_rules(rules):
                SH.place_model(model, mesh, spec.param_pspecs())
                pb = SH.place_tree(batch, mesh, spec.input_pspecs("train_4k"))
                logits = spec.make_prefill()(model, {"tokens": pb["tokens"]}).full_tensor()
                named = dict(model.named_parameters())
                lossd = spec.make_train_loss()(model, pb)
                grads = torch.autograd.grad(lossd, list(named.values()))
                grads = {n: g.full_tensor().numpy() for n, g in zip(named, grads)}
                loss = lossd.detach().full_tensor()
                opt = opt_lib.adam(d["lr"])
                state = opt.init(dict(model.named_parameters()))
                model, state, step_loss = spec.make_train_step(opt)(model, state, pb)
                params = {n: p.detach().full_tensor().numpy()
                          for n, p in model.named_parameters()}
            out[f"{mname}/{arch}"] = {"logits": logits.numpy(), "loss": loss.numpy(),
                                      "grads": grads,
                                      "step_loss": step_loss.full_tensor().numpy(),
                                      "params": params}
    # the flash op's strategies on the (2, 2) mesh
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    g = torch.Generator().manual_seed(0)
    q = torch.randn((4, 16, 4, 8), generator=g)
    k = torch.randn((4, 16, 2, 8), generator=g)
    v = torch.randn((4, 16, 2, 8), generator=g)
    plain = ops.flash_attention(q, k, v, True, None)
    flash = {}
    for name, (pq, pkv) in {"heads": ([Replicate(), Shard(2)], [Replicate(), Shard(2)]),
                             "batch": ([Shard(0), Replicate()], [Shard(0), Replicate()]),
                             "seq": ([Shard(0), Replicate()], [Shard(0), Shard(1)])}.items():
        dq = distribute_tensor(q, mesh, pq)
        dk, dv = distribute_tensor(k, mesh, pkv), distribute_tensor(v, mesh, pkv)
        counter = roofline.StepCounter(mesh)
        with counter:
            o = ops.flash_attention(dq, dk, dv, True, None)
        flash[name] = {"equal": bool(torch.equal(o.full_tensor(), plain)),
                       "placements": str(tuple(o.placements)),
                       "gathers": [c["kind"] for c in counter.collective_table()]}
    out["flash"] = flash
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(out, f)
    dist.destroy_process_group()
""")


def _f32(spec):
    return dataclasses.replace(spec, lm=dataclasses.replace(spec.lm, dtype="float32"))


def _repro_params(arch, seed):
    jspec = _f32(jax_get_arch(arch, reduced=True))
    jparams = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                     jspec.init_params(jax.random.PRNGKey(seed)))
    return jspec, jparams, jax.tree_util.tree_map(np.asarray, jparams)


def _batch(spec, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, spec.lm.vocab, (B, S)).astype(np.int64)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}


def _port_single(spec, tree, batch):
    model = convert.lm_params_from_numpy(spec.lm, tree, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = spec.make_prefill()(model, {"tokens": tb["tokens"]})
    named = dict(model.named_parameters())
    loss = spec.make_train_loss()(model, tb)
    grads = torch.autograd.grad(loss, list(named.values()))
    grads = {n: g.numpy() for n, g in zip(named, grads)}
    loss = loss.detach()
    opt = opt_lib.adam(LR)
    state = opt.init(dict(model.named_parameters()))
    model, _, step_loss = spec.make_train_step(opt)(model, state, tb)
    return {"logits": logits.numpy(), "loss": loss.numpy(), "step_loss": step_loss.numpy(),
            "grads": grads,
            "params": {n: p.detach().numpy() for n, p in model.named_parameters()}}


def _repro(jspec, jparams, batch):
    jb = {k: jnp.asarray(v.astype(np.int32)) for k, v in batch.items()}
    logits = jspec.make_prefill()(jparams, {"tokens": jb["tokens"]})
    loss = jspec.make_train_loss()(jparams, jb)
    opt = jax_opt.adam(LR)
    new, _, step_loss = jax.jit(jspec.make_train_step(opt))(jparams, opt.init(jparams), jb)
    return {"logits": np.asarray(logits), "loss": np.asarray(loss),
            "step_loss": np.asarray(step_loss), "params": new}


def _four_gloo_ranks(tmp_path, archs, meshes):
    """``WORKER`` on four gloo ranks over each of ``meshes``, for each arch of
    ``archs`` (reduced, f32): its logits, losses, gradients and one Adam
    step held against the single-process port and ``repro``. Returns the
    workers' results."""
    torch.use_deterministic_algorithms(True)
    try:
        data, want_port, want_repro = {"archs": archs, "meshes": meshes, "lr": LR,
                                       "params": {}, "batch": {}}, {}, {}
        for i, arch in enumerate(archs):
            spec = _f32(get_arch(arch, reduced=True))
            jspec, jparams, tree = _repro_params(arch, seed=11 + i)
            batch = _batch(spec, seed=21 + i)
            data["params"][arch], data["batch"][arch] = tree, batch
            want_port[arch] = _port_single(spec, tree, batch)
            want_repro[arch] = (_repro(jspec, jparams, batch), spec)
    finally:
        torch.use_deterministic_algorithms(False)
    with open(tmp_path / "data.pkl", "wb") as f:
        pickle.dump(data, f)
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    init, out = f"file://{tmp_path / 'store'}", tmp_path / "out.pkl"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), init,
                               str(tmp_path / "data.pkl"), str(out)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    try:
        results = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, results):
        assert p.returncode == 0, err[-3000:]
    with open(out, "rb") as f:
        got = pickle.load(f)
    for mname in meshes:
        for arch in archs:
            g, port = got[f"{mname}/{arch}"], want_port[arch]
            (rep, spec) = want_repro[arch]
            for key in ("logits", "loss", "step_loss"):
                # rtol 1e-5, and 1e-5 of the largest value for the values near
                # zero: the shards sum in another order
                np.testing.assert_allclose(g[key], port[key], rtol=1e-5,
                                           atol=1e-5 * np.abs(port[key]).max(),
                                           err_msg=f"{mname} {arch} {key}")
                np.testing.assert_allclose(g[key], rep[key], rtol=1e-4, atol=1e-4,
                                           err_msg=f"{mname} {arch} {key} vs repro")
            for n, grad in port["grads"].items():
                np.testing.assert_allclose(g["grads"][n], grad, rtol=1e-5,
                                           atol=1e-5 * np.abs(grad).max(),
                                           err_msg=f"{mname} {arch} gradient {n}")
            for n, p in port["params"].items():
                # Adam's first step moves each entry by at most lr, and an entry
                # whose gradient is within rounding of zero by a share of lr
                # that the summation order sets (the gradients above are tight)
                np.testing.assert_allclose(g["params"][n], p, rtol=1e-5, atol=LR,
                                           err_msg=f"{mname} {arch} {n}")
            model = convert.lm_params_from_numpy(
                spec.lm, jax.tree_util.tree_map(np.asarray, rep["params"]), device="cpu")
            for n, p in model.named_parameters():
                np.testing.assert_allclose(g["params"][n], p.detach().numpy(), rtol=1e-4,
                                           atol=1e-4, err_msg=f"{mname} {arch} {n} vs repro")
    return got


@pytest.mark.mp
def test_four_gloo_ranks_match_the_port_and_repro(tmp_path):
    got = _four_gloo_ranks(tmp_path, GLOO_ARCHS, ["single", "multi"])
    from torch.distributed.tensor import Replicate, Shard

    flash = got["flash"]
    assert all(f["equal"] for f in flash.values()), flash
    # heads and batch shards run where they lie; a sequence-sharded K/V is
    # gathered first, and the output keeps the queries' placement
    assert flash["heads"]["placements"] == str((Replicate(), Shard(2)))
    assert flash["batch"]["placements"] == flash["seq"]["placements"] == str(
        (Shard(0), Replicate()))
    assert flash["heads"]["gathers"] == [] and flash["batch"]["gathers"] == []
    assert flash["seq"]["gathers"] == ["all-gather"]


@pytest.mark.mp
def test_four_gloo_ranks_scan_the_ssd_on_their_shards(tmp_path):
    """Mamba2's chunk scan runs on each rank's batch and head shards
    (``sharding.local_apply``); B and C, replicated over the heads' mesh
    dim, take their gradients as a sum over it. On a (2, 2) mesh the
    logits, losses, every gradient and an Adam step match the port on one
    process and ``repro``."""
    _four_gloo_ranks(tmp_path, ["mamba2-1.3b"], ["single"])
