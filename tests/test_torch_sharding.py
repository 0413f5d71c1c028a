"""The port's sharding rules (``repro_torch.models.sharding``), the abstract
specs' mesh-axis tuples and the parameter server's ``ps_lookup``, held
against ``repro``'s.

The ``*_pspecs`` of all ten full archs equal ``repro``'s ``PartitionSpec``s
under its three rule sets. ``repro`` stacks each layer kind on a leading
(scan) axis, one stack per offset of the block pattern, whose spec entry is
None; the port holds one module per layer, keyed by its name in
``named_parameters()``: layer i takes offset i % period's spec less that
leading entry. ``ps_lookup`` equals ``repro``'s on ``make_host_mesh()`` with
its gradient equal to ``jax.grad``'s; a two-rank gloo group on the CPU
(``mp``) shows the pull over two shards equal to the plain lookup and the
push landing only on the owning shard.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_arch as repro_arch
from repro.embedding import EmbeddingConfig, SlotSpec
from repro.embedding import init_params as repro_init
from repro.embedding import lookup as repro_lookup
from repro.embedding import param_specs as repro_param_specs
from repro.embedding import ps_lookup as repro_ps_lookup
from repro.launch.mesh import make_host_mesh as repro_host_mesh
from repro.models import sharding as RS
from repro_torch.configs.registry import get_arch
from repro_torch.embedding import table as TT
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import sharding as S

pytestmark = pytest.mark.quick

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RULES = [("cpu", S.CPU_RULES, RS.CPU_RULES),
         ("single_pod", S.SINGLE_POD_RULES, RS.SINGLE_POD_RULES),
         ("multi_pod", S.MULTI_POD_RULES, RS.MULTI_POD_RULES),
         ("decode", S.decode_rules(S.SINGLE_POD_RULES), RS.decode_rules(RS.SINGLE_POD_RULES))]


def test_rules_equal_repro():
    assert S.CPU_RULES == RS.CPU_RULES
    assert S.SINGLE_POD_RULES == RS.SINGLE_POD_RULES
    assert S.MULTI_POD_RULES == RS.MULTI_POD_RULES
    for base in (S.SINGLE_POD_RULES, S.MULTI_POD_RULES):
        assert S.decode_rules(base) == RS.decode_rules(base)


def test_use_rules_nests_and_restores():
    assert S.current_rules() is S.CPU_RULES
    with S.use_rules(S.SINGLE_POD_RULES):
        # one-axis tuples as their axis, as PartitionSpec normalises them
        assert S.spec("batch", None, "heads") == ("data", None, "model")
        assert S.spec("fsdp") == tuple(P(("data",)))
        with S.use_rules(S.MULTI_POD_RULES):
            assert S.spec("batch") == (("pod", "data"),)
        assert S.current_rules() is S.SINGLE_POD_RULES
        with pytest.raises(RuntimeError):
            with S.use_rules(S.MULTI_POD_RULES):
                raise RuntimeError("inside")
        assert S.current_rules() is S.SINGLE_POD_RULES
    assert S.current_rules() is S.CPU_RULES
    assert S.spec("batch", "heads") == (None, None)
    x = torch.ones(3)
    with S.use_rules(S.SINGLE_POD_RULES):
        assert S.constrain(x, "batch") is x  # one device: the identity
    assert S.constrain(x, "batch") is x


def _tup(p):
    return tuple(p)


def _flat(prefix, tree, out, drop_lead):
    for name, v in tree.items():
        if isinstance(v, dict):
            _flat(f"{prefix}{name}.", v, out, drop_lead)
        else:
            t = _tup(v)
            out[prefix + name] = t[1:] if drop_lead else t
    return out


def _repro_param_specs(rspec):
    """``repro``'s spec tree in the port's layout: per layer, by name."""
    tree = rspec.param_pspecs()
    out = {}
    if rspec.kind == "whisper":
        for key in ("enc_pos", "dec_pos", "embed"):
            out[key] = _tup(tree[key])
        for stack in ("enc_layers", "dec_layers"):
            for i in range(rspec.whisper.n_layers):
                _flat(f"{stack}.{i}.", tree[stack], out, True)
        for key in ("enc_norm", "dec_norm"):
            _flat(f"{key}.", tree[key], out, False)
        return out
    p = rspec.lm.period()
    out["embed"] = _tup(tree["embed"])
    for i in range(rspec.lm.n_layers):
        _flat(f"layers.{i}.", tree["layers"][i % p], out, True)
    _flat("final_norm.", tree["final_norm"], out, False)
    if "lm_head" in tree:
        out["lm_head"] = _tup(tree["lm_head"])
    return out


def _repro_cache_specs(rspec):
    tree = rspec.cache_pspecs()
    if rspec.kind == "whisper":
        n = rspec.whisper.n_layers
        return {"self": [{k: _tup(v)[1:] for k, v in tree["self"].items()}] * n,
                "cross_k": [_tup(tree["cross_k"])[1:]] * n,
                "cross_v": [_tup(tree["cross_v"])[1:]] * n, "t": _tup(tree["t"])}
    p = rspec.lm.period()
    return {"layers": [{k: _tup(v)[1:] for k, v in tree["layers"][i % p].items()}
                       for i in range(rspec.lm.n_layers)], "t": _tup(tree["t"])}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_pspecs_equal_repro_under_every_rule_set(arch):
    rspec, spec = repro_arch(arch), get_arch(arch)
    names = [n for n, _ in spec.abstract_params().named_parameters()]
    for _, ours, theirs in RULES:
        with S.use_rules(ours), RS.use_rules(theirs):
            got = spec.param_pspecs()
            assert sorted(got) == sorted(names)
            assert got == _repro_param_specs(rspec)
            assert spec.cache_pspecs() == _repro_cache_specs(rspec)
            for shape in ("train_4k", "prefill_32k", "decode_32k"):
                want = {k: _tup(v) for k, v in rspec.input_pspecs(shape).items()}
                assert spec.input_pspecs(shape) == want


def test_embedding_param_specs_equal_repro():
    cfg = EmbeddingConfig(num_nodes=16, dim=4, slots=(SlotSpec("cat", 5, 2),))
    assert TT.param_specs(cfg) == {k: _tup(v) for k, v in repro_param_specs(cfg).items()}
    assert TT.param_specs(cfg, "data") == {k: _tup(v)
                                           for k, v in repro_param_specs(cfg, "data").items()}


def test_ps_lookup_equals_repro_on_the_host_mesh():
    """One rank of one (no process group), as ``repro``'s 1 x 1 host mesh."""
    assert make_host_mesh().axis_sizes()["model"] == repro_host_mesh().shape["model"] == 1
    cfg = EmbeddingConfig(num_nodes=16, dim=4)
    table = repro_init(jax.random.PRNGKey(0), cfg)["node"]
    ids = jnp.array([[0, 5], [15, -1]])
    want = repro_ps_lookup(table, ids, repro_host_mesh())
    got = TT.ps_lookup(torch.tensor(np.asarray(table)), torch.tensor(np.asarray(ids)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(repro_lookup(table, ids)))


@pytest.mark.parametrize("ids", [[1, 1, 3], [[0, 5, -1], [7, 7, 2]]])
def test_ps_lookup_grad_equals_jax(ids):
    """The push: the cotangent lands on the touched rows only, as
    ``jax.grad`` of ``repro``'s gives it (repeats summed, PAD nowhere)."""
    cfg = EmbeddingConfig(num_nodes=8, dim=2)
    table = repro_init(jax.random.PRNGKey(0), cfg)["node"]
    mesh = repro_host_mesh()
    w = np.random.default_rng(0).standard_normal(np.shape(ids) + (2,)).astype(np.float32)

    def f(tab):
        return (repro_ps_lookup(tab, jnp.array(ids), mesh) * w).sum()

    want = np.asarray(jax.grad(f)(table))
    t = torch.tensor(np.asarray(table)).requires_grad_()
    (TT.ps_lookup(t, torch.tensor(ids)) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-6, atol=0)
    untouched = sorted(set(range(8)) - set(np.ravel(ids).tolist()))
    assert not t.grad[untouched].any()


WORKER = textwrap.dedent("""
    import json, os, sys
    import torch
    import torch.distributed as dist
    from repro_torch.embedding.table import lookup, ps_lookup

    rank, world, init = int(sys.argv[1]), 2, sys.argv[2]
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    g = torch.Generator().manual_seed(0)
    table = torch.randn((8, 3), generator=g)
    ids = torch.tensor([[0, 5, -1], [7, 7, 2], [3, 4, 4]])
    rows_per = table.shape[0] // world
    shard = table[rank * rows_per:(rank + 1) * rows_per].clone().requires_grad_()
    out = ps_lookup(shard, ids)
    w = torch.randn(out.shape, generator=g)
    (out * w).sum().backward()
    full = table.clone().requires_grad_()
    (lookup(full, ids) * w).sum().backward()
    want = full.grad[rank * rows_per:(rank + 1) * rows_per]
    print(json.dumps({"pull": torch.equal(out.detach(), lookup(table, ids)),
                      "push": torch.equal(shard.grad, want),
                      "touched": shard.grad.abs().sum(1).gt(0).tolist()}))
    dist.destroy_process_group()
""")


@pytest.mark.mp
def test_ps_lookup_over_two_gloo_ranks(tmp_path):
    script = tmp_path / "ps_worker.py"
    script.write_text(WORKER)
    init = f"file://{tmp_path / 'store'}"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    procs = [subprocess.Popen([sys.executable, str(script), str(r), init], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    import json

    results = []
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        results.append(json.loads(out.strip().splitlines()[-1]))
    assert all(r["pull"] and r["push"] for r in results)
    # ids touch rows 0, 2, 3, 4, 5, 7: rank 0 owns 0-3, rank 1 owns 4-7
    assert results[0]["touched"] == [True, False, True, True]
    assert results[1]["touched"] == [True, True, False, True]
