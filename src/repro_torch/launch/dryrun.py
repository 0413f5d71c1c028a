"""Dry run on H100 meshes: count every (arch x shape x mesh) step at full
size on fake tensors and emit roofline terms per device. The counterpart
of ``repro/launch/dryrun.py``.

``repro`` lowers and compiles each (arch x shape x mesh) for 512
placeholder CPU devices and divides XLA's cost analysis by TPU v5e figures.
The port traces for ``repro``'s two pod meshes, 16 x 16 and 2 x 16 x 16,
on H100s (``--mesh single|multi|both``), and for one H100 (``--mesh card``,
the default). On a pod mesh the process starts a fake process group of
256 or 512 ranks (``launch/mesh.py``: ``fake_group``, this process rank 0),
installs ``repro``'s rules (``SINGLE_POD_RULES`` / ``MULTI_POD_RULES``,
``decode_rules`` for long_500k) and places the fake model, Adam's state,
the batch and the cache as DTensors by ``param_pspecs`` / ``input_pspecs``
/ ``cache_pspecs`` (``models/sharding.py``); the step's ``constrain``s
redistribute, the flash ops run on each rank's shards by their sharding
strategies, and ``StepCounter`` counts rank 0's local ops and the
collectives the redistributions issue, so every row is per device:
FLOPs, bytes, memory (``fits_one_card`` against one card's 80 GB) and the
collective term over the link each group crosses (a 16-rank group spans
two 8-card nodes, so every pod collective crosses the network). The mesh
is a ``cuda`` mesh of fake CUDA tensors where a CUDA runtime is present,
a ``cpu`` mesh of fake CPU tensors where not; both count the same
(``roofline.fake_trace_placement``). Nothing moves between ranks and
nothing is measured.

On the one-card mesh each step is traced eagerly under ``FakeTensorMode`` with the card as
its device (``trace_device``; ``meta`` where no CUDA runtime is present, as
in a CPU-only build, since indexing a fake CUDA tensor needs one): the
model (``ArchSpec.abstract_params``), the batch (``input_specs``), Adam's
state and the decode cache (``abstract_cache``) are fake tensors, so nothing is allocated on any device and no kernel is
launched (the flash attention's custom ops take their shape function).
``launch/roofline.py``'s ``StepCounter`` counts the FLOPs, bytes accessed
and peak live bytes of the traced step, and the terms divide them by the
H100 SXM5's data sheet figures. Nothing is measured: the numbers are what
one H100 80GB HBM3 would need, not what it took. ``chip_smoke.py`` grounds
the counter against real steps on the card.

The steps are ``repro``'s: the training step with ``adam(1e-3,
weight_decay=0.01)`` (its microbatches included), prefill (last-position
logits) and the one-token serve step on the cache of ``seq_len``. A traced
training step is step 1: ``adam`` turns a bf16 model's parameters f32 there
(ROADMAP C6), so its peak holds both; ``traced_dtype`` says which model
dtype was traced.

``repro`` compiles two depth probes (and three sequence probes) of each
step because XLA counts a loop body once; the eager trace counts every
layer, so ``--no-probes`` selects nothing.

Usage (no card needed):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
        --mesh both --out build/dryrun/dryrun.json
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import SHAPES, resolve_shape
from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import (POD_SHAPES, fake_group, make_card_mesh,
                                     make_production_mesh, mesh_device_type, pod_name)
from repro_torch.models import sharding as SH
from repro_torch.train import optimizer as opt_lib
from repro_torch.utils import get_logger
from repro_torch.utils.pytree import tree_leaves, tree_num_params

log = get_logger("repro_torch.dryrun")

FAKE_CARD = torch.device("cuda", 0)  # with an index: "cuda" alone asks CUDA which card


def trace_device() -> torch.device:
    """The fake tensors' device: the card's where a CUDA runtime is present,
    else ``meta``. A build without CUDA can make fake CUDA tensors, but
    indexing one (``x[:, -1]``) or recording one in autograd takes the CUDA
    device guard, which such a build does not have; no count depends on the
    device, so there the same trace runs on fake meta tensors."""
    return FAKE_CARD if torch.cuda.is_available() else torch.device("meta")


COUNTED_ON = ("counted on fake tensors against H100 SXM5 80GB HBM3 data sheet figures "
              f"({RL.BF16_FLOPS / 1e12:.0f} TFLOP/s bf16, {RL.F32_FLOPS / 1e12:.0f} TFLOP/s "
              f"f32, {RL.HBM_BW / 1e12:.2f} TB/s; links {RL.LINK_BW / 1e9:.0f} GB/s NVLink 4 "
              f"within an 8-card node, {RL.NET_BW / 1e9:.0f} GB/s ConnectX-7 NDR across "
              "nodes); nothing ran on a card, nothing was measured")
MESHES = {"card": [None], "single": [False], "multi": [True], "both": [False, True]}


# ----------------------------------------------------------------- counting
def count_active(spec, model) -> float:
    """Active parameters: MoE expert weights scaled by top_k / E (the
    router counts in full), as ``repro``'s ``_count_active``."""
    total = float(tree_num_params(model))
    if spec.kind == "whisper" or spec.lm is None or spec.lm.moe is None:
        return total
    moe = spec.lm.moe
    inactive = 1.0 - moe.top_k / moe.num_experts
    expert = sum(p.numel() for name, p in model.named_parameters()
                 if ".moe." in name and not name.endswith(".router"))
    return total - expert * inactive


def count_step(spec, shape, model, batch, cache=None,
               on_ready: Optional[Callable[[], None]] = None, mesh=None) -> Dict[str, Any]:
    """Run one step of ``shape`` (train, prefill or decode) on ``model`` and
    ``batch`` (and ``cache`` for decode) under a ``StepCounter``: fake
    tensors for the dry run, real ones on the card. Returns the counter,
    the bytes of the step's arguments and of its new outputs, and the
    output. A training step builds Adam's state first and counts it as an
    argument. ``on_ready`` is called once every argument exists, just
    before the step (a caller on the card reads the allocator there).
    On DTensors (``mesh``, the device mesh they are placed on) every count
    is this rank's."""
    s = resolve_shape(shape)
    counter = RL.StepCounter(mesh)
    if s.kind == "train":
        opt = opt_lib.adam(1e-3, weight_decay=0.01)
        state = opt.init(dict(model.named_parameters()))
        args = (model, state, batch)
        fn = spec.make_train_step(opt)
    elif s.kind == "prefill":
        args, fn = (model, batch), spec.make_prefill()
    else:
        args, fn = (model, cache, batch), spec.make_serve_step()
    arg_bytes = counter.track(args)
    before = {id(RL._local(t).untyped_storage()) for t in tree_leaves(args)
              if isinstance(t, torch.Tensor)}
    if on_ready is not None:
        on_ready()
    with counter:
        out = fn(*args)
    outs = [RL._local(t).untyped_storage() for t in tree_leaves(out)
            if isinstance(t, torch.Tensor)]
    new = {id(st): st.nbytes() for st in outs if id(st) not in before}
    return {"counter": counter, "arg_bytes": arg_bytes, "output_bytes": sum(new.values()),
            "out": out}


def pod_rules(shape, multi_pod: bool) -> Dict[str, Any]:
    """``repro``'s rules for ``shape`` on a pod mesh: ``MULTI_POD_RULES`` or
    ``SINGLE_POD_RULES``, under ``decode_rules`` for long_500k."""
    rules = SH.MULTI_POD_RULES if multi_pod else SH.SINGLE_POD_RULES
    return SH.decode_rules(rules) if resolve_shape(shape).name == "long_500k" else rules


def _fake_step(spec, shape, mesh=None, rules=None) -> Dict[str, Any]:
    """``count_step`` on fake tensors: the abstract model, inputs and cache
    of ``shape``, on ``trace_device()``; with a device ``mesh``, on its
    device type and placed on it by ``rules``."""
    s = resolve_shape(shape)
    if mesh is None:
        dev = trace_device()
        with FakeTensorMode():
            model = spec.abstract_params(dev)
            batch = spec.input_specs(s, dev)
            cache = spec.abstract_cache(s, dev) if s.kind == "decode" else None
            return {**count_step(spec, s, model, batch, cache), "device": str(dev)}
    dev = FAKE_CARD if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    # DTensor's bookkeeping puts small host tensors beside the fake shards
    with SH.use_rules(rules), FakeTensorMode(allow_non_fake_inputs=True), \
            RL.fake_trace_placement():
        model = SH.place_model(spec.abstract_params(dev), mesh, spec.param_pspecs())
        batch = SH.place_tree(spec.input_specs(s, dev), mesh, spec.input_pspecs(s))
        cache = (SH.place_tree(spec.abstract_cache(s, dev), mesh, spec.cache_pspecs())
                 if s.kind == "decode" else None)
        return {**count_step(spec, s, model, batch, cache, mesh=mesh),
                "device": f"{dev} on a {mesh.device_type} mesh"}


def row_of(spec, arch_id: str, shape, res: Dict[str, Any], trace_s: float,
           n_params: float, n_active: float, mesh_name: str, chips: int) -> Dict[str, Any]:
    s = resolve_shape(shape)
    c = res["counter"]
    tokens = s.global_batch * (s.seq_len if s.kind != "decode" else 1)
    model_flops = RL.model_flops_estimate(n_params, n_active, tokens,
                                          "train" if s.kind == "train" else "fwd")
    rl = RL.analyze(arch=arch_id, shape=s.name, mesh_name=mesh_name, chips=chips, counter=c,
                    arg_bytes=res["arg_bytes"], model_flops=model_flops, n_params=n_params,
                    n_params_active=n_active)
    temp = max(c.peak_bytes - res["arg_bytes"] - res["output_bytes"], 0)
    mem = {"argument_bytes": int(res["arg_bytes"]), "output_bytes": int(res["output_bytes"]),
           "temp_bytes": int(temp), "peak_bytes": int(c.peak_bytes),
           "total_gb": c.peak_bytes / 1e9}
    tc, rest = RL.split_flops(c)
    return {
        "arch": arch_id, "shape": s.name, "mesh": mesh_name, "status": "ok", "chips": chips,
        "kind": s.kind, "compile_s": trace_s, "memory": mem,
        "n_params": n_params, "n_params_active": n_active,
        "flops_per_device": rl.flops_per_device, "bytes_per_device": rl.bytes_per_device,
        "collective_bytes_per_device": rl.collective_bytes_per_device,
        "collective_breakdown": rl.collective_breakdown,
        "raw_scan_counts": {"flops": rl.flops_per_device, "bytes": rl.bytes_per_device,
                            "coll": rl.collective_bytes_per_device},
        "collectives": c.collective_table(),
        "compute_s": rl.compute_s, "memory_s": rl.memory_s, "collective_s": rl.collective_s,
        "dominant": rl.dominant, "model_flops": model_flops, "useful_ratio": rl.useful_ratio,
        "fits_one_card": c.peak_bytes <= RL.CARD_BYTES, "traced_dtype": str(spec.dtype)[6:],
        "flops_by_dtype": dict(c.flops), "tensor_core_flops": tc, "other_flops": rest,
        "flash_calls": {k: v for k, v in c.calls.items() if k.startswith("g4r.")},
        "traced_device": f"fake {res['device']}", "counted_on": COUNTED_ON,
    }


def run_one(arch_id: str, shape: str, multi_pod: Optional[bool] = None,
            reduced: bool = False, probes: bool = True, spec=None,
            layers: Optional[int] = None) -> Dict[str, Any]:
    """One row of the dry run: on ``1xH100`` (``multi_pod`` None), on 16 x 16
    (False) or on 2 x 16 x 16 (True), per device. A pod row starts a fake
    group of the mesh's size for itself unless the caller runs one of that
    size already. ``probes`` is ``repro``'s argument and selects nothing
    (the trace counts every layer). ``layers`` cuts the depth to that many
    layers, whole periods of the block pattern (``ArchSpec.with_layers``);
    the row then says so in ``layers``."""
    if multi_pod is None:
        mesh_name, chips = make_card_mesh().name, 1
    else:
        mesh_name, chips = pod_name(multi_pod), math.prod(POD_SHAPES[multi_pod][0])
    base = {"arch": arch_id, "shape": shape, "mesh": mesh_name}
    try:
        spec = spec if spec is not None else get_arch(arch_id, reduced=reduced)
        if layers is not None:
            spec = spec.with_layers(layers)
            base["layers"] = layers
        ok, reason = spec.supports(shape)
        if not ok:
            return {**base, "status": "skipped", "reason": reason}
        meta = spec.abstract_params()
        n_params, n_active = float(tree_num_params(meta)), count_active(spec, meta)
        del meta
        t0 = time.perf_counter()
        if multi_pod is None:
            res = _fake_step(spec, shape)
        else:
            with _pod_group(chips):
                mesh = make_production_mesh(multi_pod=multi_pod, device_type=mesh_device_type())
                res = _fake_step(spec, shape, mesh, pod_rules(shape, multi_pod))
        out = {**row_of(spec, arch_id, shape, res, time.perf_counter() - t0, n_params,
                        n_active, mesh_name, chips), **base}
        log.info(
            "OK %-20s %-12s %-8s compile=%5.1fs mem=%7.2fGB "
            "comp=%.2es mem=%.2es coll=%.2es dom=%-10s useful=%.2f",
            arch_id, shape, mesh_name, out["compile_s"], out["memory"]["total_gb"],
            out["compute_s"], out["memory_s"], out["collective_s"], out["dominant"],
            out["useful_ratio"],
        )
        return out
    except Exception as e:
        log.error("FAIL %s %s %s: %s", arch_id, shape, mesh_name, e)
        return {**base, "status": "error", "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:]}


def _pod_group(chips: int):
    """The caller's process group where it has ``chips`` ranks, else a fake
    group of ``chips`` ranks for the block."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() == chips:
        return contextlib.nullcontext()
    return fake_group(chips)


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--rows", default="",
                    help="arch:shape pairs, comma-separated, in place of --arch x --shape")
    ap.add_argument("--mesh", default="card", choices=list(MESHES),
                    help="16x16 (single), 2x16x16 (multi), both, or one H100 (card)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut every row to this many layers (whole periods of the block "
                         "pattern), at full width")
    ap.add_argument("--no-probes", action="store_true",
                    help="selects nothing: repro compiles depth probes because XLA counts a "
                         "loop body once; the eager trace counts every layer")
    ap.add_argument("--out", default="build/dryrun/dryrun.json")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    rows = ([tuple(r.split(":")) for r in args.rows.split(",")] if args.rows
            else [(a, s) for a in archs for s in shapes])
    meshes = MESHES[args.mesh]
    names = ", ".join(make_card_mesh().name if m is None else pod_name(m) for m in meshes)
    print(f"dry run on {names}: {COUNTED_ON}", flush=True)
    results = [run_one(a, s, m, reduced=args.reduced, layers=args.layers)
               for a, s in rows for m in meshes]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    existing: Dict[Tuple[str, str, str], Dict] = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            for r in json.load(f):
                existing[(r["arch"], r["shape"], r["mesh"])] = r
    for r in results:
        existing[(r["arch"], r["shape"], r["mesh"])] = r
    with open(args.out, "w") as f:
        json.dump(list(existing.values()), f, indent=1)

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped, {n_err} errors -> {args.out}")
    if n_err:
        for r in results:
            if r["status"] == "error":
                print(f"  ERROR {r['arch']} {r['shape']} {r['mesh']}: {r['error']}")
        raise SystemExit(1)


if __name__ == "__main__":
    main()
