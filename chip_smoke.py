#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Needs one NVIDIA card with nvcc; with no CUDA it exits non-zero before any
work. It puts ``src/`` and ``examples/`` on ``sys.path`` itself and imports
nothing of JAX or of the JAX package ``repro``. Phases, each failing loudly:

1. the card's ``nvidia-smi`` name and power limit, torch and CUDA versions;
   TF32 off (it would reorder near-tied top-k scores);
2. build the kernels from ``src/repro_torch/kernels/csrc`` with nvcc (timed);
3. the main path, through ``examples/recall_torch.py``'s ``run``: the UB
   dataset (8,000 users, 20,000 items), LightGCN at dim 64 with two
   relations, fanouts (4, 3) and side info in bag mode, random weights from a
   seed; every node embedded on the card, then U2I/ICF/UCF recall with the
   device top-k. Kernel launch counts are zeroed just before and read just
   after, and the inputs of every kernel call are recorded. Device recall is
   then held against the numpy brute-force oracle (1e-3 on every metric) and
   a small graph's embeddings against the CPU path;
4. kernel phases: each kernel against its plain PyTorch version on the
   card, on the inputs of every call the main path made, then at synthetic
   shapes (all ``seg_aggr`` modes, larger ``topk`` problems, an int-valued
   tie case); one JSON line per shape with the kernel's device time, the
   plain version's, one library call's and the card's bound;
5. a ``kernels`` JSON line (times from the main path's largest call of
   each kernel), then ``{"ok": true, "device": ...}`` last.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12  # H100 SXM data sheet, non-tensor-core f32
RTOL, ATOL = 1e-5, 1e-6  # kernel vs plain version: the two sum in other orders
TOPK_TIE_TOL = 1e-5  # ids may differ only inside score near-ties this wide
RECALL_TOL = 1e-3  # device vs brute-force recall, every metric


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def measure(fn, iters: int, warmup: int = 2) -> dict:
    """Time ``iters`` back-to-back calls of ``fn`` on the card.

    ``call_ms``: CUDA events around the loop, per call; it includes launch
    overhead whenever the host is slower than the kernels. ``device_ms``:
    the device time of every kernel and copy in the loop, per call, from
    ``torch.profiler`` (CUPTI). Every time the script reports as ``ms`` is
    a ``device_ms``; it fails where the profiler saw no device time.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(stop) / iters
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    if dev_us <= 0:
        fail("torch.profiler saw no device time: CUPTI tracing is not working")
    return {"call_ms": call_ms, "device_ms": dev_us / iters / 1e3}


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


@contextlib.contextmanager
def recording(module, name: str, calls: list):
    """Append the arguments of every call of ``module.name`` to ``calls``."""
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, real)


def first_of_each_shape(calls: list, shape_of) -> list:
    """The first call of each distinct ``shape_of(call)``, in call order."""
    seen = {}
    for c in calls:
        seen.setdefault(shape_of(c), c)
    return list(seen.values())


# ----------------------------------------------------------------- kernels
def _seg_record(torch, ref, seg_aggr_cuda, x, mask, mode, source: str, iters: int) -> dict:
    n, f, d = x.shape
    got = seg_aggr_cuda(x, mask, mode)
    want = ref.seg_aggr_ref(x, mask, mode)
    torch.cuda.synchronize()
    if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        fail(f"seg_aggr {mode} {(n, f, d)} ({source}) disagrees with its plain version")
    mf = mask.float()
    # one einsum against precomputed per-neighbour weights (sum and mean);
    # max has no single library call
    w = {"sum": mf, "mean": mf / mf.sum(1, keepdim=True).clamp(min=1.0)}.get(mode)
    kern = measure(lambda: seg_aggr_cuda(x, mask, mode), iters)
    plain = measure(lambda: ref.seg_aggr_ref(x, mask, mode), iters)
    lib = None if w is None else measure(lambda: torch.einsum("nfd,nf->nd", x, w), iters)
    rec = {
        "phase": "kernel", "name": "seg_aggr", "source": source, "mode": mode,
        "shape": [n, f, d], "contiguous": x.is_contiguous(),
        "max_abs_err": (got - want).abs().max().item(),
        "kernel_ms": kern["device_ms"], "plain_ms": plain["device_ms"],
        "library_ms": None if lib is None else lib["device_ms"],
        "kernel_call_ms": kern["call_ms"], "plain_call_ms": plain["call_ms"],
        "library_call_ms": None if lib is None else lib["call_ms"],
    }
    rec["bound_ms"], rec["bound_by"] = bound_ms(n * f * d * 4 + n * f + n * d * 4, n * f * d)
    emit(rec)
    return rec


def seg_aggr_phase(torch, ref, seg_aggr_cuda, calls: list) -> dict:
    """Every main-path call against the plain version; each of its shapes
    timed on its recorded inputs; then every mode at synthetic shapes."""
    worst = 0.0
    for (x, mask, mode), _ in calls:
        got, want = seg_aggr_cuda(x, mask, mode), ref.seg_aggr_ref(x, mask, mode)
        torch.cuda.synchronize()
        if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
            fail(f"seg_aggr {mode} {tuple(x.shape)}: a main-path call disagrees "
                 "with its plain version")
        worst = max(worst, (got - want).abs().max().item())
    emit({"phase": "kernel", "name": "seg_aggr", "source": "main path, every call",
          "calls": len(calls), "max_abs_err": worst})
    recs = [_seg_record(torch, ref, seg_aggr_cuda, x, mask, mode, "main path", 200)
            for (x, mask, mode), _ in first_of_each_shape(
                calls, lambda c: (tuple(c[0][0].shape), c[0][2]))]
    main = max(recs, key=lambda r: r["shape"][0] * r["shape"][1])

    gen = torch.Generator(device="cuda").manual_seed(0)
    for (n, f, d) in ((8192, 3, 64), (1024, 4, 64), (262144, 3, 64)):
        x = torch.randn(n, f, d, device="cuda", generator=gen)
        mask = torch.rand(n, f, device="cuda", generator=gen) < 0.7
        mask[::7] = False  # rows with no valid neighbour
        for mode in ("sum", "mean", "max"):
            rec = _seg_record(torch, ref, seg_aggr_cuda, x, mask, mode, "synthetic",
                              20 if n > 100000 else 200)
            worst = max(worst, rec["max_abs_err"])
    return dict(main, max_abs_err=worst)


def _check_topk(torch, s, i, s0, i0, what: str) -> float:
    err = (s - s0).abs().max().item()
    scale = max(1.0, s0.abs().max().item())
    if err > TOPK_TIE_TOL * scale:
        fail(f"topk {what}: scores differ from the plain version by {err}")
    bad = (i != i0).nonzero().tolist()
    for r, c in bad:  # an id may differ only where the plain scores nearly tie
        near = ((s0[r] - s0[r, c]).abs() <= TOPK_TIE_TOL * scale).sum().item()
        if near < 2:
            fail(f"topk {what}: id differs at ({r}, {c}) without a near-tie")
    return err


def _topk_record(torch, ref, streaming_topk_cuda, q, it, k, ex, source: str) -> dict:
    (Q, d), I, E = q.shape, it.shape[0], 0 if ex is None else ex.shape[1]
    s, i = streaming_topk_cuda(q, it, k, ex)
    s0, i0 = ref.chunked_topk_ref(q, it, k, ex)
    torch.cuda.synchronize()
    err = _check_topk(torch, s, i, s0, i0, f"{source} Q={Q} I={I} k={k} E={E}")
    big = I > 100000
    kern = measure(lambda: streaming_topk_cuda(q, it, k, ex), 5 if big else 50)
    plain = measure(lambda: ref.chunked_topk_ref(q, it, k, ex), 2 if big else 10, warmup=1)
    # the yardstick: one dense product + topk, without the exclusion
    lib = measure(lambda: torch.topk(q @ it.T, k), 5 if big else 50)
    rec = {
        "phase": "kernel", "name": "topk", "source": source,
        "shape": {"Q": Q, "I": I, "d": d, "k": k, "E": E},
        "max_abs_err": err, "ids_mismatched": int((i != i0).sum().item()),
        "kernel_ms": kern["device_ms"], "plain_ms": plain["device_ms"],
        "library_ms": lib["device_ms"], "kernel_call_ms": kern["call_ms"],
        "plain_call_ms": plain["call_ms"], "library_call_ms": lib["call_ms"],
    }
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        (Q * d + I * d + Q * E) * 4 + Q * k * 8, 2.0 * Q * I * d)
    emit(rec)
    return rec


def topk_phase(torch, ref, streaming_topk_cuda, calls: list) -> dict:
    """Every main-path call against the plain version; each of its shapes
    (U2I, ICF, UCF, in call order) timed on its recorded inputs; then
    larger synthetic problems and an int-valued tie case."""
    worst, mismatched = 0.0, 0
    for (q, it, k), kw in calls:
        ex = kw.get("exclude")
        s, i = streaming_topk_cuda(q, it, k, ex)
        s0, i0 = ref.chunked_topk_ref(q, it, k, ex)
        torch.cuda.synchronize()
        worst = max(worst, _check_topk(torch, s, i, s0, i0, f"main-path call Q={q.shape[0]} "
                                                           f"I={it.shape[0]} k={k}"))
        mismatched += int((i != i0).sum().item())
    emit({"phase": "kernel", "name": "topk", "source": "main path, every call",
          "calls": len(calls), "max_abs_err": worst, "ids_mismatched": mismatched})
    # the first call of each search is a full query chunk
    recs = [_topk_record(torch, ref, streaming_topk_cuda, q, it, k, kw.get("exclude"),
                         "main path")
            for (q, it, k), kw in first_of_each_shape(
                calls, lambda c: (c[0][1].shape[0], c[0][2]))]
    main = recs[0]  # U2I: the main path's first and largest search

    gen = torch.Generator(device="cuda").manual_seed(1)
    Q, d, k, E = 1024, 64, 100, 32
    for I in (20000, 1_000_000):
        q = torch.randn(Q, d, device="cuda", generator=gen)
        it = torch.randn(I, d, device="cuda", generator=gen)
        ex = torch.randint(-1, I, (Q, E), device="cuda", generator=gen, dtype=torch.int32)
        worst = max(worst, _topk_record(torch, ref, streaming_topk_cuda, q, it, k, ex,
                                        "synthetic")["max_abs_err"])
    # int-valued embeddings: exact f32 scores, real ties -> ids must be equal
    q = torch.randint(-3, 4, (128, 16), device="cuda", generator=gen).float()
    it = torch.randint(-3, 4, (65536, 16), device="cuda", generator=gen).float()
    ex = torch.randint(-1, 65536, (128, 6), device="cuda", generator=gen, dtype=torch.int32)
    s, i = streaming_topk_cuda(q, it, 100, ex)
    s0, i0 = ref.chunked_topk_ref(q, it, 100, ex)
    if not (torch.equal(i, i0) and torch.equal(s, s0)):
        fail("topk: int-valued tie case is not exact (lower id must win)")
    emit({"phase": "kernel", "name": "topk", "case": "int-valued ties, Q=128 I=65536",
          "exact": True})
    return dict(main, max_abs_err=worst)


# --------------------------------------------------------------- main path
def main_path(torch, np, modules) -> dict:
    seg_mod, topk_mod = modules["seg_aggr"], modules["topk"]
    import recall_torch
    from repro_torch import convert
    from repro_torch.core.recall import evaluate_recall
    from repro_torch.graph import TOY, DistributedGraphEngine, generate
    from repro_torch.infer import embed_all_nodes
    from repro_torch.kernels import ops

    # warm-up and reference: a small graph on the card and on the CPU path
    toy = generate(TOY, seed=0)
    cfg = recall_torch.model_config(toy.graph, "lightgcn", 64, side_info=True)
    model = convert.init_params(cfg, seed=0, device="cpu")
    eng = DistributedGraphEngine(toy.graph, num_partitions=4)
    e_cpu = embed_all_nodes(model, eng, toy.graph, batch_size=128, seed=1, device="cpu")
    e_gpu = embed_all_nodes(model, eng, toy.graph, batch_size=128, seed=1, device="cuda")
    if not np.allclose(e_gpu, e_cpu, rtol=1e-5, atol=1e-5):
        fail(f"TOY embeddings, card vs CPU path: max diff {np.abs(e_gpu - e_cpu).max()}")

    args = recall_torch.parser().parse_args(
        ["--dataset", "ub", "--model", "lightgcn", "--dim", "64", "--side-info",
         "--seed", "0", "--batch-size", "1024"])
    calls = {"seg_aggr": [], "topk": []}
    with recording(ops, "seg_aggr", calls["seg_aggr"]), \
            recording(ops, "streaming_topk", calls["topk"]):
        seg_mod.launches = topk_mod.launches = 0
        res = recall_torch.run(args)
        torch.cuda.synchronize()
        launches = {"seg_aggr": seg_mod.launches, "topk": topk_mod.launches}

    ds, emb = res["dataset"], res["embeddings"]
    if emb.shape != (ds.graph.num_nodes, 64) or not np.isfinite(emb).all():
        fail(f"embeddings: shape {emb.shape}, finite {np.isfinite(emb).all()}")
    for name, n in launches.items():
        if n == 0:
            fail(f"the main path launched no {name} kernel")
    ue, ie = emb[: ds.num_users], emb[ds.num_users : ds.num_users + ds.num_items]
    train = recall_torch.train_pairs(ds)

    t0 = time.perf_counter()
    u2i = evaluate_recall(ue, ie, train, ds.test_pairs, strategies=("u2i",), device="cuda")
    u2i_s = time.perf_counter() - t0
    trained_users = set(train[:, 0].tolist())
    n_queries = len({int(u) for u in ds.test_pairs[:, 0]} & trained_users)

    # device vs the numpy brute-force oracle on the same embeddings
    kw = dict(max_users=1000, seed=0)
    dev = evaluate_recall(ue, ie, train, ds.test_pairs, method="device", device="cuda", **kw)
    bf = evaluate_recall(ue, ie, train, ds.test_pairs, method="bruteforce", **kw)
    diff = {k: abs(dev[k] - bf[k]) for k in bf}
    if dev.keys() != bf.keys() or max(diff.values()) > RECALL_TOL:
        fail(f"device vs brute-force recall differ: {diff}")
    out = {
        "phase": "main_path", "dataset": "ub", "model": "lightgcn", "dim": 64,
        "nodes": int(emb.shape[0]), "embed_s": res["embed_s"],
        "nodes_per_s": emb.shape[0] / res["embed_s"], "recall_s": res["recall_s"],
        "recall": res["recall"], "u2i_queries": n_queries, "u2i_s": u2i_s,
        "u2i_queries_per_s": n_queries / u2i_s, "u2i_recall": u2i["u2i"],
        "launches": launches, "wrapper_calls": {n: len(c) for n, c in calls.items()},
        "device_vs_bruteforce_max_diff": max(diff.values()),
        "toy_card_vs_cpu_max_diff": float(np.abs(e_gpu - e_cpu).max()),
    }
    emit(out)
    return dict(out, calls=calls)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a CUDA card")
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run it from a checkout of the repo")
    sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "examples")]
    import numpy as np

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import build, ref
    from repro_torch.kernels import seg_aggr as seg_mod
    from repro_torch.kernels import topk as topk_mod

    t0 = time.perf_counter()
    lib = build.build(verbose=True)
    build.library()
    emit({"phase": "build", "library": os.path.relpath(lib, ROOT),
          "seconds": time.perf_counter() - t0})

    mp = main_path(torch, np, {"seg_aggr": seg_mod, "topk": topk_mod})
    seg = seg_aggr_phase(torch, ref, seg_mod.seg_aggr_cuda, mp["calls"]["seg_aggr"])
    topk = topk_phase(torch, ref, topk_mod.streaming_topk_cuda, mp["calls"]["topk"])

    def entry(name, rec, source, replaces):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": mp["launches"][name], "max_abs_err": rec["max_abs_err"],
                "ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"]}

    emit({"kernels": [
        entry("seg_aggr", seg, "src/repro_torch/kernels/csrc/seg_aggr.cu",
              "src/repro/kernels/seg_aggr.py:45"),
        entry("topk", topk, "src/repro_torch/kernels/csrc/topk.cu",
              "src/repro/kernels/topk.py:77"),
    ]})
    print(smi, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
