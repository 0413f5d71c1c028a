#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Needs one NVIDIA card with nvcc; with no CUDA it exits non-zero before any
work. It puts ``src/`` and ``examples/`` on ``sys.path`` itself and imports
nothing of JAX or of the JAX package ``repro``. Phases, each failing loudly:

1. the card's ``nvidia-smi`` name and power limit, torch and CUDA versions;
   TF32 off (it would reorder near-tied top-k scores), and bf16 GEMMs
   without reduced-precision split-K reductions;
2. build the kernels from ``src/repro_torch/kernels/csrc`` with nvcc (timed);
   then the flash kernel's instantiations: the bf16 ones' SASS must hold
   ``HGMMA`` (the tensor cores' wgmma; ``cuobjdump -sass`` on the built
   library), and each instantiation's registers, local memory (spills) and
   dynamic shared memory are printed, a bf16 one with local memory failing;
   the same for each ``topk`` instantiation (with resident blocks an SM and
   resident 8-block clusters) and the ``inbatch_loss`` kernel at d 64, 256
   and 768 (with resident blocks an SM): any local memory fails, and so do
   fewer than two resident blocks an SM at the main path's k 100 and d 64;
3. the serving path, through ``examples/recall_torch.py``'s ``run``: the UB
   dataset (8,000 users, 20,000 items), LightGCN at dim 64 with two
   relations, fanouts (4, 3) and side info in bag mode, random weights from a
   seed; every node embedded on the card, then U2I/ICF/UCF recall with the
   device top-k. Kernel launch counts are zeroed just before and read just
   after (``topk``: one launch a call), and the inputs of every kernel call
   are recorded. Device recall is
   then held against the numpy brute-force oracle (1e-3 on every metric) and
   a small graph's embeddings against the CPU path;
3b. IVF serving, through the same ``run`` with ``--method ivf`` (nlist 64,
   nprobe 8): recall on an int8 IVF index per corpus, whose shortlist is the
   ``ivf_list_topk`` kernel (launches zeroed before, read after, every call
   recorded); then, on the serving phase's embeddings with 1,000 users, IVF
   at nprobe == nlist held against the brute force (1e-3 on every metric)
   and the default nprobe reported beside it; U2I search rates of IVF and
   the exact ``topk`` kernel back to back, and the IVF search's time split
   (centroid probe, kernel, re-rank, host);
3c. the 1M-item arm of ``benchmarks/bench_recall.py`` (its clustered
   corpus, d 32, nlist 2048, nprobe 12, k 100, 16 exclusions, 512 queries):
   build seconds, lpad, spilled items, Recall@100 against the exact
   ``topk`` kernel (its call recorded), IVF and exact queries/s back to
   back, the time split;
4. the training path, through ``examples/train_torch.py``'s ``run``: the same
   model on UB for 200 sparse steps (``sparse_min_rows=0``: the PS-style
   gather -> step -> scatter update) of 512 pairs, in-batch softmax loss,
   host sampling with prefetch 2. Launch counts are zeroed just before and
   read just after; every output of the ``seg_aggr`` forward must carry a
   ``grad_fn``, the loss must fall, each step's dispatch is timed (CUDA
   events and the host clock, and the host time between steps), and the
   inputs of the first calls of each kernel are recorded (``row_adagrad`` works in place, so its table
   and accumulators are cloned before and after the call). Then U2I recall
   of the trained embeddings;
5. the fused training path, through the same ``run`` with
   ``--sampling-backend fused``: the same model and batch on UB for 200
   steps, walk -> pair -> ego sampled on the card inside each step (the
   ``window_pairs`` kernel), dense update. It must plan ``fused`` (the
   memory gate must not put it back on the host) and launch ``window_pairs``
   once a step; the inputs of every ``window_pairs`` call are recorded. The
   same numbers as phase 4, the device tables' bytes, and the trained U2I
   recall; then a ``sampling_backend="auto"`` run prints its plan;
6. conformance: under deterministic algorithms, TOY trained 12 steps (sparse
   and dense) on the card and on the CPU from the same initial weights, and
   twice on the card: losses and tables agree, the two card runs exactly;
   the fused step likewise, card vs CPU fed the same CPU-drawn draws, and
   two same-seed fused card runs;
6b. the LM substrate's serving side, smollm-135m at full width (30 layers,
   d_model 576, 9 heads over 3 KV heads, bf16; random weights from the
   port's init, seed 0): the prefill through ``examples/serve_lm_torch.py``'s
   ``run`` (``make_prefill`` on B 4 x S 2,048 tokens from ``default_rng(0)``,
   a warm-up and 5 timed forwards; ``flash_attention`` launches zeroed
   before, read after, 30 a forward; the first call of each shape
   recorded) and the flash kernel's share of one profiled forward's device
   time, beside the forward's host wall (which of the two sets the pace);
   prefill vs decode on 4 prompts of 256 tokens (relative max), held
   to 3e-2 in bf16 and to 1e-4 with the same weights in f32, beside each
   bf16 path's distance to f32; ``BatchedServer`` (batch 8, 32 new tokens,
   cache 256) twice on 16 requests of 8-64 tokens, greedy outputs equal,
   and the tokens the requests hold (prompts and outputs) per second;
   the reduced model in f32, card vs CPU under deterministic algorithms,
   forward and 16 decode steps to rtol/atol 1e-4;
7. kernel phases: each kernel against its plain PyTorch version on the card,
   on the recorded inputs of the main paths (``seg_aggr``: of all three;
   ``window_pairs``: every call, exactly; ``ivf_list_topk``: every call of
   the three IVF runs, rows exactly; ``flash_attention``: the LM
   prefill's recorded call, bf16 to atol 3e-2 and to 2^-4 of each output
   row's largest value, with the output's max and median |value| printed
   beside the errors; ``topk``: every call of the serving path and the 1M
   arm, each shape's launch plan (query tile, splits = cluster size,
   blocks), and the U2I call with fewer exclusions and a smaller k, to
   show where its time goes; ``inbatch_loss``: every kept call, bitwise on
   a re-run), then (``seg_aggr``,
   ``topk``, ``inbatch_loss``, ``window_pairs``, ``flash_attention``) at
   synthetic shapes (``topk``: 1,024 queries against 20,000 and 1M items,
   k 1 and k 256, an exclusion row past the shared cap, integer-valued
   ties exactly, a bitwise re-run; ``inbatch_loss``: P 2,048 and 8,192 at
   d 64, 8,192 at d 256, each beside the library call; flash: f32 to rtol
   1e-5 / atol 2e-5, causal and not, a tail tile, qwen2's G 7,
   starcoder2's bf16 (1, 8,192, 36, 4, 128) with its 4,096 window); one
   JSON line per shape with the kernel's device time, the plain version's,
   one library call's (for ``ivf_list_topk`` none, the
   plain version with ``torch.topk`` as a yardstick; for
   ``flash_attention`` ``scaled_dot_product_attention``), each with its
   source (``measure``), and the card's bound for the inputs' type (flash:
   the bf16 kernel on the tensor cores, the f32 one on the CUDA cores; also
   both bounds for comparison and, in bf16, the share of elements exactly
   equal to the plain version's);
8. a summary line of the end-to-end numbers, a ``kernels`` JSON line (times
   and their sources from each main path's largest call of each kernel),
   the card's name and power limit, then ``{"ok": true, ...}`` last.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12  # H100 SXM data sheet, non-tensor-core f32
RTOL, ATOL = 1e-5, 1e-6  # kernel vs plain version: the two sum in other orders
TOPK_TIE_TOL = 1e-5  # ids may differ only inside score near-ties this wide
RECALL_TOL = 1e-3  # device (and IVF at nprobe == nlist) vs brute-force recall, every metric
IVF_RTOL, IVF_ATOL = 2e-5, 1e-4  # ivf_list_topk vs plain: repro's own kernel tolerance
TRAJ_RTOL, TRAJ_ATOL = 1e-4, 1e-4  # card vs CPU: 12 steps of f32 updates, other orders
KEEP_CALLS = 3  # training calls recorded per kernel and shape
WARM_S = 0.05  # seconds of back-to-back calls before each timing
T0 = time.perf_counter()
EVENT_MS = 0.05  # measure(): device spans this long per call stand; shorter ones go to CUPTI
CUPTI_TRIES = 3  # profiles taken before the records CUPTI lost fail the run


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    """One JSON line, stamped with the seconds since the script started."""
    print(json.dumps(dict(obj, t_s=round(time.perf_counter() - T0, 1))), flush=True)


def measure(fn, iters: int, warmup: int = 2, floor_ms: float = 0.0) -> dict:
    """Time ``iters`` back-to-back calls of ``fn`` on the card.

    ``call_ms``: CUDA events around the loop, per call; it includes launch
    overhead whenever the host is slower than the kernels. ``device_ms``,
    the time the script reports as ``ms`` (``ms_from`` names its source):
    the loop again behind a sleep kernel that holds the stream while the
    host queues every call, so CUDA events bracket the calls' device work
    back to back, whatever the host's speed. That span stands when the card
    was still asleep once every call was queued and it is ``EVENT_MS`` or
    more a call. Else (a call that waits on the card, a loop whose launches
    fill the queue, a call so short that the microsecond or so between two
    launches would count) the device time of every kernel and copy in the
    loop comes from ``torch.profiler`` (CUPTI). CUPTI drops some of a
    loop's kernel records (on an H100, 1 to 7 of 200 in most profiles, half
    in a few), so the call's device time is each kernel's mean over the
    records kept, times its launches per call. A profile that kept fewer
    than half of some kernel's records, or whose time is under ``floor_ms``
    (a bound the card cannot beat), is taken again, and after
    ``CUPTI_TRIES`` such the run fails.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # keep the card busy for a while first: an idle card clocks down, and a
    # compute-bound kernel timed right after host-bound phases runs slow
    busy_until = time.perf_counter() + WARM_S
    while time.perf_counter() < busy_until:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(stop) / iters
    torch.cuda._sleep(int(_sleep_cycles_per_ms() * (1.25 * iters * call_ms + 1.0)))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    queued = not start.query()  # the card had not yet reached the first call
    torch.cuda.synchronize()
    span_ms = start.elapsed_time(stop) / iters
    if queued and span_ms >= EVENT_MS:
        return {"call_ms": call_ms, "device_ms": span_ms, "ms_from": "cuda events"}
    for attempt in range(CUPTI_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.count > 0]
        per_call = [max(1, round(e.count / iters)) for e in dev]
        dev_ms = sum(e.self_device_time_total / e.count * n for e, n in zip(dev, per_call)) / 1e3
        if (dev and all(2 * e.count >= n * iters for e, n in zip(dev, per_call))
                and dev_ms > floor_ms):
            return {"call_ms": call_ms, "device_ms": dev_ms, "ms_from": "cupti"}
        print(f"chip_smoke: profile {attempt + 1} of {iters} calls kept "
              f"{[e.count for e in dev]} kernel records, {dev_ms} ms a call "
              f"(floor {floor_ms} ms)", file=sys.stderr, flush=True)
    fail(f"torch.profiler lost the device records of a {call_ms} ms call {CUPTI_TRIES} times")


@functools.lru_cache(maxsize=None)
def _sleep_cycles_per_ms() -> float:
    """``torch.cuda._sleep``'s cycles per millisecond on this card."""
    import torch

    cycles = 20_000_000
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    stop.record()
    torch.cuda.synchronize()
    return cycles / start.elapsed_time(stop)


def times(**ms) -> dict:
    """``<name>_ms`` (device), ``<name>_call_ms`` and ``ms_from[name]`` of
    each ``measure()`` result (None where there is none)."""
    out: dict = {"ms_from": {}}
    for name, m in ms.items():
        out[f"{name}_ms"] = None if m is None else m["device_ms"]
        out[f"{name}_call_ms"] = None if m is None else m["call_ms"]
        out["ms_from"][name] = None if m is None else m["ms_from"]
    return out


def sm_clocks() -> str:
    """The card's current and maximum SM clock, as nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    ).stdout.strip()


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
        **times(kernel=kern, plain=plain, library=lib),
    }
    rec["bound_ms"], rec["bound_by"] = bound_ms(n * f * d * 4 + n * f + n * d * 4, n * f * d)
    emit(rec)
    return rec


def seg_aggr_phase(torch, ref, seg_aggr_cuda, paths: dict) -> dict:
    """Every recorded call of each main path (``paths``: name -> calls)
    against the plain version; each of its shapes timed on its recorded
    inputs; then every mode at synthetic shapes."""
    worst, recs = 0.0, []
    for path, calls in paths.items():
        path_worst = 0.0
        for (x, mask, mode), _ in calls:
            got, want = seg_aggr_cuda(x, mask, mode), ref.seg_aggr_ref(x, mask, mode)
            torch.cuda.synchronize()
            if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
                fail(f"seg_aggr {mode} {tuple(x.shape)}: a {path} call disagrees "
                     "with its plain version")
            path_worst = max(path_worst, (got - want).abs().max().item())
        emit({"phase": "kernel", "name": "seg_aggr", "source": f"{path} path, recorded calls",
              "calls": len(calls), "max_abs_err": path_worst})
        worst = max(worst, path_worst)
        recs += [_seg_record(torch, ref, seg_aggr_cuda, x, mask, mode, f"{path} path", 200)
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


def _topk_record(torch, ref, topk_mod, q, it, k, ex, source: str) -> dict:
    (Q, d), I, E = q.shape, it.shape[0], 0 if ex is None else ex.shape[1]
    s, i = topk_mod.streaming_topk_cuda(q, it, k, ex)
    s0, i0 = ref.chunked_topk_ref(q, it, k, ex)
    torch.cuda.synchronize()
    err = _check_topk(torch, s, i, s0, i0, f"{source} Q={Q} I={I} k={k} E={E}")
    big = I > 100000
    kern = measure(lambda: topk_mod.streaming_topk_cuda(q, it, k, ex), 5 if big else 50)
    plain = measure(lambda: ref.chunked_topk_ref(q, it, k, ex), 2 if big else 10, warmup=1)
    # the yardstick: one dense product + topk, without the exclusion
    lib = measure(lambda: torch.topk(q @ it.T, k), 5 if big else 50)
    rec = {
        "phase": "kernel", "name": "topk", "source": source,
        "shape": {"Q": Q, "I": I, "d": d, "k": k, "E": E},
        "plan": topk_mod.launch_plan(Q, I, k, q.device),
        "max_abs_err": err, "ids_mismatched": int((i != i0).sum().item()),
        **times(kernel=kern, plain=plain, library=lib),
    }
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        (Q * d + I * d + Q * E) * 4 + Q * k * 8, 2.0 * Q * I * d)
    emit(rec)
    return rec


def topk_phase(torch, ref, topk_mod, paths: dict) -> dict:
    """Every call of each main path (``paths``: name -> calls) against the
    plain version; each of its shapes (U2I, ICF, UCF, the 1M arm's exact
    search) timed on its recorded inputs with its launch plan; the U2I call
    again with fewer exclusions and a smaller k (where its time goes); then
    synthetic problems: larger ones, k 1 and k 256, an exclusion row past
    the shared cap, integer-valued ties exactly, and a bitwise re-run."""
    cuda_topk = topk_mod.streaming_topk_cuda
    worst, recs = 0.0, []
    for path, calls in paths.items():
        path_worst, mismatched = 0.0, 0
        for (q, it, k), kw in calls:
            ex = kw.get("exclude")
            s, i = cuda_topk(q, it, k, ex)
            s0, i0 = ref.chunked_topk_ref(q, it, k, ex)
            torch.cuda.synchronize()
            path_worst = max(path_worst, _check_topk(
                torch, s, i, s0, i0, f"{path} call Q={q.shape[0]} I={it.shape[0]} k={k}"))
            mismatched += int((i != i0).sum().item())
        emit({"phase": "kernel", "name": "topk", "source": f"{path}, every call",
              "calls": len(calls), "max_abs_err": path_worst, "ids_mismatched": mismatched})
        worst = max(worst, path_worst)
        # the first call of each search is a full query chunk
        recs += [_topk_record(torch, ref, topk_mod, q, it, k, kw.get("exclude"), path)
                 for (q, it, k), kw in first_of_each_shape(
                     calls, lambda c: (c[0][1].shape[0], c[0][2]))]
    main = recs[0]  # U2I: the main path's first and largest search

    (q, it, k), kw = paths["serving"][0]
    ex = kw.get("exclude")
    for kk, ee in ((k, None), (20, ex), (20, None), (1, None)):
        m = measure(lambda: cuda_topk(q, it, kk, ee), 50)
        emit({"phase": "kernel", "name": "topk", "case": "U2I call, fewer exclusions or k",
              "k": kk, "E": 0 if ee is None else ee.shape[1], **times(kernel=m)})
    s1, i1 = cuda_topk(q, it, k, ex)
    s2, i2 = cuda_topk(q, it, k, ex)
    if not (torch.equal(s1, s2) and torch.equal(i1, i2)):
        fail("topk: two runs of the U2I call differ")
    emit({"phase": "kernel", "name": "topk", "case": "U2I call run twice", "bitwise": True})

    gen = torch.Generator(device="cuda").manual_seed(1)
    for Q, I, d, k, E in ((1024, 20000, 64, 100, 32), (1024, 1_000_000, 64, 100, 32),
                          (512, 20000, 64, 1, 19), (512, 20000, 64, topk_mod.MAX_K, 19),
                          (512, 20000, 64, 100, 3 * topk_mod.EXCLUDE_CAP // 2)):
        q = torch.randn(Q, d, device="cuda", generator=gen)
        it = torch.randn(I, d, device="cuda", generator=gen)
        ex = torch.randint(-1, I, (Q, E), device="cuda", generator=gen, dtype=torch.int32)
        worst = max(worst, _topk_record(torch, ref, topk_mod, q, it, k, ex,
                                        "synthetic")["max_abs_err"])
    # int-valued embeddings: exact f32 scores, real ties -> ids must be equal
    q = torch.randint(-3, 4, (128, 16), device="cuda", generator=gen).float()
    it = torch.randint(-3, 4, (65536, 16), device="cuda", generator=gen).float()
    for E in (6, 2 * topk_mod.EXCLUDE_CAP):  # staged rows, then rows read from memory
        ex = torch.randint(-1, 65536, (128, E), device="cuda", generator=gen, dtype=torch.int32)
        s, i = cuda_topk(q, it, 100, ex)
        s0, i0 = ref.chunked_topk_ref(q, it, 100, ex)
        if not (torch.equal(i, i0) and torch.equal(s, s0)):
            fail(f"topk: int-valued tie case (E {E}) is not exact (lower id must win)")
        emit({"phase": "kernel", "name": "topk", "case": f"int-valued ties, Q=128 I=65536 E={E}",
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
    if launches["topk"] != len(calls["topk"]):
        fail(f"topk: {launches['topk']} launches for {len(calls['topk'])} calls, not one a call")
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
    return dict(out, calls=calls, embeddings=emb, bruteforce=bf)


# -------------------------------------------------------------- IVF serving
def clustered_corpus(np, rng, I: int, Q: int, d: int = 32):
    """Mixture-of-gaussians item table + queries near the same centers (a
    copy of ``benchmarks/bench_recall.py:clustered_corpus``)."""
    C = int(max(16, min(1024, I // 2048)))
    centers = rng.normal(size=(C, d)).astype(np.float32) * 3.0
    it = (centers[rng.integers(0, C, I)]
          + rng.normal(size=(I, d)).astype(np.float32))
    q = (centers[rng.integers(0, C, Q)]
         + 0.5 * rng.normal(size=(Q, d)).astype(np.float32))
    return it, q


def _zero(modules) -> None:
    """Every kernel wrapper's launch counts to 0."""
    for m in modules.values():
        m.launches = 0
    modules["seg_aggr"].bwd_launches = 0


def _u2i_queries(np, ds, train):
    """U2I's queries as ``evaluate_recall`` makes them: every held-out user
    with a training history, and that history as the exclusion rows."""
    from repro_torch.retrieval import pad_id_rows

    hist = {}
    for u, i in train:
        hist.setdefault(int(u), []).append(int(i))
    users = sorted({int(u) for u in ds.test_pairs[:, 0]} & hist.keys())
    return np.array(users), pad_id_rows([np.unique(hist[u]) for u in users])


def _interleaved(torch, fns: dict, reps: int) -> dict:
    """Host seconds per call of each fn, run in turns (a, b, b, a, ...),
    each ending in a host copy of its result; the median of each and of the
    per-turn ratios."""
    times = {n: [] for n in fns}
    names = list(fns)
    for r in range(reps):
        for n in (names if r % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[n]()
            times[n].append(time.perf_counter() - t0)

    def median(xs):
        return sorted(xs)[len(xs) // 2]

    a, b = names
    return {"s": {n: median(t) for n, t in times.items()},
            "ratio": median([x / y for x, y in zip(times[a], times[b])])}


def ivf_split(torch, index, q, ex, k: int, reps: int = 15) -> dict:
    """Where one IVF search's time goes (median of ``reps``): CUDA events
    around its device stages (the centroid probe; the ``ivf_list_topk``
    kernel; ids, exclusion and the exact re-rank), each the device
    timeline's span from one stage's first enqueued op to the next's, and
    the host clock around the whole search, uploads and the result copy
    included; ``host_ms`` is the wall less the three spans."""
    from repro_torch.kernels import ops
    from repro_torch.retrieval import ivf as tivf

    plan, dev = index.plan(k, len(q), ex.shape[1]), index._dev
    if plan["block"] < len(q):
        fail(f"ivf_split wants one search block; the plan splits {len(q)} queries")
    spans = {"probe_ms": [], "kernel_ms": [], "rerank_ms": [], "wall_ms": []}
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dq, dex = tivf.to_device(q, index.device), tivf.to_device(ex, index.device)
        ev[0].record()
        starts, lens = tivf._probe(dq, dev["centroids"], dev["offsets"], plan["nprobe"])
        ev[1].record()
        s, rows = ops.ivf_list_topk(dq, dev["codes"], dev["scales"], starts, lens,
                                    lpad=index.lpad, shortlist=plan["shortlist"])
        ev[2].record()
        s, ids = tivf._to_ids(s, rows, dex, dev["order"])
        bs, bi = tivf._rerank_exact_device(dq, s, ids, dev["items"], k=plan["k"])
        ev[3].record()
        bs.cpu(), bi.cpu()
        spans["wall_ms"].append((time.perf_counter() - t0) * 1e3)
        for name, a in (("probe_ms", 0), ("kernel_ms", 1), ("rerank_ms", 2)):
            spans[name].append(ev[a].elapsed_time(ev[a + 1]))
    out = {n: sorted(v)[len(v) // 2] for n, v in spans.items()}
    out["host_ms"] = out["wall_ms"] - out["probe_ms"] - out["kernel_ms"] - out["rerank_ms"]
    return out


def ivf_serving_path(torch, np, modules, mp) -> dict:
    """UB recall on an IVF index through ``recall_torch.run(--method ivf)``;
    IVF at full probing against brute force on the serving phase's
    embeddings; U2I search rates, IVF and exact, back to back."""
    import recall_torch
    from repro_torch.core.recall import _normalize, evaluate_recall
    from repro_torch.kernels import ops
    from repro_torch.retrieval import IVFConfig, IVFIndex, chunked_topk

    args = recall_torch.parser().parse_args(
        ["--dataset", "ub", "--model", "lightgcn", "--dim", "64", "--side-info",
         "--seed", "0", "--batch-size", "1024", "--method", "ivf"])
    calls = {"ivf serving": [], "ivf exhaustive": []}
    with recording(ops, "ivf_list_topk", calls["ivf serving"]):
        _zero(modules)
        res = recall_torch.run(args)
        torch.cuda.synchronize()
        launches = {n: m.launches for n, m in modules.items()}
    if launches["ivf_list_topk"] == 0:
        fail("the IVF serving path launched no ivf_list_topk kernel")
    ds, emb = res["dataset"], res["embeddings"]
    train = recall_torch.train_pairs(ds)
    cfg = res["ivf"]
    # the run's two indexes again (the build is deterministic), for their
    # sizes and the U2I search rates
    ue, ie = (_normalize(x) for x in (emb[: ds.num_users],
                                      emb[ds.num_users : ds.num_users + ds.num_items]))
    idx = {"item": IVFIndex.build(ie, cfg), "user": IVFIndex.build(ue, cfg)}
    users, seen = _u2i_queries(np, ds, train)
    rates = _interleaved(torch, {
        "ivf": lambda: idx["item"].search(ue[users], 100, exclude=seen),
        "exact": lambda: chunked_topk(ue[users], ie, 100, exclude=seen, device="cuda")}, 7)
    split = ivf_split(torch, idx["item"], ue[users], seen, 100)

    emb = mp["embeddings"]  # the serving phase's, which brute force scored
    ue, ie = emb[: ds.num_users], emb[ds.num_users : ds.num_users + ds.num_items]

    # full probing is exhaustive: equal to brute force on the same embeddings
    kw = dict(max_users=1000, seed=0, device="cuda")
    full_cfg = IVFConfig(nlist=cfg.nlist, nprobe=cfg.nlist, seed=cfg.seed)
    with recording(ops, "ivf_list_topk", calls["ivf exhaustive"]):
        modules["ivf_list_topk"].launches = 0
        t0 = time.perf_counter()
        full = evaluate_recall(ue, ie, train, ds.test_pairs, method="ivf", ivf=full_cfg, **kw)
        full_s = time.perf_counter() - t0
        full_launches = modules["ivf_list_topk"].launches
    bf = mp["bruteforce"]
    diff = {k: abs(full[k] - bf[k]) for k in bf}
    if full.keys() != bf.keys() or max(diff.values()) > RECALL_TOL:
        fail(f"IVF at nprobe == nlist vs brute-force recall differ: {diff}")
    part = evaluate_recall(ue, ie, train, ds.test_pairs, method="ivf", ivf=cfg, **kw)

    t0 = time.perf_counter()
    u2i = evaluate_recall(ue, ie, train, ds.test_pairs, strategies=("u2i",), method="ivf",
                          ivf=cfg, device="cuda")
    u2i_s = time.perf_counter() - t0
    out = {
        "phase": "ivf_serving", "dataset": "ub", "model": "lightgcn", "dim": 64,
        "nlist": cfg.nlist, "nprobe": cfg.nprobe, "recall_s": res["recall_s"],
        "recall": res["recall"], "launches": launches,
        "wrapper_calls": len(calls["ivf serving"]),
        "embeddings_vs_serving_max_diff": float(np.abs(res["embeddings"] - emb).max()),
        "item_index": {"lpad": idx["item"].lpad, "spilled_items": idx["item"].spilled_items},
        "user_index": {"lpad": idx["user"].lpad, "spilled_items": idx["user"].spilled_items},
        "u2i_queries": len(users), "u2i_s": u2i_s, "u2i_queries_per_s": len(users) / u2i_s,
        "u2i_recall": u2i["u2i"],
        "u2i_search_queries_per_s": {n: len(users) / t for n, t in rates["s"].items()},
        "u2i_search_ivf_over_exact_time": rates["ratio"], "u2i_search_split": split,
        "max_users_1000": {"ivf_nprobe_default": part, "ivf_nprobe_nlist": full,
                           "bruteforce": bf},
        "exhaustive": {"launches": full_launches, "recall_s": full_s,
                       "ivf_vs_bruteforce_max_diff": max(diff.values())},
    }
    emit(out)
    return dict(out, calls=calls)


def million_arm(torch, np, modules, I: int = 1_000_000, Q: int = 512) -> dict:
    """``benchmarks/bench_recall.py``'s 1M-item IVF arm on the card: 512
    clustered queries, k 100, 16 exclusions each; Recall@100 against the
    exact ``topk`` kernel, and the two searches' rates back to back."""
    from repro_torch.kernels import ops
    from repro_torch.retrieval import IVFConfig, IVFIndex, chunked_topk

    K = 100
    rng = np.random.default_rng(0)
    it, q = clustered_corpus(np, rng, I, Q)
    ex = rng.integers(0, I, size=(Q, 16)).astype(np.int32)
    cfg = IVFConfig(nlist=2048, nprobe=12, kmeans_iters=4, train_size=131_072,
                    balance_factor=1.25, seed=0)
    t0 = time.perf_counter()
    index = IVFIndex.build(it, cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    calls = []
    with recording(ops, "ivf_list_topk", calls):
        modules["ivf_list_topk"].launches = 0
        _, ivf_ids = index.search(q, K, exclude=ex)
        launches = modules["ivf_list_topk"].launches
    if launches == 0:
        fail("the 1M-item arm launched no ivf_list_topk kernel")
    topk_calls = []
    with recording(ops, "streaming_topk", topk_calls):
        modules["topk"].launches = 0
        _, exact_ids = chunked_topk(q, it, K, exclude=ex, device="cuda")
        topk_launches = modules["topk"].launches
    recall = float(np.mean([len(set(a.tolist()) & set(b.tolist())) / K
                            for a, b in zip(exact_ids, ivf_ids)]))
    rates = _interleaved(torch, {
        "ivf": lambda: index.search(q, K, exclude=ex),
        "exact": lambda: chunked_topk(q, it, K, exclude=ex, device="cuda")}, 11)
    split = ivf_split(torch, index, q, ex, K)
    out = {"phase": "ivf_1m", "items": I, "queries": Q, "k": K, "exclude": 16,
           "config": dataclasses.asdict(index.config), "build_s": build_s,
           "lpad": index.lpad, "spilled_items": index.spilled_items,
           "shortlist": index.plan(K, Q, 16)["shortlist"],
           "recall_at_100": recall, "launches": launches,
           "queries_per_s": {n: Q / t for n, t in rates["s"].items()},
           "exact_over_ivf_time": 1.0 / rates["ratio"], "search_split": split}
    emit(out)
    return dict(out, calls=calls, topk_calls=topk_calls, topk_launches=topk_launches)


def _composed_topk(torch, ref, q, codes, scales, starts, lens, lpad: int, S: int,
                   batch: int):
    """The plain version with ``torch.topk`` in place of its stable
    total-order sort (no tie rule): a yardstick, used nowhere."""
    out_s, out_r = [], []
    for lo in range(0, q.shape[0], batch):
        s, r = ref.ivf_list_scores(q[lo : lo + batch], codes, scales,
                                   starts[lo : lo + batch], lens[lo : lo + batch], lpad)
        best, pos = torch.topk(s, S, dim=1)
        out_s.append(best)
        out_r.append(r.gather(1, pos))
    return torch.cat(out_s), torch.cat(out_r)


def _plain_batch(q, starts, lpad: int) -> int:
    """Queries per block of the plain version here: ~1 GiB of gathered f32
    codes' worth of slots (a quarter of it as int8), not 32 queries. The
    results are the same (its sums are elementwise), with a few thousand
    launches a call, not tens of thousands: a profile of that many saw no
    device time at all."""
    return max(32, (1 << 30) // (starts.shape[1] * lpad * q.shape[1] * 4))


def _ivf_args(torch, call):
    (q, codes, scales, starts, lens), kw = call
    return (q, codes, scales, starts.to(torch.int32).contiguous(),
            lens.to(torch.int32).contiguous(), kw["lpad"], kw["shortlist"])


def _ivf_record(torch, ref, ivf_list_topk_cuda, call, source: str) -> dict:
    q, codes, scales, starts, lens, lpad, S = _ivf_args(torch, call)
    (Q, d), P = q.shape, starts.shape[1]
    big = Q * P * lpad > 50_000_000
    pb = _plain_batch(q, starts, lpad)
    kern = measure(lambda: ivf_list_topk_cuda(q, codes, scales, starts, lens, lpad, S),
                   5 if big else 50)
    plain = measure(lambda: ref.ivf_list_topk_ref(q, codes, scales, starts, lens, lpad=lpad,
                                                  shortlist=S, batch_size=pb),
                    1 if big else 3, warmup=1)
    comp = measure(lambda: _composed_topk(torch, ref, q, codes, scales, starts, lens, lpad,
                                          S, pb), 1 if big else 3, warmup=1)
    n = lens.clamp(0, lpad).to(torch.int64).flatten()
    scored = int(n.sum().item())  # (query, row) pairs scored
    # distinct rows the lists cover: +1 at each start, -1 past each end
    st = starts.to(torch.int64).flatten()
    cover = torch.zeros(codes.shape[0] + 1, dtype=torch.int64, device=q.device)
    cover.index_add_(0, st, torch.ones_like(st)).index_add_(0, st + n, -torch.ones_like(st))
    distinct = int((cover.cumsum(0) > 0).sum().item())
    rec = {"phase": "kernel", "name": "ivf_list_topk", "source": source,
           "shape": {"Q": Q, "d": d, "P": P, "lpad": lpad, "S": S, "rows_scored": scored,
                     "distinct_rows": distinct},
           "plain_batch": pb,
           # no single PyTorch call computes the masked CSR gather-score-select
           **times(kernel=kern, plain=plain, library=None, composed_topk=comp)}
    # each input read once (the codes and scale of every row some list
    # covers, queries, starts, lengths), both (Q, S) outputs written once,
    # and 2d FLOP for each (query, row) pair scored
    io = Q * d * 4 + Q * P * 8 + Q * S * 8
    rec["bound_ms"], rec["bound_by"] = bound_ms(distinct * (d + 4) + io, 2.0 * scored * d)
    # the same with every (query, row) pair's codes read from memory, as
    # if no query shared a row with another through the cache
    rec["read_bound_ms"] = bound_ms(scored * (d + 4) + io, 2.0 * scored * d)[0]
    emit(rec)
    return rec


def ivf_phase(torch, ref, ivf_list_topk_cuda, paths: dict) -> dict:
    """Every recorded call of each IVF path against the plain version (rows
    exactly, scores to rtol 2e-5 / atol 1e-4); the UB calls, the first
    exhaustive call and the 1M call timed on their recorded inputs."""
    worst, recs = 0.0, {}
    for path, calls in paths.items():
        path_worst = 0.0
        for c in calls:
            q, codes, scales, starts, lens, lpad, S = _ivf_args(torch, c)
            s, r = ivf_list_topk_cuda(q, codes, scales, starts, lens, lpad, S)
            s0, r0 = ref.ivf_list_topk_ref(q, codes, scales, starts, lens, lpad=lpad,
                                           shortlist=S, batch_size=_plain_batch(q, starts, lpad))
            torch.cuda.synchronize()
            if not torch.equal(r, r0):
                fail(f"ivf_list_topk Q={q.shape[0]} S={S}: a {path} call's rows differ from "
                     f"its plain version at {int((r != r0).sum().item())} slots")
            if not torch.allclose(s, s0, rtol=IVF_RTOL, atol=IVF_ATOL):
                fail(f"ivf_list_topk Q={q.shape[0]} S={S}: a {path} call's scores differ "
                     "from its plain version")
            fin = torch.isfinite(s0)
            path_worst = max(path_worst, (s[fin] - s0[fin]).abs().max().item()
                             if fin.any() else 0.0)
        emit({"phase": "kernel", "name": "ivf_list_topk", "source": f"{path}, every call",
              "calls": len(calls), "max_abs_err": path_worst,
              "max_shortlist": max(c[1]["shortlist"] for c in calls)})
        worst = max(worst, path_worst)
        timed = calls if path == "ivf serving" else calls[:1]
        recs[path] = [_ivf_record(torch, ref, ivf_list_topk_cuda, c, path) for c in timed]
    return dict(recs["1M arm"][0], max_abs_err=worst)


# ------------------------------------------------------------- training
class TrainRecorder:
    """Spies on the four kernel entry points of the training step.

    Every call is counted; each ``seg_aggr`` forward output is checked for a
    ``grad_fn`` (the gradient fault: the card's forward once returned none);
    the first ``KEEP_CALLS`` calls of each kernel and shape keep their
    inputs. ``row_adagrad`` updates in place, so a kept call clones the table
    and accumulators before the call and again after it. Nothing here syncs:
    the step runs under ``set_sync_debug_mode("error")``.
    """

    def __init__(self):
        self.calls = collections.Counter()
        self.kept = collections.defaultdict(list)
        self._per_shape = collections.Counter()
        self.no_grad_fn = 0

    def _keep(self, name: str, key) -> bool:
        self._per_shape[(name, key)] += 1
        return self._per_shape[(name, key)] <= KEEP_CALLS

    @contextlib.contextmanager
    def spying(self, ops):
        real = {n: getattr(ops, n) for n in
                ("seg_aggr", "seg_aggr_bwd", "inbatch_loss_rows", "rowwise_adagrad_scatter")}

        def seg_aggr(x, mask, mode="mean"):
            out = real["seg_aggr"](x, mask, mode)
            self.calls["seg_aggr"] += 1
            self.no_grad_fn += out.grad_fn is None
            if self._keep("seg_aggr", (tuple(x.shape), mode)):
                self.kept["seg_aggr"].append(((x.detach(), mask, mode), {}))
            return out

        def seg_aggr_bwd(g, mask, mode="mean"):
            self.calls["seg_aggr_bwd"] += 1
            if self._keep("seg_aggr_bwd", (tuple(mask.shape), mode)):
                self.kept["seg_aggr_bwd"].append((g.clone(), mask, mode))
            return real["seg_aggr_bwd"](g, mask, mode)

        def inbatch_loss_rows(h_src, h_dst, temperature=1.0):
            self.calls["inbatch_loss"] += 1
            if self._keep("inbatch_loss", tuple(h_src.shape)):
                self.kept["inbatch_loss"].append(
                    (h_src.detach().clone(), h_dst.detach().clone(), temperature))
            return real["inbatch_loss_rows"](h_src, h_dst, temperature)

        def rowwise_adagrad_scatter(table, accum, ids, grads, lr=0.1, eps=1e-8):
            self.calls["row_adagrad"] += 1
            keep = self._keep("row_adagrad", (tuple(table.shape), ids.shape[0]))
            pre = (table.clone(), accum.clone()) if keep else None
            out = real["rowwise_adagrad_scatter"](table, accum, ids, grads, lr=lr, eps=eps)
            if keep:
                self.kept["row_adagrad"].append(dict(
                    t0=pre[0], a0=pre[1], ids=ids.clone(), g=grads.detach().clone(),
                    t1=table.clone(), a1=accum.clone(), lr=lr, eps=eps))
            return out

        spies = {"seg_aggr": seg_aggr, "seg_aggr_bwd": seg_aggr_bwd,
                 "inbatch_loss_rows": inbatch_loss_rows,
                 "rowwise_adagrad_scatter": rowwise_adagrad_scatter}
        for n, f in spies.items():
            setattr(ops, n, f)
        try:
            yield self
        finally:
            for n, f in real.items():
                setattr(ops, n, f)


@contextlib.contextmanager
def step_events(torch, cls, name: str, events: list):
    """Around every call of ``cls.name`` (no sync): a CUDA event pair and the
    host clock on entry and exit. The gap from one exit to the next entry is
    the trainer's loop outside the step: the wait for the next batch, its
    H2D staging, the loss readback."""
    real = getattr(cls, name)

    def timed(self, *args, **kwargs):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t_in = time.perf_counter()
        start.record()
        out = real(self, *args, **kwargs)
        stop.record()
        events.append((start, stop, t_in, time.perf_counter()))
        return out

    setattr(cls, name, timed)
    try:
        yield
    finally:
        setattr(cls, name, real)


def _losses_fell(np, r, steps: int, what: str):
    """First-20 and last-20 loss means of a run, which must be finite and fall."""
    losses = np.asarray(r.losses)
    if len(losses) != steps or not np.isfinite(losses).all():
        fail(f"{what}: {len(losses)} losses, finite {np.isfinite(losses).all()}")
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    if not last < first:
        fail(f"{what} loss did not fall: first-20 mean {first}, last-20 mean {last}")
    return first, last


def _step_split(events: list) -> dict:
    """Each step's dispatch (CUDA events, host clock) and the host time from
    one step's exit to the next one's entry."""
    def median(xs):
        return sorted(xs)[len(xs) // 2]

    dispatch_ms = sorted(a.elapsed_time(b) for a, b, _, _ in events)
    between_ms = [(nxt[2] - cur[3]) * 1e3 for cur, nxt in zip(events, events[1:])]
    return {"dispatch_ms_median": median(dispatch_ms), "dispatch_ms_min": dispatch_ms[0],
            "dispatch_ms_max": dispatch_ms[-1],
            "dispatch_host_ms_median": median([(t1 - t0) * 1e3 for _, _, t0, t1 in events]),
            "between_steps_host_ms_median": median(between_ms),
            "between_steps_host_ms_mean": sum(between_ms) / len(between_ms)}


def _trained_u2i(res) -> dict:
    """U2I recall of a run's trained embeddings (the serving phase measured
    the random-weight model on the same held-out pairs)."""
    import recall_torch
    from repro_torch.core.model import Graph4RecModel
    from repro_torch.core.recall import evaluate_recall
    from repro_torch.infer import embed_all_nodes

    ds, r = res["dataset"], res["result"]
    t0 = time.perf_counter()
    emb = embed_all_nodes(Graph4RecModel(res["config"], r.params), res["trainer"].engine,
                          ds.graph, batch_size=1024, seed=0, device="cuda")
    ue, ie = emb[: ds.num_users], emb[ds.num_users : ds.num_users + ds.num_items]
    u2i = evaluate_recall(ue, ie, recall_torch.train_pairs(ds), ds.test_pairs,
                          strategies=("u2i",), device="cuda")
    return {"eval_s": time.perf_counter() - t0, "u2i_trained": u2i["u2i"],
            "u2i_ndcg_trained": u2i["u2i_ndcg"]}


def _train_profile(torch, train_torch, args, phase: str, **overrides) -> dict:
    """Where the step time goes: a separate 40-step run under torch.profiler
    (not the timed run, whose times the profiler would disturb)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pres = train_torch.run(args, eval_at_end=False, **overrides)["result"]
        torch.cuda.synchronize()
    steps = len(pres.losses)
    kern = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    rec = {"phase": phase, "steps": steps, "wall_s": pres.wall_time_s,
           "device_busy_ms_per_step": busy_us / 1e3 / steps,
           "device_busy_share": busy_us / 1e6 / pres.wall_time_s,
           "top_device_ms_per_step": {e.key[:80]: e.self_device_time_total / 1e3 / steps
                                      for e in top}}
    emit(rec)
    return rec


def training_path(torch, np, modules, serving_u2i: float) -> dict:
    import train_torch
    from repro_torch.kernels import ops
    from repro_torch.train.trainer import Graph4RecTrainer

    def args(seed: int, steps: int, *extra: str):
        return train_torch.parser().parse_args(
            ["--dataset", "ub", "--model", "lightgcn", "--dim", "64", "--side-info",
             "--batch-pairs", "512", "--steps", str(steps), "--seed", str(seed),
             "--prefetch-batches", "2", *extra])

    ckpt = os.path.join(ROOT, "build", "chip_smoke", "ub_lightgcn64_trained.npz")
    rec, events = TrainRecorder(), []
    names = ("seg_aggr", "seg_aggr_bwd", "inbatch_loss", "row_adagrad")
    with rec.spying(ops), step_events(torch, Graph4RecTrainer, "_sparse_step", events):
        modules["seg_aggr"].launches = modules["seg_aggr"].bwd_launches = 0
        modules["inbatch_loss"].launches = modules["row_adagrad"].launches = 0
        res = train_torch.run(args(0, 200, "--save", ckpt), sparse_min_rows=0,
                              eval_at_end=False)
        torch.cuda.synchronize()
        launches = {"seg_aggr": modules["seg_aggr"].launches,
                    "seg_aggr_bwd": modules["seg_aggr"].bwd_launches,
                    "inbatch_loss": modules["inbatch_loss"].launches,
                    "row_adagrad": modules["row_adagrad"].launches}
    r = res["result"]
    first, last = _losses_fell(np, r, 200, "training")
    for n in names:
        if launches[n] == 0:
            fail(f"the training path launched no {n} kernel")
    if rec.no_grad_fn:
        fail(f"{rec.no_grad_fn} of {rec.calls['seg_aggr']} seg_aggr forward outputs on the "
             "training path carry no grad_fn: the neighbour gradient is dropped")
    split = _step_split(events)
    recall = _trained_u2i(res)
    _train_profile(torch, train_torch, args(1, 40), "training_profile", sparse_min_rows=0)

    out = {
        "phase": "training", "dataset": "ub", "model": "lightgcn", "dim": 64,
        "steps": len(r.losses), "batch_pairs": 512, "update": "sparse",
        "plan": r.plan["reason"], "train_s": r.wall_time_s, "pairs": r.pairs_seen,
        "pairs_per_s": r.pairs_seen / r.wall_time_s,
        "step_wall_ms": r.wall_time_s / len(r.losses) * 1e3, **split,
        "loss_first20_mean": first, "loss_last20_mean": last,
        "launches": launches, "wrapper_calls": dict(rec.calls),
        "seg_aggr_outputs_without_grad_fn": rec.no_grad_fn, "checkpoint":
        os.path.relpath(res["saved"], ROOT), **recall, "u2i_random_weights": serving_u2i,
    }
    emit(out)
    return dict(out, kept=rec.kept)


def fused_training_path(torch, np, modules, serving_u2i: float) -> dict:
    """The training path with the fused device sampler (phase 5)."""
    import train_torch
    from repro_torch.kernels import ops
    from repro_torch.train.trainer import Graph4RecTrainer

    def args(seed: int, steps: int, backend: str = "fused"):
        flags = ["--dataset", "ub", "--model", "lightgcn", "--dim", "64", "--side-info",
                 "--batch-pairs", "512", "--seed", str(seed), "--steps", str(steps),
                 "--sampling-backend", backend]
        # no prefetcher on the fused path; "auto" leaves it to the calibration
        return train_torch.parser().parse_args(
            flags + (["--prefetch-batches", "0"] if backend == "fused" else []))

    rec, events, wp_calls = TrainRecorder(), [], []
    with rec.spying(ops), recording(ops, "window_pair_ids", wp_calls), \
            step_events(torch, Graph4RecTrainer, "_fused_step", events):
        _zero(modules)
        res = train_torch.run(args(0, 200), eval_at_end=False)
        torch.cuda.synchronize()
        launches = {"seg_aggr": modules["seg_aggr"].launches,
                    "seg_aggr_bwd": modules["seg_aggr"].bwd_launches,
                    "inbatch_loss": modules["inbatch_loss"].launches,
                    "row_adagrad": modules["row_adagrad"].launches,
                    "window_pairs": modules["window_pairs"].launches,
                    "topk": modules["topk"].launches}
    r, sampler = res["result"], res["trainer"]._fused_sampler
    if r.plan["sampling"] != "fused":
        fail(f"fused training planned {r.plan['sampling']!r}: {r.plan['reason']}")
    first, last = _losses_fell(np, r, 200, "fused training")
    if launches["window_pairs"] != 200 or len(wp_calls) != 200:
        fail(f"fused training launched window_pairs {launches['window_pairs']} times over "
             f"{len(wp_calls)} calls; want one a step, 200")
    for n in ("seg_aggr", "seg_aggr_bwd", "inbatch_loss"):
        if launches[n] == 0:
            fail(f"the fused training path launched no {n} kernel")
    if rec.no_grad_fn:
        fail(f"{rec.no_grad_fn} seg_aggr forward outputs on the fused path carry no grad_fn")
    split = _step_split(events)
    recall = _trained_u2i(res)
    if not recall["u2i_trained"] > serving_u2i:
        fail(f"fused training: trained U2I {recall['u2i_trained']} not above the "
             f"random-weight {serving_u2i}")
    prof = _train_profile(torch, train_torch, args(1, 40), "fused_training_profile")

    out = {
        "phase": "fused_training", "dataset": "ub", "model": "lightgcn", "dim": 64,
        "steps": len(r.losses), "batch_pairs": 512, "update": "dense", "sampling": "fused",
        "plan": r.plan["reason"], "walks_per_step": sampler.num_walks,
        "device_table_bytes": sampler.device_table_bytes(),
        "train_s": r.wall_time_s, "pairs": r.pairs_seen,
        "pairs_per_s": r.pairs_seen / r.wall_time_s,
        "step_wall_ms": r.wall_time_s / len(r.losses) * 1e3, **split,
        "device_busy_share": prof["device_busy_share"],
        "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
        "loss_first20_mean": first, "loss_last20_mean": last,
        "launches": launches, "wrapper_calls": dict(rec.calls, window_pairs=len(wp_calls)),
        **recall, "u2i_random_weights": serving_u2i,
    }
    emit(out)

    # sampling_backend="auto": calibration picks host or fused (either is
    # accepted); its plan and measurements are the result
    ares = train_torch.run(args(0, 40, "auto"), eval_at_end=False)["result"]
    auto = {"phase": "auto_sampling", "steps": len(ares.losses),
            "sampling": ares.plan["sampling"], "prefetch": ares.plan["prefetch"],
            "reason": ares.plan["reason"], "measurements": ares.plan.get("measurements"),
            "fused_measured_bytes": ares.plan.get("fused_measured_bytes"),
            "pairs_per_s": ares.pairs_seen / ares.wall_time_s}
    if not ares.plan["calibrated"] or "fused_step_s" not in auto["measurements"]:
        fail(f"auto sampling did not time the fused step: {ares.plan}")
    emit(auto)
    return dict(out, kept=rec.kept, window_pairs_calls=wp_calls, auto=auto)


def fused_conformance(torch, np) -> dict:
    """The fused step on TOY, card vs CPU on the same CPU-drawn draws for 12
    steps, and two same-seed fused card runs (under deterministic
    algorithms, which the caller turns on)."""
    import train_torch
    from repro_torch.graph import SPECS, generate
    from repro_torch.train import Graph4RecTrainer, TrainerConfig

    args = train_torch.parser().parse_args(
        ["--dataset", "toy", "--model", "lightgcn", "--dim", "64", "--side-info",
         "--batch-pairs", "256", "--seed", "3", "--sampling-backend", "fused"])
    ds = generate(SPECS["toy"], seed=3)
    mcfg, pcfg = train_torch.configs(ds, args)
    tcfg = TrainerConfig(num_steps=12, sparse_lr=1.0, log_every=0, seed=3, prefetch_batches=0,
                         sampling_backend="fused", eval_at_end=False)
    cpu, card = (Graph4RecTrainer(ds, ds.graph, mcfg, pcfg, tcfg, device=d)
                 for d in ("cpu", "cuda"))
    if cpu._fused_sampler is None or card._fused_sampler is None:
        fail("fused conformance: the TOY sampler failed its memory gate")
    p_cpu = cpu.init_params()
    p_card = card.init_params({k: v.numpy() for k, v in p_cpu.items()})
    s_cpu, s_card = cpu.opt.init(p_cpu), card.opt.init(p_card)
    gen = torch.Generator().manual_seed(3)
    losses_cpu, losses_card = [], []
    for _ in range(12):
        draws = cpu._fused_sampler.draw(gen)
        draws_card = draws.to("cuda")
        p_cpu, s_cpu, l_cpu = cpu._fused_step(p_cpu, s_cpu, draws)
        torch.cuda.set_sync_debug_mode("error")
        try:
            p_card, s_card, l_card = card._fused_step(p_card, s_card, draws_card)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        losses_cpu.append(l_cpu.item())
        losses_card.append(l_card.item())
    loss_diff = float(np.max(np.abs(np.subtract(losses_card, losses_cpu))))
    if not np.allclose(losses_card, losses_cpu, rtol=TRAJ_RTOL, atol=TRAJ_ATOL):
        fail(f"fused conformance: card vs CPU losses differ by {loss_diff}")
    table_diff = 0.0
    for k, v in p_card.items():
        d = (v.cpu() - p_cpu[k]).abs().max().item()
        table_diff = max(table_diff, d)
        if d > TRAJ_ATOL:
            fail(f"fused conformance: {k} card vs CPU differs by {d}")
    runs = [Graph4RecTrainer(ds, ds.graph, mcfg, pcfg, tcfg, device="cuda").train()
            for _ in range(2)]
    if runs[0].plan["sampling"] != "fused" or runs[0].losses != runs[1].losses or any(
            not torch.equal(v, runs[1].params[k]) for k, v in runs[0].params.items()):
        fail("fused conformance: two same-seed fused card runs differ")
    return {"loss_max_abs_diff": loss_diff, "param_max_abs_diff": table_diff,
            "card_runs_identical": True, "losses_card": losses_card}


def conformance_phase(torch, np) -> dict:
    """TOY, 12 steps, card vs CPU from the same initial weights, and twice
    on the card, under deterministic algorithms."""
    import train_torch

    args = train_torch.parser().parse_args(
        ["--dataset", "toy", "--model", "lightgcn", "--dim", "64", "--side-info",
         "--batch-pairs", "256", "--steps", "12", "--seed", "3", "--prefetch-batches", "0"])
    out = {"phase": "conformance", "dataset": "toy", "steps": 12}
    torch.use_deterministic_algorithms(True)
    try:
        for update, smr in (("sparse", 0), ("dense", 1 << 30)):
            runs = [train_torch.run(args, device=dev, sparse_min_rows=smr,
                                    eval_at_end=False)["result"]
                    for dev in ("cpu", "cuda", "cuda")]
            cpu, card, again = runs
            loss_diff = float(np.max(np.abs(np.subtract(card.losses, cpu.losses))))
            if not np.allclose(card.losses, cpu.losses, rtol=TRAJ_RTOL, atol=TRAJ_ATOL):
                fail(f"conformance ({update}): card vs CPU losses differ by {loss_diff}")
            table_diff = 0.0
            for k, v in card.params.items():
                d = (v.cpu() - cpu.params[k]).abs().max().item()
                table_diff = max(table_diff, d)
                if d > TRAJ_ATOL:
                    fail(f"conformance ({update}): {k} card vs CPU differs by {d}")
            if card.losses != again.losses or any(
                    not torch.equal(v, again.params[k]) for k, v in card.params.items()):
                fail(f"conformance ({update}): two same-seed card runs differ")
            out[update] = {"loss_max_abs_diff": loss_diff, "param_max_abs_diff": table_diff,
                           "card_runs_identical": True, "losses_card": card.losses}
        out["fused"] = fused_conformance(torch, np)
    finally:
        torch.use_deterministic_algorithms(False)
    emit(out)
    return out


# ------------------------------------------------------ training kernels
def seg_aggr_bwd_phase(torch, ref, seg_aggr_bwd_cuda, kept: list) -> dict:
    worst, recs = 0.0, []
    for g, mask, mode in kept:
        got, want = seg_aggr_bwd_cuda(g, mask, mode), ref.seg_aggr_bwd_ref(g, mask, mode)
        torch.cuda.synchronize()
        if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
            fail(f"seg_aggr_bwd {mode} {tuple(mask.shape)}: a training call disagrees with "
                 "its plain version")
        worst = max(worst, (got - want).abs().max().item())
    for g, mask, mode in first_of_each_shape(kept, lambda c: (tuple(c[1].shape), c[2])):
        (n, f), d = mask.shape, g.shape[1]
        mf = mask.float()
        w = mf / mf.sum(1, keepdim=True).clamp(min=1.0) if mode == "mean" else mf
        kern = measure(lambda: seg_aggr_bwd_cuda(g, mask, mode), 200)
        plain = measure(lambda: ref.seg_aggr_bwd_ref(g, mask, mode), 200)
        # one broadcast product against precomputed per-neighbour weights
        lib = measure(lambda: g[:, None, :] * w[..., None], 200)
        rec = {"phase": "kernel", "name": "seg_aggr_bwd", "source": "training path",
               "mode": mode, "shape": [n, f, d], **times(kernel=kern, plain=plain, library=lib)}
        rec["bound_ms"], rec["bound_by"] = bound_ms(n * d * 4 + n * f + n * f * d * 4, n * f * d)
        emit(rec)
        recs.append(rec)
    emit({"phase": "kernel", "name": "seg_aggr_bwd", "source": "training path, kept calls",
          "calls": len(kept), "max_abs_err": worst})
    return dict(max(recs, key=lambda r: r["shape"][0] * r["shape"][1]), max_abs_err=worst)


def _inbatch_record(torch, ref, inbatch_mod, s, d, t, source: str) -> dict:
    import torch.nn.functional as F

    fn = inbatch_mod.inbatch_loss_rows_cuda
    P, dim = s.shape
    got, want = fn(s, d, t), ref.inbatch_loss_rows_ref(s, d, t)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if err > RTOL * max(1.0, want.abs().max().item()):
        fail(f"inbatch_loss {(P, dim)} ({source}) disagrees with its plain version by {err}")
    if not torch.equal(got, fn(s, d, t)):
        fail(f"inbatch_loss {(P, dim)} ({source}): two runs differ")
    labels = torch.arange(P, device=s.device)
    iters = 200 if P <= 2048 else 20
    kern = measure(lambda: fn(s, d, t), iters)
    plain = measure(lambda: ref.inbatch_loss_rows_ref(s, d, t), iters)
    lib = measure(lambda: F.cross_entropy(s @ d.T / t, labels, reduction="none"), iters)
    splits, split_cols = inbatch_mod.plan_columns(P)
    rec = {"phase": "kernel", "name": "inbatch_loss", "source": source, "shape": [P, dim],
           "plan": {"row_tile": inbatch_mod.ROW_TILE, "splits": splits, "cluster": splits,
                    "split_cols": split_cols, "blocks": -(-P // inbatch_mod.ROW_TILE) * splits},
           "max_abs_err": err, "bitwise_rerun": True,
           **times(kernel=kern, plain=plain, library=lib)}
    rec["bound_ms"], rec["bound_by"] = bound_ms(2 * P * dim * 4 + P * 4, 2.0 * P * P * dim)
    emit(rec)
    return rec


def inbatch_phase(torch, ref, inbatch_mod, kept: list) -> dict:
    """Every kept training call against the plain version (1e-5); the first
    timed, bitwise on a re-run; then synthetic P 2,048 and 8,192 at d 64 and
    8,192 at d 256 (``repro``'s Pallas docstring's size)."""
    worst = 0.0
    for s, d, t in kept:
        got, want = inbatch_mod.inbatch_loss_rows_cuda(s, d, t), ref.inbatch_loss_rows_ref(s, d, t)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if err > RTOL * max(1.0, want.abs().max().item()):
            fail(f"inbatch_loss {tuple(s.shape)}: a training call disagrees with its plain "
                 f"version by {err}")
        worst = max(worst, err)
    s, d, t = kept[0]
    rec = _inbatch_record(torch, ref, inbatch_mod, s, d, t, "training path")
    rec["calls"] = len(kept)
    gen = torch.Generator(device="cuda").manual_seed(2)
    for P, dim in ((2048, 64), (8192, 64), (8192, 256)):
        s = 0.5 * torch.randn(P, dim, device="cuda", generator=gen)
        d = 0.5 * torch.randn(P, dim, device="cuda", generator=gen)
        _inbatch_record(torch, ref, inbatch_mod, s, d, t, "synthetic")
    return dict(rec, max_abs_err=max(worst, rec["max_abs_err"]))


def row_adagrad_phase(torch, ref, row_adagrad_scatter_cuda, kept: list) -> dict:
    """Each kept call: the main path's own result vs the plain version on the
    cloned inputs, untouched rows exactly unchanged, and the kernel re-run."""
    worst, recs = 0.0, []
    for c in kept:
        t0, a0, ids, g = c["t0"], c["a0"], c["ids"], c["g"]
        tp, ap = t0.clone(), a0.clone()
        ref.row_adagrad_scatter_ref(tp, ap, ids, g, c["lr"], c["eps"])
        tk, ak = t0.clone(), a0.clone()
        row_adagrad_scatter_cuda(tk, ak, ids, g, c["lr"], c["eps"])
        torch.cuda.synchronize()
        touched = torch.zeros(t0.shape[0], dtype=torch.bool, device=t0.device)
        touched[ids[ids >= 0]] = True
        for what, t, a in (("main path", c["t1"], c["a1"]), ("re-run", tk, ak)):
            err = max((t - tp).abs().max().item(), (a - ap).abs().max().item())
            if not (torch.allclose(t, tp, rtol=RTOL, atol=ATOL)
                    and torch.allclose(a, ap, rtol=RTOL, atol=ATOL)):
                fail(f"row_adagrad {tuple(t0.shape)} ({what}) disagrees with its plain "
                     f"version by {err}")
            if not (torch.equal(t[~touched], t0[~touched])
                    and torch.equal(a[~touched], a0[~touched])):
                fail(f"row_adagrad {tuple(t0.shape)} ({what}) changed rows no id names")
            worst = max(worst, err)
    for c in first_of_each_shape(kept, lambda c: tuple(c["t0"].shape)):
        t0, a0, ids, g, lr, eps = c["t0"], c["a0"], c["ids"], c["g"], c["lr"], c["eps"]
        keep = torch.nonzero(ids >= 0).squeeze(1)
        rows, g_real = ids[keep], g[keep]
        n_real, (n, dim) = rows.shape[0], t0.shape
        tk, ak, tp, ap, tl, al = (x.clone() for x in (t0, a0, t0, a0, t0, a0))

        def library():  # index_select -> the row-wise step -> index_copy_
            acc = al.index_select(0, rows) + (g_real * g_real).mean(-1, keepdim=True)
            new = tl.index_select(0, rows) - lr * g_real / (torch.sqrt(acc) + eps)
            tl.index_copy_(0, rows, new)
            al.index_copy_(0, rows, acc)

        kern = measure(lambda: row_adagrad_scatter_cuda(tk, ak, ids, g, lr, eps), 200)
        plain = measure(lambda: ref.row_adagrad_scatter_ref(tp, ap, ids, g, lr, eps), 50)
        lib = measure(library, 200)
        rec = {"phase": "kernel", "name": "row_adagrad", "source": "training path",
               "shape": {"N": n, "D": dim, "bucket": ids.shape[0], "real_ids": n_real},
               **times(kernel=kern, plain=plain, library=lib)}
        # this run's data: the ids and grads read once, and each real row's
        # table row and accumulator read and written
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            ids.shape[0] * 8 + ids.shape[0] * dim * 4 + n_real * (2 * dim * 4 + 2 * 4),
            n_real * dim * 6)
        emit(rec)
        recs.append(rec)
    emit({"phase": "kernel", "name": "row_adagrad", "source": "training path, kept calls",
          "calls": len(kept), "max_abs_err": worst})
    return dict(max(recs, key=lambda r: r["shape"]["N"]), max_abs_err=worst)


def _wp_record(torch, ref, window_pair_ids_cuda, paths, pos, source: str, iters: int) -> dict:
    B, L = paths.shape
    npos = pos.shape[0]
    got, want = window_pair_ids_cuda(paths, pos), ref.window_pair_ids_ref(paths, pos)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        fail(f"window_pairs {(B, L, npos)} ({source}) is not equal to its plain version")
    kern = measure(lambda: window_pair_ids_cuda(paths, pos), iters)
    plain = measure(lambda: ref.window_pair_ids_ref(paths, pos), iters)
    rec = {"phase": "kernel", "name": "window_pairs", "source": source,
           "shape": {"B": B, "L": L, "npos": npos}, "max_abs_err": 0,
           # no single PyTorch call computes the jointly PAD-masked gather
           **times(kernel=kern, plain=plain, library=None)}
    # each path read once, both id outputs written once
    rec["bound_ms"], rec["bound_by"] = bound_ms(B * L * 4 + 2 * B * npos * 4, 0)
    emit(rec)
    return rec


def window_pairs_phase(torch, ref, window_pair_ids_cuda, calls: list) -> dict:
    """Every main-path call against the plain version, exactly (int ids);
    its shape timed on the first call's inputs; then edge shapes: B not a
    multiple of the block, all-PAD rows, L = 32 with a window of 5, and
    B = 65,536 for a time that is not launch-sized."""
    from repro_torch.sampling.pairs import window_positions

    for (paths, pos), _ in calls:
        p32 = paths.to(torch.int32).contiguous()
        got, want = window_pair_ids_cuda(p32, pos), ref.window_pair_ids_ref(paths, pos)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            fail(f"window_pairs {tuple(paths.shape)}: a fused training call is not equal to "
                 "its plain version")
    emit({"phase": "kernel", "name": "window_pairs", "source": "fused training path, every call",
          "calls": len(calls), "max_abs_err": 0})
    (paths, pos), _ = calls[0]
    main = _wp_record(torch, ref, window_pair_ids_cuda, paths.to(torch.int32).contiguous(), pos,
                      "fused training path", 200)

    gen = torch.Generator(device="cuda").manual_seed(2)
    for B, L, win, all_pad in ((1000, 6, 2, False), (1000, 6, 2, True), (4096, 32, 5, False),
                               (65536, 6, 2, False)):
        paths = torch.randint(0, 1 << 20, (B, L), device="cuda", generator=gen,
                              dtype=torch.int32)
        cut = torch.randint(0, L + 1, (B, 1), device="cuda", generator=gen)
        paths[torch.arange(L, device="cuda")[None, :] >= cut] = -1  # PAD suffixes
        if all_pad:
            paths[::3] = -1
        pos = torch.from_numpy(window_positions(L, win).astype("int32")).to("cuda")
        _wp_record(torch, ref, window_pair_ids_cuda, paths, pos,
                   f"synthetic{', all-PAD rows' if all_pad else ''}", 200)
    return main


# --------------------------------------------------------------- LM serving
LM_ARCH, LM_BATCH, LM_SEQ = "smollm-135m", 4, 2048  # the prefill: full width, B x S
# prefill vs decode, max |a - b| / max |b| (repro's measure, tests/test_models.py:124-128):
# in f32 the two paths compute one function in other orders (held as card vs CPU is); in
# bf16 to tests/test_torch_lm.py's bf16 logit bound, since repro's own 2e-2 does not hold
# for repro in bf16 at full width: its flash path reads 2.76e-2 on these weights and
# prompts on the CPU (tests/lm_bf16_consistency.py)
LM_F32_REL, LM_BF16_REL = 1e-4, 3e-2
LM_RTOL, LM_ATOL = 1e-4, 1e-4  # card vs CPU, reduced f32: other summation orders
FLASH_RTOL, FLASH_ATOL = 1e-5, 2e-5  # f32 kernel vs plain: one function, another order
# bf16: both round the softmax weights to bf16 before PV, the plain version
# after normalising them, the kernel before (it divides by the row sum last)
FLASH_BF16_ATOL = 3e-2
# and to a bound scaled to the data (_row_rel: each output row's largest error over its
# largest |value|). The two round p and the output to bf16 in other places, and where a
# row's output cancels, that rounding stays the size of its terms: a correct kernel reads
# 0.0219 on the smollm prefill call and 0.0185 at starcoder2's layout on an H100 (its CPU
# emulation 0.0135), while one 128-key tile dropped at a 4,096 window's edge, or its mask
# skipped (~3 % of a deep row's weight), reads 0.35-0.41 in the emulation, though its
# outputs there are small enough (spread ~sqrt(e / 4,096)) to pass the absolute bound
# (tests/test_torch_flash.py::test_row_scaled_bound_catches_window_edge_faults). The
# bound sits between the two: 2.9x the larger reading, 1/5.6 of the smaller fault.
FLASH_BF16_ROW_REL = 2.0 ** -4
BF16_FLOP_PER_S = 989e12  # H100 SXM data sheet, dense bf16 tensor cores
FLASH_SYNTHETIC = (  # ((B, S, H, K, hd), dtype, causal, window)
    ((2, 256, 4, 2, 64), "float32", True, None),
    ((2, 256, 4, 2, 64), "float32", False, None),
    ((2, 200, 4, 2, 64), "float32", True, None),  # a tail tile
    ((1, 512, 14, 2, 64), "float32", True, None),  # qwen2-0.5b's G 7
    ((1, 8192, 36, 4, 128), "bfloat16", True, 4096),  # starcoder2-7b's layout and window
)


def _rel(a, b) -> float:
    """max |a - b| / max |b| in f32: repro's forward-vs-decode measure."""
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max()).item()


def _row_rel(got, want) -> float:
    """max over rows (every index but the last) of max |got - want| over the
    row's hd columns / max |want| over them, in f32."""
    g, w = got.float(), want.float()
    return ((g - w).abs().amax(-1) / w.abs().amax(-1).clamp_min(1e-30)).max().item()


def _flash_key(call):
    (q, k, *_), kwargs = call
    return (tuple(q.shape), tuple(k.shape), str(q.dtype), kwargs.get("causal", True),
            kwargs.get("window"))


def _decode_all(torch, T, model, cfg, tokens):
    """Step every column of ``tokens`` (B, S) through a fresh cache; the
    last step's logits and the seconds the steps took."""
    cache = T.init_cache(cfg, tokens.shape[0], tokens.shape[1], tokens.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(tokens.shape[1]):
        logits, cache = T.decode_step(model, cfg, cache, tokens[:, i:i + 1])
    torch.cuda.synchronize()
    return logits, time.perf_counter() - t0


def lm_path(torch, np, fa_mod) -> dict:
    """The LM substrate's serving side on smollm-135m at full width (random
    weights from the port's init, seed 0): the prefill through
    ``examples/serve_lm_torch.py``'s ``run`` (``make_prefill`` on B 4 x S
    2,048, 30 ``flash_attention`` launches a forward; counts zeroed before,
    read after; the first call of each shape recorded), the flash share of
    one forward's device time, prefill vs decode on 256-token prompts (bf16
    and the same weights in f32), ``BatchedServer`` twice on 16 requests,
    and the reduced model in f32 on the card vs the CPU."""
    import copy

    import serve_lm_torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import BatchedServer, ServeConfig

    args = serve_lm_torch.parser().parse_args(
        ["--arch", LM_ARCH, "--batch", str(LM_BATCH), "--prefill-len", str(LM_SEQ),
         "--tokens", "0", "--seed", "0"])
    calls: list = []
    fa_mod.launches = 0
    with recording(ops, "flash_attention", calls):
        res = serve_lm_torch.run(args)
    launches = fa_mod.launches
    calls = first_of_each_shape(calls, _flash_key)
    spec, model = res["spec"], res["model"]
    cfg = spec.lm
    if launches != cfg.n_layers * res["prefill_forwards"]:
        fail(f"lm prefill: {launches} flash_attention launches in {res['prefill_forwards']} "
             f"forwards of {cfg.n_layers} layers")
    last = res["prefill_last_logits"]
    if last.shape != (LM_BATCH, cfg.vocab_padded) or not torch.isfinite(last).all():
        fail(f"lm prefill: last logits {tuple(last.shape)} not finite or misshapen")
    out = {"phase": "lm prefill", "arch": spec.arch_id, "batch": LM_BATCH, "seq": LM_SEQ,
           "dtype": cfg.dtype, "params": sum(p.numel() for p in model.parameters()),
           "launches": {"flash_attention": launches}, "forwards": res["prefill_forwards"],
           "launches_per_forward": launches / res["prefill_forwards"],
           "prefill_s": res["prefill_s"], "prefill_tokens_per_s": res["prefill_tokens_per_s"]}

    prefill = spec.make_prefill()
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(LM_BATCH, LM_SEQ))).to("cuda")
    for _ in range(CUPTI_TRIES):  # until the profile keeps the kernel's 30 records
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prefill(model, {"tokens": toks})
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        # flash_fwd_kernel (f32) and flash_fwd_kernel_wgmma (bf16)
        flash = [e for e in dev if "flash_fwd_kernel" in e.key]
        if sum(e.count for e in flash) == cfg.n_layers:
            break
    else:
        fail(f"lm prefill: {CUPTI_TRIES} profiles of the forward lost flash_attention records")
    total_us = sum(e.self_device_time_total for e in dev)
    flash_us = sum(e.self_device_time_total for e in flash)
    # the forward's device time beside its host wall (the median timed
    # forward): the larger of the two sets the prefill's pace
    host_ms = statistics.median(res["prefill_s"]) * 1e3
    out.update(forward_device_ms=total_us / 1e3, flash_device_ms=flash_us / 1e3,
               flash_share=flash_us / total_us, forward_host_ms=host_ms,
               paced_by="host" if host_ms > total_us / 1e3 else "card")
    emit(out)

    # prefill vs decode, 256-token prompts: bf16 as served, and the same
    # weights in f32 (the regime of repro's bound)
    p256 = toks[:, :256].contiguous()
    full = prefill(model, {"tokens": p256})
    dec, dec_s = _decode_all(torch, T, model, cfg, p256)
    spec32 = dataclasses.replace(spec, lm=dataclasses.replace(cfg, dtype="float32"))
    m32 = copy.deepcopy(model).float()
    full32 = spec32.make_prefill()(m32, {"tokens": p256})
    dec32, _ = _decode_all(torch, T, m32, spec32.lm, p256)
    del m32
    cons = {"phase": "lm consistency", "prompts": list(p256.shape),
            "f32_prefill_vs_decode": _rel(dec32, full32),
            "bf16_prefill_vs_decode": _rel(dec, full),
            "bf16_prefill_vs_f32": _rel(full, full32), "bf16_decode_vs_f32": _rel(dec, full32),
            "f32_bound": LM_F32_REL, "bf16_bound": LM_BF16_REL,
            "decode_steps_per_s": p256.shape[1] / dec_s}
    emit(cons)
    for dtype, bound in (("f32", LM_F32_REL), ("bf16", LM_BF16_REL)):
        if not cons[f"{dtype}_prefill_vs_decode"] < bound:
            fail(f"lm consistency: {dtype} prefill vs decode differ by "
                 f"{cons[f'{dtype}_prefill_vs_decode']} (bound {bound})")
    for k in ("bf16_prefill_vs_f32", "bf16_decode_vs_f32"):
        if not np.isfinite(cons[k]):
            fail(f"lm consistency: {k} is not finite")

    # serving: 16 requests, prompts of 8-64 tokens, served twice
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).tolist()
               for n in rng.integers(8, 65, size=16)]
    scfg = ServeConfig(batch_size=8, max_new_tokens=32, cache_len=256)
    outs, times = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(BatchedServer(spec, model, scfg).generate(prompts))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if outs[0] != outs[1]:
        fail("lm serving: two greedy runs of the same requests differ")
    if any(len(o) != 32 or not all(0 <= t < cfg.vocab for t in o) for o in outs[0]):
        fail("lm serving: an output is not 32 in-vocabulary tokens")
    steps = sum(max(len(p) for p in prompts[lo:lo + 8]) + 31 for lo in (0, 8))
    # the tokens the requests hold: each prompt and what it generated (a
    # shorter prompt's row repeats its last token until the batch's longest
    # prompt is in, and those repeats are not counted), over both runs' wall
    served = sum(len(p) + len(o) for p, o in zip(prompts, outs[0]))
    generated = sum(len(o) for o in outs[0])
    serve = {"phase": "lm serving", "requests": 16, "batch": 8, "new_tokens": 32,
             "prompt_lens": [len(p) for p in prompts], "decode_steps": steps,
             "serve_s": times, "identical": True,
             "decode_tokens_per_s": 2 * served / sum(times),
             "generated_tokens_per_s": 2 * generated / sum(times),
             "first_outputs": outs[0][:2]}
    emit(serve)
    out.update(consistency=cons, serving=serve)

    # card vs CPU: the reduced model in f32, forward and 16 decode steps
    red = get_arch(LM_ARCH, reduced=True)
    m_cpu = red.init_params(torch.Generator().manual_seed(0), "cpu")
    m_gpu = copy.deepcopy(m_cpu).to("cuda")
    t_cpu = torch.from_numpy(np.random.default_rng(1).integers(0, red.lm.vocab, size=(2, 32)))
    torch.use_deterministic_algorithms(True)
    try:
        with torch.no_grad():
            got = T.forward(m_gpu, red.lm, t_cpu.cuda())[0].cpu()
            want = T.forward(m_cpu, red.lm, t_cpu)[0]
        if not torch.allclose(got, want, rtol=LM_RTOL, atol=LM_ATOL):
            fail("lm card vs CPU: forward logits differ")
        diffs = [got - want]
        c_cpu = T.init_cache(red.lm, 2, 16, "cpu")
        c_gpu = T.init_cache(red.lm, 2, 16, "cuda")
        for i in range(16):
            a, c_cpu = T.decode_step(m_cpu, red.lm, c_cpu, t_cpu[:, i:i + 1])
            b, c_gpu = T.decode_step(m_gpu, red.lm, c_gpu, t_cpu[:, i:i + 1].cuda())
            if not torch.allclose(b.cpu(), a, rtol=LM_RTOL, atol=LM_ATOL):
                fail(f"lm card vs CPU: decode step {i} logits differ")
            diffs.append(b.cpu() - a)
    finally:
        torch.use_deterministic_algorithms(False)
    conf = {"phase": "lm card vs cpu", "arch": red.arch_id, "dtype": red.lm.dtype,
            "tokens": [2, 32], "decode_steps": 16,
            "max_abs_diff": max(d.abs().max().item() for d in diffs),
            "rtol": LM_RTOL, "atol": LM_ATOL}
    emit(conf)
    out.update(card_vs_cpu=conf, calls=calls)
    del model, res
    return out


def flash_build_phase(torch, build, fa_mod, lib) -> None:
    """The flash kernel as built: each instantiation's registers, local
    memory bytes (spills and stack) and dynamic shared memory, and whether
    its SASS holds HGMMA (``cuobjdump -sass`` on the library). The bf16
    instantiations must run on the tensor cores and must not spill."""
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    heads = list(re.finditer(r"^\s*Function : (\S+)\s*$", sass, re.M))
    bodies = {m.group(1): sass[m.end():heads[i + 1].start() if i + 1 < len(heads) else None]
              for i, m in enumerate(heads)}
    out = {"phase": "flash build", "instantiations": {}}
    # (dtype, kernel, its mangled name up to the head dim)
    for dtype, kernel, mangled in (
            (torch.bfloat16, "flash_fwd_kernel_wgmma", "flash_fwd_kernel_wgmmaILi"),
            (torch.float32, "flash_fwd_kernel", "flash_fwd_kernelILi")):
        for hd in fa_mod.HEAD_DIMS:
            names = [n for n in bodies if f"{mangled}{hd}E" in n]
            if len(names) != 1:
                fail(f"flash build: {len(names)} SASS functions for {kernel} hd {hd}: {names}")
            attrs = fa_mod.kernel_attrs(dtype, hd)
            rec = dict(attrs, kernel=kernel, hgmma=bodies[names[0]].count("HGMMA"))
            out["instantiations"][f"{str(dtype).replace('torch.', '')} hd {hd}"] = rec
            if dtype == torch.bfloat16 and not rec["hgmma"]:
                fail(f"flash build: the bf16 kernel at hd {hd} has no HGMMA in its SASS: "
                     "it does not run on the tensor cores")
            if dtype == torch.bfloat16 and rec["local_bytes"]:
                fail(f"flash build: the bf16 kernel at hd {hd} uses {rec['local_bytes']} bytes "
                     "of local memory (spills)")
    emit(out)


def kernel_build_phase(topk_mod, inbatch_mod) -> dict:
    """Registers, local memory bytes (spills and stack), dynamic shared
    memory and residency of each ``topk`` instantiation (one per list
    length; resident blocks an SM and resident 8-block clusters) and of the
    ``inbatch_loss`` kernel at d 64, 256 and 768. Any local memory fails, and
    so do fewer than two resident blocks an SM at the main path's sizes."""
    out = {"phase": "kernel build",
           "topk": {f"k <= {k}": topk_mod.kernel_attrs(k, topk_mod.MAX_CLUSTER)
                    for k in (32, 64, 128, 256)},
           "inbatch_loss": {f"d {d}": inbatch_mod.kernel_attrs(d) for d in (64, 256, 768)}}
    emit(out)
    for kernel in ("topk", "inbatch_loss"):
        for inst, attrs in out[kernel].items():
            if attrs["local_bytes"]:
                fail(f"{kernel} ({inst}) uses {attrs['local_bytes']} bytes of local memory "
                     "(spills)")
    for kernel, inst in (("topk", "k <= 128"), ("inbatch_loss", "d 64")):
        if out[kernel][inst]["blocks_per_sm"] < 2:
            fail(f"{kernel} ({inst}): {out[kernel][inst]['blocks_per_sm']} resident block an "
                 "SM, not two")
    return out


def _band_pairs(np, Sq: int, Skv: int, causal: bool, window) -> int:
    """(query, key) pairs inside the causal / window band."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(0, i - window + 1) if window is not None else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _flash_plain(torch, ref, q, k, v, causal, window, block: int = 1024):
    """The plain version, in query blocks of ``block`` (their logits are
    (B, H, block, Skv) f32) where Sq is larger."""
    if q.shape[1] <= block:
        return ref.attention_ref(q, k, v, causal, window)
    return torch.cat([ref.attention_ref(q[:, i:i + block], k, v, causal, window, i)
                      for i in range(0, q.shape[1], block)], dim=1)


def _flash_record(torch, np, ref, fa_cuda, q, k, v, causal, window, source: str) -> dict:
    import torch.nn.functional as F

    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    got = fa_cuda(q, k, v, causal, window)
    want = _flash_plain(torch, ref, q, k, v, causal, window)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    row_rel = _row_rel(got, want)
    want_abs = want.float().abs()
    scale = {"want_abs_max": want_abs.max().item(), "want_abs_median": want_abs.median().item()}
    del want_abs
    bf16 = q.dtype == torch.bfloat16
    ok = (err <= FLASH_BF16_ATOL and row_rel <= FLASH_BF16_ROW_REL if bf16
          else torch.allclose(got, want, rtol=FLASH_RTOL, atol=FLASH_ATOL))
    if not ok:
        fail(f"flash_attention {tuple(q.shape)} K={K} {q.dtype} causal={causal} "
             f"window={window} ({source}) disagrees with its plain version: max abs {err}, "
             f"row-scaled {row_rel}, |want| {scale}")
    pairs = _band_pairs(np, Sq, Skv, causal, window)
    flops = 4.0 * hd * pairs * B * H
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    # the card's bound for the inputs' type, which is also the kernel's: bf16
    # runs on the tensor cores (wgmma), f32 on the CUDA cores; both bounds
    # stand in the record for comparison
    f32_core_ms = max(t_bytes, flops / FP32_FLOP_PER_S * 1e3)
    tc_ms = max(t_bytes, flops / BF16_FLOP_PER_S * 1e3)
    t_ops = flops / (BF16_FLOP_PER_S if bf16 else FP32_FLOP_PER_S) * 1e3
    big = flops > 1e11
    kern = measure(lambda: fa_cuda(q, k, v, causal, window), 5 if big else 50, floor_ms=tc_ms)
    plain = measure(lambda: _flash_plain(torch, ref, q, k, v, causal, window),
                    2 if big else 10, warmup=1, floor_ms=tc_ms)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if window is None:
        def lib_call():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
    else:
        i = torch.arange(Sq, device=q.device)[:, None]
        j = torch.arange(Skv, device=q.device)[None, :]
        band = j > i - window
        if causal:
            band &= j <= i

        def lib_call():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band, enable_gqa=True)
    lib = measure(lib_call, 5 if big else 50, floor_ms=tc_ms)
    rec = {"phase": "kernel", "name": "flash_attention", "source": source,
           "shape": {"B": B, "Sq": Sq, "Skv": Skv, "H": H, "K": K, "hd": hd},
           "dtype": str(q.dtype).replace("torch.", ""), "causal": causal, "window": window,
           "max_abs_err": err, "row_rel_err": row_rel, **scale,
           **times(kernel=kern, plain=plain, library=lib),
           "band_pairs": pairs, "flop": flops,
           "kernel_tflop_per_s": flops / kern["device_ms"] / 1e9,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "f32_core_bound_ms": f32_core_ms, "bf16_tc_bound_ms": tc_ms}
    if bf16:
        rec["exact_share"] = (got == want).float().mean().item()
    emit(rec)
    return rec


def flash_phase(torch, np, ref, fa_cuda, calls: list) -> dict:
    """The kernel against its plain version on the first prefill call of
    each shape, then at synthetic shapes: f32 causal and not, a tail tile,
    qwen2's G 7, starcoder2's bf16 layout with its 4,096 window."""
    recs = [_flash_record(torch, np, ref, fa_cuda, q, k, v, kw.get("causal", True),
                          kw.get("window"), "lm prefill path")
            for (q, k, v), kw in calls]
    main = max(recs, key=lambda r: r["flop"])
    gen = torch.Generator(device="cuda").manual_seed(3)
    for (B, S, H, K, hd), dtype, causal, window in FLASH_SYNTHETIC:
        dtype = getattr(torch, dtype)
        q = torch.randn(B, S, H, hd, device="cuda", generator=gen).to(dtype)
        k = torch.randn(B, S, K, hd, device="cuda", generator=gen).to(dtype)
        v = torch.randn(B, S, K, hd, device="cuda", generator=gen).to(dtype)
        _flash_record(torch, np, ref, fa_cuda, q, k, v, causal, window, "synthetic")
    return main


def main() -> None:
    # cuBLAS reads this when CUDA starts; without it deterministic algorithms
    # (the conformance phase) make cuBLAS raise
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
          f"CUDA {torch.version.cuda}, numpy {np.__version__}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attn as fa_mod
    from repro_torch.kernels import inbatch_loss as inbatch_mod
    from repro_torch.kernels import ivf as ivf_mod
    from repro_torch.kernels import row_adagrad as adagrad_mod
    from repro_torch.kernels import seg_aggr as seg_mod
    from repro_torch.kernels import topk as topk_mod
    from repro_torch.kernels import window_pairs as wp_mod

    t0 = time.perf_counter()
    lib = build.build(verbose=True)
    build.library()
    emit({"phase": "build", "library": os.path.relpath(lib, ROOT),
          "seconds": time.perf_counter() - t0})
    flash_build_phase(torch, build, fa_mod, lib)
    kernel_build_phase(topk_mod, inbatch_mod)

    modules = {"seg_aggr": seg_mod, "topk": topk_mod, "inbatch_loss": inbatch_mod,
               "row_adagrad": adagrad_mod, "window_pairs": wp_mod, "ivf_list_topk": ivf_mod}
    mp = main_path(torch, np, modules)
    iv = ivf_serving_path(torch, np, modules, mp)
    m1 = million_arm(torch, np, modules)
    tr = training_path(torch, np, modules, mp["recall"]["u2i"])
    fu = fused_training_path(torch, np, modules, mp["recall"]["u2i"])
    conf = conformance_phase(torch, np)
    lm = lm_path(torch, np, fa_mod)
    gc.collect()
    torch.cuda.empty_cache()  # the IVF phases' blocks: leave the card's memory free
    emit({"phase": "clocks", "before_kernel_phases": sm_clocks(),
          "reserved_gib": torch.cuda.memory_reserved() / 2**30})
    seg = seg_aggr_phase(torch, ref, seg_mod.seg_aggr_cuda,
                         {"serving": mp["calls"]["seg_aggr"], "training": tr["kept"]["seg_aggr"],
                          "fused training": fu["kept"]["seg_aggr"]})
    topk = topk_phase(torch, ref, topk_mod,
                      {"serving": mp["calls"]["topk"], "1M arm": m1["topk_calls"]})
    seg_bwd = seg_aggr_bwd_phase(torch, ref, seg_mod.seg_aggr_bwd_cuda, tr["kept"]["seg_aggr_bwd"])
    inbatch = inbatch_phase(torch, ref, inbatch_mod, tr["kept"]["inbatch_loss"])
    adagrad = row_adagrad_phase(torch, ref, adagrad_mod.row_adagrad_scatter_cuda,
                                tr["kept"]["row_adagrad"])
    wp = window_pairs_phase(torch, ref, wp_mod.window_pair_ids_cuda, fu["window_pairs_calls"])
    ivf = ivf_phase(torch, ref, ivf_mod.ivf_list_topk_cuda,
                    {"ivf serving": iv["calls"]["ivf serving"],
                     "ivf exhaustive": iv["calls"]["ivf exhaustive"], "1M arm": m1["calls"]})
    flash = flash_phase(torch, np, ref, fa_mod.flash_attention_cuda, lm["calls"])

    def entry(name, rec, source, replaces, by_path):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": rec["max_abs_err"], "ms": rec["kernel_ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
                "ms_from": {k: rec["ms_from"][k] for k in ("kernel", "plain", "library")}}

    tl, fl = tr["launches"], fu["launches"]
    emit({"phase": "clocks", "after_kernel_phases": sm_clocks()})
    # the end-to-end numbers again, here, where the end of the output keeps them
    emit({"phase": "summary",
          "serving": {k: mp[k] for k in ("nodes_per_s", "embed_s", "recall_s",
                                         "u2i_queries_per_s", "launches")},
          "training": {k: tr[k] for k in (
              "pairs_per_s", "train_s", "step_wall_ms", "dispatch_ms_median",
              "dispatch_host_ms_median", "between_steps_host_ms_median",
              "loss_first20_mean", "loss_last20_mean", "u2i_trained", "launches")},
          "fused_training": {k: fu[k] for k in (
              "pairs_per_s", "train_s", "step_wall_ms", "dispatch_ms_median",
              "dispatch_host_ms_median", "between_steps_host_ms_median", "device_busy_share",
              "device_table_bytes", "loss_first20_mean", "loss_last20_mean", "u2i_trained",
              "launches")},
          "auto_sampling": {k: fu["auto"][k] for k in ("sampling", "reason", "measurements")},
          "ivf_serving": {k: iv[k] for k in (
              "recall_s", "recall", "u2i_queries_per_s", "u2i_search_queries_per_s",
              "u2i_search_ivf_over_exact_time", "u2i_search_split", "item_index",
              "user_index", "launches")},
          "ivf_exhaustive": iv["exhaustive"],
          "ivf_1m": {k: m1[k] for k in ("build_s", "lpad", "spilled_items", "shortlist",
                                        "recall_at_100", "queries_per_s",
                                        "exact_over_ivf_time", "search_split",
                                        "launches")},
          "conformance": {u: {k: conf[u][k] for k in ("loss_max_abs_diff",
                                                      "param_max_abs_diff")}
                          for u in ("sparse", "dense", "fused")},
          "lm_serving": {
              "arch": lm["arch"], "prefill_tokens_per_s": lm["prefill_tokens_per_s"],
              "decode_tokens_per_s": lm["serving"]["decode_tokens_per_s"],
              "generated_tokens_per_s": lm["serving"]["generated_tokens_per_s"],
              "flash_share": lm["flash_share"], "forward_device_ms": lm["forward_device_ms"],
              "forward_host_ms": lm["forward_host_ms"], "paced_by": lm["paced_by"],
              "launches": lm["launches"],
              "consistency": {k: lm["consistency"][k] for k in (
                  "f32_prefill_vs_decode", "bf16_prefill_vs_decode", "bf16_prefill_vs_f32",
                  "bf16_decode_vs_f32")},
              "card_vs_cpu_max_abs_diff": lm["card_vs_cpu"]["max_abs_diff"]}})
    print(json.dumps({"kernels": [
        entry("seg_aggr", seg, "src/repro_torch/kernels/csrc/seg_aggr.cu",
              "src/repro/kernels/seg_aggr.py:45",
              {"serving": mp["launches"]["seg_aggr"], "training": tl["seg_aggr"],
               "fused training": fl["seg_aggr"]}),
        entry("topk", topk, "src/repro_torch/kernels/csrc/topk.cu",
              "src/repro/kernels/topk.py:77",
              {"serving": mp["launches"]["topk"], "1M arm": m1["topk_launches"]}),
        entry("seg_aggr_bwd", seg_bwd, "src/repro_torch/kernels/csrc/seg_aggr.cu",
              "src/repro/kernels/seg_aggr.py:45",
              {"training": tl["seg_aggr_bwd"], "fused training": fl["seg_aggr_bwd"]}),
        entry("inbatch_loss", inbatch, "src/repro_torch/kernels/csrc/inbatch_loss.cu",
              "src/repro/kernels/inbatch_loss.py:41",
              {"training": tl["inbatch_loss"], "fused training": fl["inbatch_loss"]}),
        entry("row_adagrad", adagrad, "src/repro_torch/kernels/csrc/row_adagrad.cu",
              "src/repro/kernels/row_adagrad.py:41",
              {"training": tl["row_adagrad"], "fused training": fl["row_adagrad"]}),
        entry("window_pairs", wp, "src/repro_torch/kernels/csrc/window_pairs.cu",
              "src/repro/kernels/window_pairs.py:38", {"fused training": fl["window_pairs"]}),
        entry("ivf_list_topk", ivf, "src/repro_torch/kernels/csrc/ivf.cu",
              "src/repro/kernels/ivf.py:97",
              {"ivf serving": iv["launches"]["ivf_list_topk"],
               "ivf exhaustive": iv["exhaustive"]["launches"], "1M arm": m1["launches"]}),
        entry("flash_attention", flash, "src/repro_torch/kernels/csrc/flash_attn.cu",
              "src/repro/kernels/flash_attn.py:81",
              {"lm prefill": lm["launches"]["flash_attention"]}),
    ]}), flush=True)
    print(smi, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
