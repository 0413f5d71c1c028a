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
   then the flash kernels' instantiations, forward and backward: the bf16
   ones' SASS (the backward's dK/dV and dQ kernel) must hold ``HGMMA``
   (the tensor cores' wgmma; ``cuobjdump -sass`` on the built library), and
   each instantiation's registers, local memory (spills) and dynamic shared
   memory are printed, a bf16 forward or any backward one with local
   memory failing;
   the same for each ``topk`` instantiation (with resident blocks an SM and
   resident 8-block clusters), the ``inbatch_loss`` kernel at d 64, 256
   and 768 (with resident blocks an SM), the ``seg_aggr`` forward's and
   backward's and ``row_adagrad``'s 16- and 4-byte instantiations (with the
   grid cap) and the ``ivf_list_topk`` shared path at the
   recorded calls' sizes in every cluster size that fits (with resident
   blocks an SM and resident clusters): any local memory fails, and so do
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
6a. the observability layer (``repro_torch.obs``, ``train.attribution``):
   ``observed_training``, the training phase's flags and 200 sparse steps
   with attribution, telemetry and health on, run in turns with the same
   run untraced (plain, observed, observed, plain): pairs/s of each (the
   instrument's cost, reported, not gated), the per-step split (``sample``,
   ``assemble``, ``batch_wait``, ``h2d``, ``dispatch``, ``loss_fetch``,
   each beside its thread's CPU time; the step's span on the device
   timeline from CUDA events; the wall), span and dropped-span counts, the
   memory peaks by phase, 200 health beats and no fault, the trace under
   ``build/chip_smoke/``, launches as the training phase's;
   then the h2d phase's work alone (pinning, issuing the copies) and a
   serial control run (prefetch 0: no producer thread to share the
   interpreter lock with);
   ``mp_training``, the same host path (attribution on) on three graph
   engines in turns (inproc, mp at the default local threshold 8,192, mp
   at 0 so every sampling round crosses to a worker process), two workers, ``os.cpu_count()`` beside them: pairs/s,
   the per-step split with thread CPU, the device span, local against
   worker rounds, pickled replies, slab high-water, the workers' start
   time, resident sets and torch imports, ``/dev/shm``'s free bytes; the
   three runs' 200 losses bitwise equal, launches equal to the in-process
   run's and the training phase's; then 60 mp steps with health and
   telemetry on (every worker answering its heartbeats, worker serve spans
   in the trace under ``build/chip_smoke/``) and ``train_torch.py
   --engine-backend mp`` on TOY as a subprocess (the script imports torch,
   its workers must not: their start and resident sets);
   ``observed_fused``, the same for the fused path, 200 dense steps,
   ``window_pairs`` once a step; ``observed_conformance``, TOY 12 steps
   under deterministic algorithms on the card, losses and parameters with
   the three hooks on bitwise equal to a run with them off (sparse and
   dense with prefetch 2, fused); ``warm_start``, the training phase's
   ``emb/*`` tables through ``save_table`` and ``load_table`` (bitwise),
   then 60 UB steps cold and warm from the same seed, loss means and
   trained U2I of both (reported, not gated); ``sweep``,
   ``examples/eval_torch.py``'s ``run`` on UB for LightGCN and
   metapath2vec (trained, exported, loaded back), ``--method device`` and
   ``ivf``, U2I: each report equal to ``evaluate_recall`` on the same
   embeddings, ``topk`` / ``ivf_list_topk`` launches counted, the
   markdown through ``recall_report``;
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
   cache 256) twice on 8 requests of 8-64 tokens, greedy outputs equal,
   and the tokens the requests hold (prompts and outputs) per second;
   the reduced model in f32, card vs CPU under deterministic algorithms,
   forward and 16 decode steps to rtol/atol 1e-4;
6c. LM training, smollm-135m at full width through
   ``repro_torch.launch.train``'s ``run`` (B 4 x S 2,048, 20 steps, lr
   3e-4, seed 0; the port's bf16 init, which Adam turns f32 at step 1 as
   ``repro``'s does): ``flash_attention`` and ``flash_attention_bwd``
   launches zeroed before and read after each step (30 forwards and 30
   remat recomputes, 30 backward calls of three kernels each), every
   parameter f32 after step 1, the loss falling; tokens/s and the step
   wall, the bf16 first step apart; one more step profiled (the flash
   forward's and backward's device time and share); the first backward
   call of each (shape, dtype) recorded; then the reduced model in f32, 5
   steps on the CPU and twice on the card under deterministic algorithms:
   losses and parameters to 1e-4, the two card runs bitwise;
6d. the MoE, SSM and hybrid block kinds, each through the same entry
   points (weights from the port's init, seed 0; OLMoE's and Jamba's drawn
   on the card, Mamba2's on the CPU): ``lm_moe``, OLMoE-1B-7B at full
   width and depth (16 layers, 64 experts top-8, bf16): the prefill (B 4 x
   S 2,048, 16 ``flash_attention`` launches a forward) with the MoE layers'
   and the flash kernel's shares of a profiled forward and the share of
   token choices the capacity drops; layer 0 alone on its recorded input,
   prefill grouping vs groups of one (capacity factor 8: no drops) in f32
   and bf16, and card vs CPU in f32 on one group (rows routed alike to
   1e-4, or 3e-2 of each row's largest value in bf16; rows routed apart
   only at near-ties of the K-th and (K+1)-th router probabilities,
   within 1e-5); prefill vs decode on 4 x 256 tokens at capacity factor 8,
   every (layer, token) routing difference counted, the first layer's
   held to near-ties (1e-5 in f32; in bf16 a log-ratio of the two
   probabilities within 2^-4), the error gated at 1e-4 / 3e-2 only where
   none differs; ``BatchedServer`` twice, equal;
   ``lm_ssm``, Mamba2-1.3B at full width and depth (48 layers): the same
   prefill (no flash launch), in f32 the SSD in chunks of 256 against one
   chunk of 512 to 1e-4, prefill vs decode on 4 x 256 tokens and serving; ``lm_hybrid``, one full-width 8-layer period of
   Jamba-v0.1-52B (B 1 x S 2,048, one flash launch a forward; prefill vs
   decode as OLMoE's, its f32 side on the model turned f32 in place);
   ``lm_moe_training``, OLMoE at full width cut to 2 layers, 10 steps as
   6c (4 flash forwards and 2 backward calls a step, routers f32 from the
   start, every MoE aux loss finite); the reduced Jamba and Mixtral in
   f32, card vs CPU (forward and 16 decode steps to 1e-4), and the reduced
   Jamba's 5 training steps at lr 1e-5, card vs CPU to 1e-4 and card twice
   bitwise;
6e. Qwen2-VL and Whisper through the same entry points (seed 0):
   ``lm_vlm``, Qwen2-VL-7B at full width and depth (28 layers, 28 heads
   over 4 KV heads at hd 128, bf16, weights drawn on the card): the
   prefill (B 4 x S 2,048, the 1,024 patch embeddings over the span after
   BOS, 28 ``flash_attention`` launches a forward) with the flash share of
   a profiled forward; ``BatchedServer`` twice on text, equal; text-only
   prefill vs decode on 4 x 256 tokens (M-RoPE ids (t, t, t)), 1e-4 in f32
   (the model turned f32 in place) and 3e-2 in bf16; the reduced model in
   f32 card vs CPU, forward with patches at 3-D ids and 16 decode steps;
   training at full width cut to 2 layers, 10 steps as 6c (2 microbatches
   a step: 8 flash forwards and 4 backward calls), and the reduced model's
   5 steps at lr 1e-5 card vs CPU and card twice bitwise;
   ``lm_whisper``, Whisper-tiny at full width and depth (4 + 4 layers, hd
   64, bf16): the prefill (B 8 x 1,500 frames and 448 tokens, 8 launches a
   forward: 4 non-causal, 4 causal) with the encoder's and decoder's device
   time; teacher forcing vs 64 decode steps on 4 requests, 1e-4 in f32 and
   3e-2 in bf16; greedy serving of 8 requests (4 prompt tokens, 64 new,
   cache 448) twice, equal; full width in f32 card vs CPU (encoder states,
   decoder logits, 16 decode steps to 1e-4); the reduced config (hd 24)
   refused by the flash wrapper on the card; training B 8 x 448 tokens, 20
   steps as 6c, ``enc_pos`` a bf16 parameter before step 1 and f32 after;
7. the launch floor: the time ``measure`` reports for an empty kernel of
   the same library, one block and one wave of blocks, on a line of its own;
   then kernel phases: each kernel against its plain PyTorch version on the
   card, on the recorded inputs of the main paths (``seg_aggr``: of all
   three, bitwise; ``seg_aggr_bwd``: every kept call of both training paths,
   bitwise, with each shape's zero-gradient and mask-count shares;
   ``row_adagrad``: every kept
   call to 1e-5, untouched rows and a re-run bitwise, each (table, bucket)
   shape timed with its real ids; ``window_pairs``: every call, exactly;
   ``ivf_list_topk``: every
   call of the three IVF runs, rows exactly, with the launch plan each took,
   and a synthetic call past a cluster's shared memory on the kernel's
   global path; ``flash_attention``: the LM
   prefills' recorded calls (smollm's, OLMoE's, Jamba's, Qwen2-VL's and
   Whisper's encoder and decoder), bf16 to atol 3e-2 and to 2^-4 of each output
   row's largest value, with the output's max and median |value| printed
   beside the errors; ``topk``: every call of the serving path and the 1M
   arm, each shape's launch plan (query tile, splits = cluster size,
   blocks), and the U2I call with fewer exclusions and a smaller k, to
   show where its time goes; ``inbatch_loss``: every kept call, bitwise on
   a re-run; ``flash_attention_bwd``: the first LM training call of each
   shape and dtype (smollm's, OLMoE's, Qwen2-VL's, Whisper's encoder and
   decoder) against ``attention_bwd_ref``, f32 to rtol 1e-4, bf16 to 2^-6 of
   each row's largest value, a bitwise re-run, beside the backward of
   ``scaled_dot_product_attention`` through autograd), then (``seg_aggr``,
   ``topk``, ``inbatch_loss``, ``window_pairs``, ``flash_attention``) at
   synthetic shapes (``topk``: 1,024 queries against 20,000 and 1M items,
   k 1 and k 256, an exclusion row past the shared cap, integer-valued
   ties exactly, a bitwise re-run; ``inbatch_loss``: P 2,048 and 8,192 at
   d 64, 8,192 at d 256, each beside the library call; flash: f32 to rtol
   1e-5 / atol 2e-5, causal and not, a tail tile, qwen2's G 7, hd 32, hd
   128 with a tail tile and a 64-key window, starcoder2's bf16 (1, 8,192,
   36, 4, 128) with its 4,096 window, every forward call also re-run
   bitwise; the
   backward at the same shapes, from the forward kernel's output and LSE
   and a random dO); one
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
    (a bound the card cannot beat), is taken again with twice the calls,
    and after ``CUPTI_TRIES`` such the run fails. (The f32 forward's small
    synthetic calls, 50 calls of 0.03 ms, keep 21 of their records in a
    first profile on an H100 again and again, and the first of them once
    did in all three; a longer loop outweighs a loss of a fixed count,
    though not every loss is one.)
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
        calls = iters << attempt
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.count > 0]
        per_call = [max(1, round(e.count / calls)) for e in dev]
        dev_ms = sum(e.self_device_time_total / e.count * n for e, n in zip(dev, per_call)) / 1e3
        if (dev and all(2 * e.count >= n * calls for e, n in zip(dev, per_call))
                and dev_ms > floor_ms):
            return {"call_ms": call_ms, "device_ms": dev_ms, "ms_from": "cupti"}
        print(f"chip_smoke: profile {attempt + 1} of {calls} calls kept "
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
    # PyTorch's sum over F adds in the kernel's order at F <= 4 with D > 1,
    # every shape here, so the two are bitwise equal
    if not torch.equal(got, want):
        fail(f"seg_aggr {mode} {(n, f, d)} ({source}) is not bitwise its plain version")
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
    against the plain version, bitwise; each of its shapes timed on its
    recorded inputs; then every mode at synthetic shapes."""
    worst, recs = 0.0, []
    for path, calls in paths.items():
        path_worst = 0.0
        for (x, mask, mode), _ in calls:
            got, want = seg_aggr_cuda(x, mask, mode), ref.seg_aggr_ref(x, mask, mode)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"seg_aggr {mode} {tuple(x.shape)}: a {path} call is not bitwise "
                     "its plain version")
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


def _ivf_plan(ivf_mod, q, codes, starts, lpad: int, S: int) -> dict:
    """The launch the wrapper makes for a call (``kernels/ivf.py:launch_plan``)."""
    plan = ivf_mod.launch_plan(q, codes, starts.shape[1], lpad, S)
    return {k: plan[k] for k in ("regime", "cluster", "load", "probes_per_block", "blocks",
                                 "shared_bytes", "blocks_per_sm", "resident_clusters", "waves")
            if k in plan}


def _ivf_record(torch, ref, ivf_mod, call, source: str) -> dict:
    q, codes, scales, starts, lens, lpad, S = _ivf_args(torch, call)
    (Q, d), P = q.shape, starts.shape[1]
    ivf_list_topk_cuda = ivf_mod.ivf_list_topk_cuda
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
           "plain_batch": pb, "plan": _ivf_plan(ivf_mod, q, codes, starts, lpad, S),
           "forced_plans_ms": _ivf_forced_plans(torch, ref, ivf_mod, q, codes, scales, starts,
                                                lens, lpad, S, pb, 5 if big else 20),
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


def _ivf_forced_plans(torch, ref, ivf_mod, q, codes, scales, starts, lens, lpad: int, S: int,
                      pb: int, iters: int) -> dict:
    """Device ms of every plan the kernel takes at this call's sizes (each
    cluster size whose blocks fit, and the global path as "0") through
    ``ivf_list_topk_planned``: the times the wrapper's plan is chosen among.
    Each plan's rows must equal the plain version's and its scores agree
    within ``IVF_RTOL`` / ``IVF_ATOL``."""
    P, d = starts.shape[1], q.shape[1]
    s0, r0 = ref.ivf_list_topk_ref(q, codes, scales, starts, lens, lpad=lpad, shortlist=S,
                                   batch_size=pb)
    fits = [c for c in range(1, min(ivf_mod.MAX_CLUSTER, P) + 1)
            if ivf_mod.shared_bytes(-(-P // c), lpad, d, c, S) <= ivf_mod.SHARED_CAP]
    out = {}
    for c in [0] + fits:
        def run(c=c):
            return ivf_mod.ivf_list_topk_planned(q, codes, scales, starts, lens, lpad, S, c)
        s, r = run()
        torch.cuda.synchronize()
        if not torch.equal(r, r0) or not torch.allclose(s, s0, rtol=IVF_RTOL, atol=IVF_ATOL):
            fail(f"ivf_list_topk Q={q.shape[0]} S={S} forced to cluster {c} disagrees with "
                 "its plain version")
        out[str(c)] = measure(run, iters)["device_ms"]
    return out


def _ivf_global_call(torch):
    """A synthetic call past a cluster's shared memory (P 64, lpad 4,000,
    d 64): the kernel's global path, with its (2, Q, S) workspace."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    Q, P, d, lpad, rows = 16, 64, 64, 4000, 200_000
    codes = torch.randint(-127, 128, (rows + lpad, d), dtype=torch.int8, device="cuda",
                          generator=gen)
    scales = torch.rand(rows + lpad, 1, device="cuda", generator=gen) + 0.5
    q = torch.randn(Q, d, device="cuda", generator=gen)
    starts = torch.randint(0, rows, (Q, P), dtype=torch.int32, device="cuda", generator=gen)
    lens = torch.randint(0, lpad + 1, (Q, P), dtype=torch.int32, device="cuda", generator=gen)
    return (q, codes, scales, starts, lens), {"lpad": lpad, "shortlist": 5000}


def ivf_phase(torch, ref, ivf_mod, paths: dict) -> dict:
    """Every recorded call of each IVF path against the plain version (rows
    exactly, scores to rtol 2e-5 / atol 1e-4), with the plan each took; the
    UB calls, the first exhaustive call and the 1M call timed on their
    recorded inputs, in the wrapper's plan and in every plan that fits;
    then a synthetic call on the global path, held and timed the same
    way."""
    worst, recs = 0.0, {}
    paths = dict(paths, synthetic=[_ivf_global_call(torch)])
    for path, calls in paths.items():
        path_worst, plans = 0.0, collections.Counter()
        for c in calls:
            q, codes, scales, starts, lens, lpad, S = _ivf_args(torch, c)
            s, r = ivf_mod.ivf_list_topk_cuda(q, codes, scales, starts, lens, lpad, S)
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
            plans[json.dumps(_ivf_plan(ivf_mod, q, codes, starts, lpad, S))] += 1
        emit({"phase": "kernel", "name": "ivf_list_topk", "source": f"{path}, every call",
              "calls": len(calls), "max_abs_err": path_worst,
              "max_shortlist": max(c[1]["shortlist"] for c in calls),
              "plans": [dict(json.loads(p), calls=n) for p, n in plans.items()]})
        worst = max(worst, path_worst)
        timed = calls if path == "ivf serving" else calls[:1]
        recs[path] = [_ivf_record(torch, ref, ivf_mod, c, path) for c in timed]
    if recs["synthetic"][0]["plan"]["regime"] != "global":
        fail(f"the synthetic ivf_list_topk call took {recs['synthetic'][0]['plan']}, "
             "not the global path")
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
    return dict(out, kept=rec.kept, params=r.params)


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


# ------------------------------------------------------------ observability
def _launch_counts(modules) -> dict:
    return {"seg_aggr": modules["seg_aggr"].launches,
            "seg_aggr_bwd": modules["seg_aggr"].bwd_launches,
            **{n: modules[n].launches for n in ("inbatch_loss", "row_adagrad", "window_pairs",
                                                 "topk", "ivf_list_topk")}}


def _observed_hooks(tobs, name: str) -> dict:
    """attribution, telemetry and health on; flight records under build/."""
    return {"attribution": True, "telemetry": tobs.Telemetry(),
            "health": tobs.HealthConfig(stall_timeout_s=300.0, flightrec_dir=os.path.join(
                ROOT, "build", "chip_smoke", f"flightrec_{name}"))}


def _per_step_split(a: dict, steps: int) -> dict:
    """The attribution summary as ms a step: each phase's wall and its
    thread's CPU time, the device span from CUDA events, the wall, and the
    consumer side's share of the wall."""
    ph = a["phases"]
    split = {p: ph[p]["total_s"] / steps * 1e3 for p in ph}
    cpu = {p: s / steps * 1e3 for p, s in a["thread_cpu_s"].items()}
    consumer = sum(split.get(p, 0.0) for p in ("batch_wait", "h2d", "dispatch", "loss_fetch"))
    span = a["device_span"]
    return {"phase_ms_per_step": split, "phase_thread_cpu_ms_per_step": cpu,
            "phase_wait_ms_per_step": {p: split[p] - cpu.get(p, 0.0) for p in split},
            "phase_counts": {p: ph[p]["count"] for p in ph},
            "device_span_ms": span["span_ms"], "device_gap_to_next_step_ms":
            span.get("gap_to_next_step_ms"), "device_span_count": span["count"],
            "wall_ms_per_step": a["wall_s"] / steps * 1e3,
            "consumer_ms_per_step": consumer,
            "consumer_share_of_wall": consumer / (a["wall_s"] / steps * 1e3)}


def _observed_run(torch, np, modules, train_torch, args, name: str, steps: int,
                  **overrides) -> dict:
    """The untraced run and the run with all three hooks on, in turns
    (plain, observed, observed, plain): pairs/s of each, and the second
    observed run's split, trace, spans, memory peaks and health."""
    import json as json_mod

    from repro_torch import obs as tobs

    trace = os.path.join(ROOT, "build", "chip_smoke", f"{name}.trace.json")
    rates, observed = {"plain": [], "observed": []}, None
    for kind in ("plain", "observed", "observed", "plain"):
        hooks = _observed_hooks(tobs, name) if kind == "observed" else {}
        _zero(modules)
        res = train_torch.run(args, eval_at_end=False, **overrides, **hooks)
        torch.cuda.synchronize()
        r = res["result"]
        if len(r.losses) != steps or not np.isfinite(r.losses).all():
            fail(f"{name} ({kind}): {len(r.losses)} losses, finite "
                 f"{np.isfinite(r.losses).all()}")
        rates[kind].append(r.pairs_seen / r.wall_time_s)
        if kind == "observed":
            observed = (res, _launch_counts(modules))
    res, launches = observed
    r, trainer = res["result"], res["trainer"]
    tel, mon = trainer.cfg.telemetry, trainer._health_monitor
    a = r.attribution
    if a is None or a["phases"]["dispatch"]["count"] != steps or "device_span" not in a:
        fail(f"{name}: attribution missing its dispatch phases or device span: {a}")
    if a["device_span"]["count"] != steps:
        fail(f"{name}: {a['device_span']['count']} device spans for {steps} steps")
    if mon is None or mon.fault is not None or mon._last_step != steps - 1:
        fail(f"{name}: health monitor saw {None if mon is None else mon._last_step + 1} beats, "
             f"fault {None if mon is None else mon.fault}")
    counters = tel.metrics.summary()["counters"]
    if counters.get("health.stalls") or counters.get("health.loss_anomalies"):
        fail(f"{name}: health counters {counters}")
    tel.write_trace(trace)
    with open(trace) as f:
        events = json_mod.load(f)["traceEvents"]
    if not any(e.get("name") == "dispatch" for e in events):
        fail(f"{name}: the trace holds no dispatch span")
    mem = trainer._memory.summary()
    return {"steps": steps, "plan": r.plan["reason"], "pairs_per_s_plain": rates["plain"],
            "pairs_per_s_observed": rates["observed"],
            "observed_over_plain": (sum(rates["observed"]) / sum(rates["plain"])),
            **_per_step_split(a, steps), "attribution": a,
            "spans": tel.tracer.span_count(), "dropped_spans": tel.tracer.dropped_count(),
            "marks": [m[0] for m in tel.tracer.marks()], "counters": counters,
            "gauges": tel.metrics.summary()["gauges"],
            "memory_phase_peak_bytes": mem["phase_peak_bytes"],
            "max_memory_allocated": next(iter(mem["device_stats"].values()))[
                "max_memory_allocated"],
            "health_beats": mon._last_step + 1,
            "trace": os.path.relpath(trace, ROOT), "trace_events": len(events),
            "launches": launches, "trainer": trainer}


def _h2d_anatomy(torch, np, trainer, batches: int = 24) -> dict:
    """What the stager's ``h2d`` phase does, alone on one thread: fresh
    host batches of the run's pipeline (another seed) through
    ``model.pin`` and ``model.to_device``, each timed by the host clock,
    then a sync; the arrays and bytes a batch holds."""
    from repro_torch.core import model as model_lib
    from repro_torch.sampling.pipeline import make_train_sampler

    pipe = make_train_sampler(trainer.engine, trainer.pipe_cfg, backend="host", seed=1)
    items = list(trainer._host_batches(pipe, batches))
    sizes: list = []
    model_lib._map_tree(lambda a: sizes.append(a.nbytes) if isinstance(a, np.ndarray)
                        else None, items[0][0])
    pin_ms, copy_ms, done_ms = [], [], []
    for host, _ in items:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pinned = model_lib.pin(host)
        t1 = time.perf_counter()
        model_lib.to_device(pinned, trainer.device)
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        pin_ms.append((t1 - t0) * 1e3)
        copy_ms.append((t2 - t1) * 1e3)
        done_ms.append((t3 - t2) * 1e3)
    med = statistics.median
    return {"batches": batches, "arrays_per_batch": len(sizes), "bytes_per_batch": sum(sizes),
            "pin_ms_median": med(pin_ms[1:]), "to_device_issue_ms_median": med(copy_ms[1:]),
            "sync_after_ms_median": med(done_ms[1:]),
            "what": "one thread, no producer running: the h2d phase's work without the "
                    "interpreter lock's contention"}


def observed_training(torch, np, modules, tr: dict) -> dict:
    """The host training path with attribution, telemetry and health on:
    the training phase's flags, 200 sparse steps; the per-step split, the
    instrument's cost in pairs/s, spans, memory peaks, 200 beats."""
    import train_torch

    args = train_torch.parser().parse_args(
        ["--dataset", "ub", "--model", "lightgcn", "--dim", "64", "--side-info",
         "--batch-pairs", "512", "--steps", "200", "--seed", "0", "--prefetch-batches", "2"])
    out = _observed_run(torch, np, modules, train_torch, args, "observed_training", 200,
                        sparse_min_rows=0)
    for n in ("seg_aggr", "seg_aggr_bwd", "inbatch_loss", "row_adagrad"):
        if out["launches"][n] != tr["launches"][n]:
            fail(f"observed training launched {n} {out['launches'][n]} times; the training "
                 f"phase {tr['launches'][n]}")
    a = out["attribution"]["phases"]
    producer_ms = (a["sample"]["total_s"] + a["assemble"]["total_s"]) / 200 * 1e3
    anatomy = _h2d_anatomy(torch, np, out["trainer"])
    # the control: the same steps serially, no producer thread to share the
    # interpreter lock with (sampling and assembly inline, inside batch_wait)
    sargs = train_torch.parser().parse_args(
        ["--dataset", "ub", "--model", "lightgcn", "--dim", "64", "--side-info",
         "--batch-pairs", "512", "--steps", "200", "--seed", "0", "--prefetch-batches", "0",
         "--attribution"])
    sr = train_torch.run(sargs, sparse_min_rows=0, eval_at_end=False)["result"]
    torch.cuda.synchronize()
    serial = {k: v for k, v in _per_step_split(sr.attribution, 200).items() if k in (
        "phase_ms_per_step", "phase_thread_cpu_ms_per_step", "phase_wait_ms_per_step",
        "device_span_ms", "wall_ms_per_step")}
    serial["pairs_per_s"] = sr.pairs_seen / sr.wall_time_s
    out = {"phase": "observed_training", "dataset": "ub", "update": "sparse",
           "training_phase_pairs_per_s": tr["pairs_per_s"], "h2d_alone": anatomy,
           "serial_control": serial,
           "producer_ms_per_step": producer_ms,
           "producer_share_of_wall": producer_ms / out["wall_ms_per_step"], **out}
    emit({k: v for k, v in out.items() if k not in ("attribution", "trainer")})
    return out


# ------------------------------------------------------------- graph service
MP_CASES = {  # name -> (engine backend, local threshold): the three engines
    "inproc": ("inproc", 8192),
    "mp_8192": ("mp", 8192),  # the default: rounds of <= 8,192 nodes stay in-process
    "mp_0": ("mp", 0),  # every round crosses to a worker process
}
MP_WORKERS = 2  # train_recsys.py's and train_torch.py's --engine-workers default


def _mp_args(train_torch, backend: str, threshold: int, steps: int, *extra: str):
    return train_torch.parser().parse_args(
        ["--dataset", "ub", "--model", "lightgcn", "--dim", "64", "--side-info",
         "--batch-pairs", "512", "--steps", str(steps), "--seed", "0", "--prefetch-batches",
         "2", "--engine-backend", backend, "--engine-workers", str(MP_WORKERS),
         "--engine-local-threshold", str(threshold), *extra])


def _engine_summary(eng: dict) -> dict:
    """Local against worker rounds, pickled replies, slab high-water, the
    workers' start, resident sets and torch imports, /dev/shm's free bytes."""
    if "workers" not in eng:
        return {"neighbor_requests": eng["neighbor_requests"]}
    agg, per = eng["workers"], eng["per_worker"]
    return {"neighbor_requests": eng["neighbor_requests"], "rounds": agg["batches"],
            "rounds_local": agg["local_batches"],
            "rounds_worker": agg["batches"] - agg["local_batches"],
            "neighbor_requests_local": agg["local_neighbor_requests"],
            "serve_busy_s": agg["busy_s"],  # the workers' rounds and the local ones
            "pickle_replies": sum(w["pickle_replies"] for w in per),
            "shm_replies": sum(w["shm_replies"] for w in per),
            "slab_high_water": eng["slab_high_water"], "workers_start_s": eng["start_s"],
            "worker_rss_kb": [w["rss_kb"] for w in per],
            "workers_import_torch": [w["imports_torch"] for w in per],
            "shm_free_bytes_during": eng["shm_free_bytes"]}


def _cli_workers() -> dict:
    """``examples/train_torch.py --engine-backend mp`` as a user runs it (TOY,
    20 steps): the script imports torch at module level and its workers,
    which do not re-run it, must not; their start time, resident sets and
    torch imports from its output."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "examples")]))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "train_torch.py"), "--dataset", "toy",
         "--steps", "20", "--engine-backend", "mp", "--engine-workers", str(MP_WORKERS),
         "--engine-local-threshold", "0"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        fail(f"train_torch.py --engine-backend mp exited {res.returncode}: {res.stderr[-3000:]}")
    start = re.search(r"started in ([0-9.]+)s", res.stdout)
    rss = re.findall(r"RSS (\d+) KiB, imports torch: (True|False)", res.stdout)
    if start is None or len(rss) != MP_WORKERS or any(t != "False" for _, t in rss):
        fail(f"train_torch.py --engine-backend mp: no worker lines, or a worker imported "
             f"torch: {res.stdout[-2000:]}")
    return {"workers_start_s": float(start.group(1)), "worker_rss_kb": [int(r) for r, _ in rss],
            "workers_import_torch": [t == "True" for _, t in rss],
            "process_s": time.perf_counter() - t0}


def mp_training(torch, np, modules, tr: dict) -> dict:
    """The host training path on the in-process engine and on the graph
    service, in one process, in turns (inproc, mp 8192, mp 0; each ran
    twice, in both orders, until the run's time neared its limit): UB, 200
    sparse steps of 512 pairs, prefetch 2, two workers, attribution on.
    Losses bitwise equal across all three, launches equal the
    in-process run's, every round of ``mp_0`` served by a worker and no
    worker importing torch; then a short mp run with health and telemetry on
    (every worker answering its heartbeats, worker serve spans in the
    trace) and ``train_torch.py``'s own workers (numpy-only too)."""
    import json as json_mod

    import train_torch
    from repro_torch import obs as tobs
    from repro_torch.graph.service.shm import shm_free_bytes

    t_phase = time.perf_counter()
    shm_before = shm_free_bytes()
    runs: dict = {name: [] for name in MP_CASES}
    losses0 = launches0 = None
    for name in ("inproc", "mp_8192", "mp_0"):
        backend, threshold = MP_CASES[name]
        _zero(modules)
        res = train_torch.run(_mp_args(train_torch, backend, threshold, 200, "--attribution"),
                              sparse_min_rows=0, eval_at_end=False)
        torch.cuda.synchronize()
        r, launches = res["result"], _launch_counts(modules)
        if losses0 is None:
            losses0, launches0 = r.losses, launches
        if len(r.losses) != 200 or r.losses != losses0:
            diff = [i for i, (a, b) in enumerate(zip(r.losses, losses0)) if a != b]
            fail(f"mp_training ({name}): {len(r.losses)} losses, differing from the in-process "
                 f"run's at steps {diff[:10]}")
        for n in ("seg_aggr", "seg_aggr_bwd", "inbatch_loss", "row_adagrad"):
            if launches[n] != launches0[n] or launches[n] != tr["launches"][n]:
                fail(f"mp_training ({name}) launched {n} {launches[n]} times; the in-process "
                     f"run {launches0[n]}, the training phase {tr['launches'][n]}")
        eng = _engine_summary(res["engine"])
        if backend == "mp":
            if any(eng["workers_import_torch"]):
                fail(f"mp_training ({name}): a graph worker imported torch: {eng}")
            if threshold == 0 and (eng["rounds_local"] or not eng["rounds_worker"]):
                fail(f"mp_training ({name}): rounds not all served by workers: {eng}")
        runs[name].append({"pairs_per_s": r.pairs_seen / r.wall_time_s,
                           "train_s": r.wall_time_s, "plan": r.plan["reason"],
                           **_per_step_split(r.attribution, 200), "engine": eng,
                           "launches": launches})
    out = {"phase": "mp_training", "dataset": "ub", "update": "sparse", "steps": 200,
           "engine_workers": MP_WORKERS, "cpu_count": os.cpu_count(),
           "shm_free_bytes_before": shm_before, "losses_bitwise_equal": True,
           "training_phase_pairs_per_s": tr["pairs_per_s"],
           "pairs_per_s": {n: [x["pairs_per_s"] for x in v] for n, v in runs.items()}}
    for name, v in runs.items():
        keep = ("phase_ms_per_step", "phase_thread_cpu_ms_per_step", "phase_wait_ms_per_step",
                "device_span_ms", "wall_ms_per_step", "consumer_share_of_wall")
        out[name] = {"split": [{k: x[k] for k in keep} for x in v],
                     "engine": [x["engine"] for x in v], "launches": v[0]["launches"]}

    # heartbeats and worker spans: 60 steps with health and telemetry on
    trace = os.path.join(ROOT, "build", "chip_smoke", "mp_training.trace.json")
    tel = tobs.Telemetry()
    health = tobs.HealthConfig(stall_timeout_s=300.0, worker_heartbeat_s=0.25,
                               flightrec_dir=os.path.join(ROOT, "build", "chip_smoke",
                                                          "flightrec_mp_training"))
    res = train_torch.run(_mp_args(train_torch, "mp", 0, 60), sparse_min_rows=0,
                          eval_at_end=False, telemetry=tel, health=health)
    trainer, mon = res["trainer"], res["trainer"]._health_monitor
    pids = {p.pid for p in trainer.engine._procs}
    if res["result"].losses != losses0[:60]:
        fail("mp_training (observed): the traced mp run's losses differ from the in-process run's")
    if mon.fault is not None or mon.degraded or set(mon._silent) != set(range(MP_WORKERS)) \
            or any(mon._silent.values()):
        fail(f"mp_training (observed): worker heartbeats {mon._silent}, degraded {mon.degraded}, "
             f"fault {mon.fault}")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    tel.write_trace(trace)
    with open(trace) as f:
        events = json_mod.load(f)["traceEvents"]
    serve = [e for e in events if e.get("name") in ("worker.sample", "worker.sampleq")]
    if not serve or {e["pid"] for e in serve} != pids:
        fail(f"mp_training (observed): {len(serve)} worker serve spans in the trace, from pids "
             f"{sorted({e['pid'] for e in serve})}; the workers are {sorted(pids)}")
    counters = tel.metrics.summary()["counters"]
    out["observed"] = {"steps": 60, "heartbeat_s": 0.25, "workers_answering": sorted(mon._silent),
                       "worker_serve_spans": len(serve), "trace": os.path.relpath(trace, ROOT),
                       "client_rounds_worker": counters.get("client.rounds_worker", 0),
                       "client_pickle_fallback": counters.get("client.pickle_fallback", 0),
                       "client_round_latency_ns": tel.metrics.summary()["histograms"].get(
                           "client.round_latency_ns")}
    out["cli"] = _cli_workers()
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


def observed_fused(torch, np, modules, fu: dict) -> dict:
    """The fused training path with the three hooks on, 200 dense steps;
    ``window_pairs`` launches once a step, as in the fused phase."""
    import train_torch

    args = train_torch.parser().parse_args(
        ["--dataset", "ub", "--model", "lightgcn", "--dim", "64", "--side-info",
         "--batch-pairs", "512", "--seed", "0", "--steps", "200",
         "--sampling-backend", "fused", "--prefetch-batches", "0"])
    out = _observed_run(torch, np, modules, train_torch, args, "observed_fused", 200)
    if out["launches"]["window_pairs"] != 200:
        fail(f"observed fused training launched window_pairs {out['launches']['window_pairs']} "
             "times; want one a step, 200")
    for n in ("seg_aggr", "seg_aggr_bwd", "inbatch_loss", "window_pairs"):
        if out["launches"][n] != fu["launches"][n]:
            fail(f"observed fused training launched {n} {out['launches'][n]} times; the fused "
                 f"phase {fu['launches'][n]}")
    out = {"phase": "observed_fused", "dataset": "ub", "update": "dense", "sampling": "fused",
           "fused_phase_pairs_per_s": fu["pairs_per_s"], **out}
    emit({k: v for k, v in out.items() if k not in ("attribution", "trainer")})
    return out


def observed_conformance(torch, np) -> dict:
    """TOY, 12 steps on the card under deterministic algorithms: losses and
    parameters with all three hooks on equal those with them off, bitwise,
    for the sparse, dense and fused steps."""
    import train_torch
    from repro_torch import obs as tobs

    base = ["--dataset", "toy", "--model", "lightgcn", "--dim", "64", "--side-info",
            "--batch-pairs", "256", "--steps", "12", "--seed", "3"]
    cases = {"sparse": (["--prefetch-batches", "2"], {"sparse_min_rows": 0}),
             "dense": (["--prefetch-batches", "2"], {"sparse_min_rows": 1 << 30}),
             "fused": (["--sampling-backend", "fused", "--prefetch-batches", "0"], {})}
    out = {"phase": "observed_conformance", "dataset": "toy", "steps": 12}
    torch.use_deterministic_algorithms(True)
    try:
        for name, (flags, kw) in cases.items():
            args = train_torch.parser().parse_args(base + flags)
            off, on = (train_torch.run(args, device="cuda", eval_at_end=False, **kw, **hooks)
                       for hooks in ({}, _observed_hooks(tobs, f"conformance_{name}")))
            r_off, r_on = off["result"], on["result"]
            if name == "fused" and r_on.plan["sampling"] != "fused":
                fail(f"observed conformance planned {r_on.plan['sampling']!r} for fused")
            same = r_on.losses == r_off.losses and all(
                torch.equal(v, r_off.params[k]) for k, v in r_on.params.items())
            if not same or len(r_on.losses) != 12:
                fail(f"observed conformance ({name}): hooks on vs off differ: "
                     f"{r_on.losses} vs {r_off.losses}")
            out[name] = {"bitwise": True, "spans": on["telemetry"].tracer.span_count(),
                         "dispatch_count": r_on.attribution["phases"]["dispatch"]["count"]}
    finally:
        torch.use_deterministic_algorithms(False)
    emit(out)
    return out


def warm_start_phase(torch, np, tr: dict, serving_u2i: float) -> dict:
    """The training phase's tables through ``save_table`` / ``load_table``
    (bitwise), then a short UB run warm from them and one cold from the same
    seed: loss means and trained U2I of both, reported, not gated."""
    import train_torch
    from repro_torch.embedding import load_table, save_table

    npz = os.path.join(ROOT, "build", "chip_smoke", "ub_lightgcn64_tables.npz")
    tables = {k: v for k, v in tr["params"].items() if k.startswith("emb/")}
    save_table(npz, tables)
    back = load_table(npz)
    if back.keys() != tables.keys() or any(
            back[k].tobytes() != v.detach().cpu().numpy().tobytes() for k, v in tables.items()):
        fail("warm start: load_table did not give the saved tables back bitwise")
    out = {"phase": "warm_start", "dataset": "ub", "tables": {k: list(v.shape)
                                                                for k, v in back.items()},
           "round_trip_bitwise": True, "u2i_random_weights": serving_u2i}
    for kind, extra in (("cold", []), ("warm", ["--warm-start", npz])):
        args = train_torch.parser().parse_args(
            ["--dataset", "ub", "--model", "lightgcn", "--dim", "64", "--side-info",
             "--batch-pairs", "512", "--steps", "60", "--seed", "5",
             "--prefetch-batches", "2", *extra])
        res = train_torch.run(args, sparse_min_rows=0, eval_at_end=False)
        losses = np.asarray(res["result"].losses)
        if len(losses) != 60 or not np.isfinite(losses).all():
            fail(f"warm start ({kind}): {len(losses)} losses, finite {np.isfinite(losses).all()}")
        out[kind] = {"loss_first20_mean": float(losses[:20].mean()),
                     "loss_last20_mean": float(losses[-20:].mean()),
                     "pairs_per_s": res["result"].pairs_seen / res["result"].wall_time_s,
                     **_trained_u2i(res)}
    emit(out)
    return out


def sweep_phase(torch, np, modules) -> dict:
    """``eval_torch.run`` on UB for LightGCN and metapath2vec: train and
    export the embeddings, then evaluate them loaded back with ``--method
    device`` and ``ivf``; each report's metrics equal ``evaluate_recall`` on
    the same embeddings; ``topk`` and ``ivf_list_topk`` launches counted;
    the markdown through ``recall_report``."""
    import eval_torch
    import recall_torch
    from repro_torch.core.recall import evaluate_recall
    from repro_torch.graph import SPECS, generate
    from repro_torch.infer import load_embeddings
    from repro_torch.launch.recall_report import render_recall_report
    from repro_torch.retrieval import IVFConfig

    base = os.path.join(ROOT, "build", "chip_smoke", "sweep")
    common = ["--datasets", "ub", "--strategies", "u2i", "--dim", "64", "--seed", "0"]
    t0 = time.perf_counter()
    first = eval_torch.run(eval_torch.parser().parse_args(
        common + ["--models", "lightgcn,metapath2vec", "--steps", "100", "--method", "device",
                  "--export-embeddings", base]))
    train_export_s = time.perf_counter() - t0
    ds = generate(SPECS["ub"], seed=0)
    train = recall_torch.train_pairs(ds)
    results, runs = [], []
    for model in ("lightgcn", "metapath2vec"):
        path = f"{base}.ub.{model}.npz"
        emb = load_embeddings(path)
        ue, ie = emb[: ds.num_users], emb[ds.num_users : ds.num_users + ds.num_items]
        for method in ("device", "ivf"):
            trace = os.path.join(ROOT, "build", "chip_smoke", f"sweep_{model}_{method}.json")
            args = eval_torch.parser().parse_args(common + [
                "--models", model, "--method", method, "--load-embeddings", path,
                "--trace", trace])
            _zero(modules)
            res = eval_torch.run(args)
            torch.cuda.synchronize()
            launches = {n: modules[n].launches for n in ("topk", "ivf_list_topk")}
            kernel = "topk" if method == "device" else "ivf_list_topk"
            if launches[kernel] == 0:
                fail(f"sweep {model} {method}: no {kernel} launch")
            (rec,) = res["payload"]["results"]
            want = evaluate_recall(ue, ie, train, ds.test_pairs, strategies=("u2i",),
                                   method=method, device="cuda",
                                   ivf=IVFConfig(nlist=64, nprobe=8, seed=0))
            if rec["metrics"] != want:
                fail(f"sweep {model} {method}: report {rec['metrics']} != evaluate_recall {want}")
            hist = res["telemetry"].metrics.summary()["histograms"]["retrieval.search_ns"]
            results.append(rec)
            runs.append({"model": model, "method": method, "metrics": rec["metrics"],
                         "eval_s": rec["eval_s"], "launches": launches,
                         "searches": hist["count"], "search_p50_ms": hist["p50"] / 1e6})
    md = os.path.join(ROOT, "build", "chip_smoke", "sweep.md")
    with open(md, "w") as f:
        f.write(render_recall_report(results) + "\n")
    out = {"phase": "sweep", "dataset": "ub", "train_export_s": train_export_s,
           "exported": [os.path.relpath(p, ROOT) for p in first["exported"]],
           "trained_u2i": {r["model"]: r["metrics"]["u2i"] for r in first["payload"]["results"]},
           "runs": runs, "markdown": os.path.relpath(md, ROOT)}
    emit(out)
    return out


# ------------------------------------------------------ training kernels
def seg_aggr_bwd_phase(torch, ref, seg_mod, paths: dict) -> dict:
    """Every kept call of each training path (``paths``: name -> kept calls)
    against the plain version, bitwise; each recorded shape timed on its
    kept inputs beside the plain version, the library call and the bound,
    with the shares of its rows whose gradient is all zero and whose mask
    counts k = 0 .. F neighbours (zero rows and power-of-two counts skip
    the kernel's division)."""
    fn = seg_mod.seg_aggr_bwd_cuda
    calls, recs = 0, []
    for path, kept in paths.items():
        for g, mask, mode in kept:
            got, want = fn(g, mask, mode), ref.seg_aggr_bwd_ref(g, mask, mode)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"seg_aggr_bwd {mode} {tuple(mask.shape)}: a {path} call is not bitwise "
                     "its plain version")
        calls += len(kept)
        emit({"phase": "kernel", "name": "seg_aggr_bwd", "source": f"{path} path, kept calls",
              "calls": len(kept), "max_abs_err": 0.0})
        for g, mask, mode in first_of_each_shape(kept, lambda c: (tuple(c[1].shape), c[2])):
            (n, f), d = mask.shape, g.shape[1]
            mf = mask.float()
            w = mf / mf.sum(1, keepdim=True).clamp(min=1.0) if mode == "mean" else mf
            kern = measure(lambda: fn(g, mask, mode), 200)
            plain = measure(lambda: ref.seg_aggr_bwd_ref(g, mask, mode), 200)
            # one broadcast product against precomputed per-neighbour weights
            lib = measure(lambda: g[:, None, :] * w[..., None], 200)
            rec = {"phase": "kernel", "name": "seg_aggr_bwd", "source": f"{path} path",
                   "mode": mode, "shape": [n, f, d], "max_abs_err": 0.0,
                   "mask_row_stride": mask.stride(0),
                   "g_zero_row_share": (g == 0).all(1).float().mean().item(),
                   "count_shares": torch.bincount(mask.sum(1), minlength=f + 1).div(n).tolist(),
                   **times(kernel=kern, plain=plain, library=lib)}
            rec["bound_ms"], rec["bound_by"] = bound_ms(n * d * 4 + n * f + n * f * d * 4,
                                                        n * f * d)
            emit(rec)
            recs.append(rec)
    emit({"phase": "kernel", "name": "seg_aggr_bwd", "source": "training paths, kept calls",
          "calls": calls, "max_abs_err": 0.0, "bitwise": True})
    return max(recs, key=lambda r: r["shape"][0] * r["shape"][1])


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
    cloned inputs, untouched rows exactly unchanged, and the kernel re-run
    bitwise equal to the main path's result; then each recorded (table,
    bucket) shape timed, with its real ids."""
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
        if not (torch.equal(tk, c["t1"]) and torch.equal(ak, c["a1"])):
            fail(f"row_adagrad {tuple(t0.shape)}: the re-run is not bitwise the main path's "
                 "result")
    for c in first_of_each_shape(kept, lambda c: (tuple(c["t0"].shape), c["ids"].shape[0])):
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
    return dict(max(recs, key=lambda r: (r["shape"]["N"], r["shape"]["bucket"])),
                max_abs_err=worst)


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
# the MoE, SSM and hybrid paths: OLMoE-1B-7B at full width and depth (6.92 B parameters,
# 13.8 GB in bf16), Mamba2-1.3B at full width and depth, one full-width 8-layer period
# of Jamba-v0.1-52B (about 13 B parameters; the whole model's 104 GB do not fit a card),
# OLMoE cut to 2 layers to train (Adam's f32 state for all 16 would take about 111 GB)
MOE_ARCH, SSM_ARCH, HYBRID_ARCH, MIXTRAL_ARCH = (
    "olmoe-1b-7b", "mamba2-1.3b", "jamba-v0.1-52b", "mixtral-8x22b")
HYBRID_LAYERS = 8
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 2, 10
SSM_CHUNKS_SEQ = 512  # Mamba2's chunked SSD at chunk 256 vs one chunk of 512, in f32
# no capacity drops, as repro's own forward-vs-decode test (tests/test_models.py:109-113):
# at g 512 an expert's C is 512, at g 1 it is 4
MOE_CF_EXACT = 8.0
# routing may differ only at a near-tie of the K-th and (K+1)-th router probabilities
# (ROADMAP C1's rule for top-k): within 1e-5 where the inputs agree to f32 rounding. In
# bf16 the residual stream reaching a router differs between prefill and decode by bf16
# roundings (2^-8 of a value, a few times over a layer), which moves a router logit by up to
# a few 1e-2: there a tie is a log-ratio log(p_K / p_(K+1)) within 2^-4. On an H100 80GB
# HBM3 at 700 W the first layer's differences read log-ratios up to 0.011 (OLMoE) and 0.016
# (a Jamba period); a misrouted token's ratio is anything up to the largest probability's
ROUTE_TIE, ROUTE_TIE_BF16_LOG = 1e-5, 2.0 ** -4
# the reduced Jamba's training, card vs CPU: Adam's first update is lr g / (|g| + 1e-8), so
# an element whose gradient lies within f32 rounding of zero moves by up to lr either
# way; at 1e-5 such an element stays inside the 1e-4 bound (tests/test_torch_lm_blocks_train.py)
LM_BLOCKS_CONF_LR = 1e-5
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
# the backward kernel against attention_bwd_ref on the same inputs, forward output and LSE:
# both sum the same f32 products in other orders. f32: rtol 1e-4 with a floor of 1e-4 of the
# tensor's largest |value| (a training call's dO is the loss's gradient, ~1/(B S), so an
# absolute floor would not scale). bf16: both round the f32 sums once, and one rounding step
# apart is at most 2^-7 of a value, so each row (hd columns) is held to 2^-6 of its largest
# |value|; two summation orders of the plain version read at most 4.9e-3 on the CPU
# (B 1, S 1,024, hd 128, window 256), and a tile dropped reads whole rows wrong. A row
# whose exact gradient cancels to 0 (dq of a query that sees one key: dP - D = 0) holds
# only f32 rounding residue, different in each order, so no row's scale is taken below
# 2^-10 of the tensor's largest |value| (the residue is ~1e-7 of it; an H100 read a row
# scale of 1.0 on such a row, hd 128, window 64, where the whole tensor read 3.3e-4)
FLASH_BWD_RTOL = 1e-4
# the training forward's LSE (m + log l, f32, values ~1e1) against attention_fwd_ref's
# logsumexp: the same f32 logits, the row sum in another order
FLASH_LSE_RTOL = FLASH_LSE_ATOL = 1e-5
# The bf16 kernel rounds P to bf16 before its product and feeds dS as two bf16 parts (hi and
# the rest; the wgmma's operands), which the plain version does not: tests/test_torch_flash.py
# emulates that arithmetic on the CPU and reads at most 7.8e-3 (2^-7: dV's P and the outputs'
# own rounding) against the plain version at its backward cases, at smollm's training layout
# (S 512) and at starcoder2's hd 128 and 4,096 window, so the bound stands with a margin of 2;
# a 64-key tile dropped at that window's edge, or its mask skipped, reads 0.51 and 0.38, 33x
# and 24x the bound (test_backward_row_bound_catches_window_edge_faults). dS rounded to bf16
# once read 0.060 on dK and 0.022 on dQ at Whisper's decoder at step 1, in the emulation as
# on the card: keys (queries) sharing a large part cancel it exactly in dQ (dK), and one
# rounding of dS leaves it in (tests/test_torch_whisper.py::
# test_bf16_backward_arithmetic_holds_shared_parts). On the card each bf16 call is also
# held to the emulation run on its own inputs (bwd_kernel_emulation, the same bound), and the
# emulation's distance to the plain version is recorded beside the kernel's: where the
# kernel reads more than on random data, that reading says whether the arithmetic or the
# kernel makes the difference
FLASH_BWD_BF16_ROW_REL = 2.0 ** -6
FLASH_BWD_ROW_FLOOR = 2.0 ** -10
FLASH_SYNTHETIC = (  # ((B, S, H, K, hd), dtype, causal, window)
    ((2, 256, 4, 2, 64), "float32", True, None),
    ((2, 256, 4, 2, 64), "float32", False, None),
    ((2, 200, 4, 2, 64), "float32", True, None),  # a tail tile
    ((1, 512, 14, 2, 64), "float32", True, None),  # qwen2-0.5b's G 7
    ((2, 256, 4, 2, 32), "float32", True, None),  # the f32 kernel at hd 32
    ((2, 200, 4, 2, 128), "float32", True, 64),  # and at hd 128: a tail tile, a window's edge
    ((1, 8192, 36, 4, 128), "bfloat16", True, 4096),  # starcoder2-7b's layout and window
)


def _rel(a, b) -> float:
    """max |a - b| / max |b| in f32: repro's forward-vs-decode measure."""
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max()).item()


def _row_rel(got, want, floor: float = 0.0) -> float:
    """max over rows (every index but the last) of max |got - want| over the
    row's hd columns / max |want| over them, in f32; with ``floor``, no
    row's scale is taken below ``floor`` times the largest |want|."""
    g, w = got.float(), want.float()
    scale = w.abs().amax(-1).clamp_min(max(1e-30, floor * w.abs().max().item()))
    return ((g - w).abs().amax(-1) / scale).max().item()


def flash_bwd_ok(got, want) -> bool:
    """The backward kernel's output ``got`` within its tolerance of the
    plain version's ``want`` (FLASH_BWD_RTOL, FLASH_BWD_BF16_ROW_REL)."""
    import torch

    if got.dtype == torch.bfloat16:
        return _row_rel(got, want, FLASH_BWD_ROW_FLOOR) <= FLASH_BWD_BF16_ROW_REL
    return torch.allclose(got, want, rtol=FLASH_BWD_RTOL,
                          atol=FLASH_BWD_RTOL * want.abs().max().item())


def bwd_kernel_emulation(q, k, v, o, lse, do, causal=True, window=None, band=None,
                         ds_split=True):
    """The bf16 backward kernel's arithmetic (``flash_bwd_tiles_wgmma`` in
    ``csrc/flash_attn_bwd.cu``) in plain torch, on the inputs' device, one
    query head at a time: from (B, S, H, hd) bf16 q, k, v, o, dO and the
    forward's f32 lse, D = rowsum(dO o O) in f32; S and dP in f32 from the
    bf16 products; P = exp2(S scale log2 e - lse log2 e) in the band, else
    0; dS = P o (dP - D); P rounded to bf16 before its product, dS split
    into hi = bf16(dS) and lo = bf16(dS - hi), each multiplied (the wgmmas'
    register operands), the products summed in f32; each query
    head's dK and dV, then the G partials summed in order g = 0 .. G-1 (the
    sum pass; a grid the kernel splits adds more partials, in another
    order); every output rounded to bf16 once, dQ and dK after the scale.
    ``band``, an (Sq, Skv) bool tensor, replaces the causal / window band
    (a fault to inject); ``ds_split=False`` rounds dS to bf16 once instead
    (the arithmetic before the split)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref

    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    ok = ref._band(Sq, Skv, causal, window, 0, q.device) if band is None else band
    c = float(np.float32(np.log2(np.e) / np.sqrt(hd)))
    log2e = float(np.float32(np.log2(np.e)))
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    dd = (do.float() * o.float()).sum(-1)  # (B, Sq, H)
    dq = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.bfloat16, device=q.device)
    dv = torch.empty_like(dk)
    for b in range(B):
        for kh in range(K):
            kf, vf = k[b, :, kh].float(), v[b, :, kh].float()
            for g in range(G):
                h = kh * G + g
                qf, dof = q[b, :, h].float(), do[b, :, h].float()
                lse2 = (lse[b, h].float() * log2e)[:, None]
                p = torch.where(ok, torch.exp2((qf @ kf.T) * c - lse2), 0.0)
                ds = p * (dof @ vf.T - dd[b, :, h, None])
                pb, dsh = p.bfloat16().float(), ds.bfloat16().float()
                dsl = (ds - dsh).bfloat16().float() if ds_split else torch.zeros_like(dsh)
                dq[b, :, h] = (((dsh @ kf) + (dsl @ kf)) * scale).bfloat16()
                pk, pv = (dsh.T @ qf) + (dsl.T @ qf), pb.T @ dof
                sk, sv = (pk, pv) if g == 0 else (sk + pk, sv + pv)
            dk[b, :, kh] = (sk * scale).bfloat16()
            dv[b, :, kh] = sv.bfloat16()
    return dq, dk, dv


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


@contextlib.contextmanager
def moe_routes(torch, moe_mod, routes: list, limit: int = -1):
    """While active, every ``moe_forward`` call (prefill or decode), or the
    first ``limit`` of them, also appends its routing to ``routes``: the
    chosen experts sorted (B, S, K), the gap between the K-th and (K+1)-th
    router probabilities (B, S), which choices were kept (B, S, K), and the
    log of those probabilities' ratio (B, S)."""
    real = moe_mod.moe_forward

    def spy(p, cfg, x):
        if len(routes) == limit:
            return real(p, cfg, x)
        B, S, d = x.shape
        with torch.no_grad():
            r = moe_mod.route(p, cfg, x.reshape(-1, moe_mod.group_size(cfg, S), d))
            top = torch.sort(r.probs, dim=-1, descending=True).values
            K = cfg.top_k
            routes.append((r.top_idx.reshape(B, S, K).sort(-1).values,
                           (top[..., K - 1] - top[..., K]).reshape(B, S),
                           r.kept.reshape(B, S, K),
                           (top[..., K - 1].log() - top[..., K].log()).reshape(B, S)))
        return real(p, cfg, x)

    moe_mod.moe_forward = spy
    try:
        yield
    finally:
        moe_mod.moe_forward = real


@contextlib.contextmanager
def annotated(torch, module, name: str, label: str):
    """Run every call of ``module.name`` inside ``record_function(label)``,
    so that a profile can sum the device time of the kernels it launched."""
    real = getattr(module, name)

    def spy(*args, **kwargs):
        with torch.profiler.record_function(label):
            return real(*args, **kwargs)

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, real)


def _annotated_device_us(prof, label: str) -> float:
    """The device time of the kernels launched inside ``label``'s ranges."""
    return sum(e.device_time_total for e in prof.events()
               if e.name == label and e.device_type.name == "CPU")


def _route_compare(torch, pre: list, dec: list, tie: float, log_ratio: bool = False) -> dict:
    """Prefill's routes (one entry a MoE layer, (B, S, ·)) against decode's
    (S steps of one entry a layer, (B, 1, ·)): the (layer, token) pairs
    whose expert sets differ, per layer, and each difference's gap (the
    smaller of the two paths' K-th minus (K+1)-th probabilities, or with
    ``log_ratio`` the log of their ratio). The first layer with a
    difference sees inputs that differ by rounding only; each of its
    differences must be a near-tie (gap <= ``tie``). Later layers'
    differences may follow from it (a swapped token moves by a whole
    expert's share, and attention spreads it): counted, not gated."""
    col = 3 if log_ratio else 1
    L = len(pre)
    S = pre[0][0].shape[1]
    if len(dec) != L * S:
        fail(f"routing: {len(dec)} decode calls for {L} MoE layers x {S} steps")
    per_layer, max_gap, first = [], 0.0, None
    for layer in range(L):
        d_idx = torch.cat([dec[i * L + layer][0] for i in range(S)], dim=1)
        d_gap = torch.cat([dec[i * L + layer][col] for i in range(S)], dim=1)
        differs = (pre[layer][0] != d_idx).any(-1)
        n = int(differs.sum())
        gaps = torch.minimum(pre[layer][col], d_gap)[differs]
        g = gaps.max().item() if n else 0.0
        per_layer.append(n)
        max_gap = max(max_gap, g)
        if n and first is None:
            first = {"layer": layer, "count": n, "max_gap": g}
    out = {"differences": sum(per_layer), "per_layer": per_layer, "first": first,
           "max_gap": max_gap, "gap": "log ratio" if log_ratio else "probability", "tie": tie}
    if first is not None and first["max_gap"] > tie:
        fail(f"routing: prefill and decode route {first['count']} tokens of MoE layer "
             f"{first['layer']} apart at gaps up to {first['max_gap']} (near-tie bound {tie})")
    return out


def _text_prefill(torch, T, spec, model, tokens):
    """``make_prefill`` on text alone. Qwen2-VL's prefill merges patches;
    its text alone runs the same stack at M-RoPE ids (i, i, i), which are
    what its decode step gives position i."""
    if spec.kind != "vlm":
        return spec.make_prefill()(model, {"tokens": tokens})
    B, S = tokens.shape
    pos = torch.arange(S, dtype=torch.int32, device=tokens.device)[None, :, None].expand(B, S, 3)
    with torch.no_grad():
        x, _ = T.hidden_states(model, spec.lm, tokens, positions=pos)
        return T._mask_padded_vocab(spec.lm, x[:, -1, :] @ model.head())


def _prefill_decode(torch, np, T, moe_mod, spec, model, prompts):
    """The last prefill logits and the last of S decode steps on the same
    prompts, with each path's MoE routes."""
    pre, dec = [], []
    with moe_routes(torch, moe_mod, pre):
        full = _text_prefill(torch, T, spec, model, prompts)
    with moe_routes(torch, moe_mod, dec):
        last, dec_s = _decode_all(torch, T, model, spec.lm, prompts)
    return full, last, dec_s, pre, dec


def lm_consistency(torch, np, spec, model, prompts, phase: str, in_place_f32=False,
                   gate_bf16=True) -> dict:
    """Prefill vs decode on ``prompts`` (relative max of the last logits,
    ``repro``'s measure): in the model's bf16, and with the same weights in
    f32 (a copy, or the model itself turned f32 where a copy would not fit
    beside it), beside each bf16 path's distance to f32. A MoE arch runs at
    capacity factor ``MOE_CF_EXACT`` (no drops, as ``repro``'s own test) and
    its routing differences are counted (``_route_compare``); its error is
    gated only where no token routes apart (else printed ungated). Without
    ``gate_bf16`` the bf16 figures are printed, not gated (Mamba2's 48
    layers of bf16 state: ROADMAP C7)."""
    import copy

    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as T

    cfg = spec.lm
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               capacity_factor=MOE_CF_EXACT))
        spec = dataclasses.replace(spec, lm=cfg)
    V = cfg.vocab  # the padded vocabulary's logits are -1e30 in every path
    full, dec, dec_s, pre_r, dec_r = _prefill_decode(torch, np, T, moe_mod, spec, model, prompts)
    m32 = model.float() if in_place_f32 else copy.deepcopy(model).float()
    spec32 = dataclasses.replace(spec, lm=dataclasses.replace(cfg, dtype="float32"))
    full32, dec32, _, pre32, dec32_r = _prefill_decode(torch, np, T, moe_mod, spec32, m32,
                                                       prompts)
    del m32
    full, dec, full32, dec32 = (t[..., :V] for t in (full, dec, full32, dec32))
    cons = {"phase": phase, "arch": spec.arch_id, "layers": cfg.n_layers,
            "prompts": list(prompts.shape),
            "f32_prefill_vs_decode": _rel(dec32, full32),
            "bf16_prefill_vs_decode": _rel(dec, full),
            "bf16_prefill_vs_f32": _rel(full, full32), "bf16_decode_vs_f32": _rel(dec, full32),
            "f32_bound": LM_F32_REL, "bf16_bound": LM_BF16_REL,
            "decode_steps_per_s": prompts.shape[1] / dec_s}
    gated = {"f32": True, "bf16": gate_bf16}
    if cfg.moe is not None:
        cons["capacity_factor"] = MOE_CF_EXACT
        cons["routing_f32"] = _route_compare(torch, pre32, dec32_r, ROUTE_TIE)
        cons["routing_bf16"] = _route_compare(torch, pre_r, dec_r, ROUTE_TIE_BF16_LOG,
                                              log_ratio=True)
        gated = {d: gated[d] and cons[f"routing_{d}"]["differences"] == 0 for d in gated}
    cons["gated"] = gated
    emit(cons)
    for dtype, bound in (("f32", LM_F32_REL), ("bf16", LM_BF16_REL)):
        if gated[dtype] and not cons[f"{dtype}_prefill_vs_decode"] < bound:
            fail(f"{phase}: {dtype} prefill vs decode differ by "
                 f"{cons[f'{dtype}_prefill_vs_decode']} (bound {bound})")
    for k in ("f32_prefill_vs_decode", "bf16_prefill_vs_decode", "bf16_prefill_vs_f32",
              "bf16_decode_vs_f32"):
        if not np.isfinite(cons[k]):
            fail(f"{phase}: {k} is not finite")
    return cons


def lm_prefill(torch, np, fa_mod, arch: str, batch: int, seq: int, phase: str,
               layers: int = 0, draw_on_device: bool = False,
               profile_required: bool = True) -> dict:
    """The prefill through ``examples/serve_lm_torch.py``'s ``run`` at full
    width (``make_prefill`` on B x S tokens from ``default_rng(0)``, with
    Qwen2-VL's patch or Whisper's frame embeddings drawn after them, a
    warm-up and 5 timed forwards; ``flash_attention`` launches zeroed
    before, read after, one a forward per attention layer (Whisper: each
    encoder and decoder layer); the first call of each shape recorded),
    then one profiled forward: its device time, the flash kernel's share
    and, for a MoE arch, the share of the MoE layers (routing, dispatch,
    the expert einsums and the combine), for Whisper the encoder's, beside
    the forward's host wall. A MoE arch also records each layer's input in
    the first timed forward, and the share of token choices its capacity
    drops. Without ``profile_required`` a profile that keeps too few flash
    records in ``CUPTI_TRIES`` tries is reported with its counts and no
    device times, instead of failing the run. Returns the record with the
    spec, model, the prefill's batch and recorded inputs."""
    import serve_lm_torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import whisper as whisper_mod

    argv = ["--arch", arch, "--batch", str(batch), "--prefill-len", str(seq),
            "--tokens", "0", "--seed", "0", "--layers", str(layers)]
    args = serve_lm_torch.parser().parse_args(argv + (["--draw-on-device"] if draw_on_device
                                                      else []))
    calls: list = []
    routes: list = []  # the warm-up forward's, so that no timed forward routes twice
    first_moe: dict = {}  # the first MoE call's (p, cfg, x): layer 0's input
    full = get_arch(arch)
    n_moe = 0 if full.kind == "whisper" else sum(
        f == "moe" for _, f in full.lm.block_list()[:layers or None])
    fa_mod.launches = 0
    t0 = time.perf_counter()
    with recording(ops, "flash_attention", calls), moe_routes(torch, moe_mod, routes, n_moe):
        restore = _keeping_first(moe_mod, "moe_forward", lambda a: 0, first_moe)
        try:
            res = serve_lm_torch.run(args)
        finally:
            restore()
    wall = time.perf_counter() - t0
    launches = fa_mod.launches
    calls = first_of_each_shape(calls, _flash_key)
    spec, model = res["spec"], res["model"]
    whisper = spec.kind == "whisper"
    cfg = spec.whisper if whisper else spec.lm
    n_attn = 2 * cfg.n_layers if whisper else sum(m == "attn" for m, _ in cfg.block_list())
    if launches != n_attn * res["prefill_forwards"]:
        fail(f"{phase}: {launches} flash_attention launches in {res['prefill_forwards']} "
             f"forwards of {n_attn} attention layers")
    last = res["prefill_last_logits"]
    if last.shape != (batch, cfg.vocab_padded) or not torch.isfinite(last).all():
        fail(f"{phase}: last logits {tuple(last.shape)} not finite or misshapen")
    out = {"phase": phase, "arch": spec.arch_id, "batch": batch, "seq": seq,
           "layers": cfg.n_layers, "dtype": cfg.dtype,
           "params": sum(p.numel() for p in model.parameters()),
           "weights_drawn_on": "card" if draw_on_device else "cpu", "run_s": wall,
           "launches": {"flash_attention": launches}, "forwards": res["prefill_forwards"],
           "launches_per_forward": launches / res["prefill_forwards"],
           "prefill_s": res["prefill_s"], "prefill_tokens_per_s": res["prefill_tokens_per_s"]}
    pbatch = res["prefill_batch"]
    if spec.kind == "vlm":
        out["patches"] = spec.n_patches
    if whisper:
        out["audio_frames"] = pbatch["audio_embeds"].shape[1]
    if n_moe:
        kept = torch.cat([r[2].flatten() for r in routes]).float()
        out["capacity_factor"] = cfg.moe.capacity_factor
        out["dropped_choice_share"] = 1.0 - kept.mean().item()

    prefill = spec.make_prefill()
    labels = ("moe_forward", "whisper_encode")
    kept = []
    for _ in range(CUPTI_TRIES):  # until the profile keeps the kernel's records
        torch.cuda.synchronize()
        with annotated(torch, moe_mod, "moe_forward", labels[0]), annotated(
                torch, whisper_mod, "encode", labels[1]), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prefill(model, pbatch)
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in labels]
        # flash_fwd_kernel (f32) and flash_fwd_kernel_wgmma (bf16)
        flash = [e for e in dev if "flash_fwd_kernel" in e.key]
        kept.append(sum(e.count for e in flash))
        if kept[-1] == n_attn:
            break
    else:
        if profile_required:
            fail(f"{phase}: {CUPTI_TRIES} profiles of the forward kept {kept} flash_attention "
                 f"records of {n_attn}")
        out.update(profile_flash_records_kept=kept, profile_flash_records_launched=n_attn)
        emit(out)
        out.update(spec=spec, model=model, toks=pbatch["tokens"], batch_inputs=pbatch,
                   calls=calls, first_moe=first_moe.get(0))
        return out
    total_us = sum(e.self_device_time_total for e in dev)
    flash_us = sum(e.self_device_time_total for e in flash)
    # the forward's device time beside its host wall (the median timed
    # forward): the larger of the two sets the prefill's pace
    host_ms = statistics.median(res["prefill_s"]) * 1e3
    out.update(forward_device_ms=total_us / 1e3, flash_device_ms=flash_us / 1e3,
               flash_share=flash_us / total_us, forward_host_ms=host_ms,
               paced_by="host" if host_ms > total_us / 1e3 else "card")
    if n_moe:
        moe_us = _annotated_device_us(prof, labels[0])
        out.update(moe_device_ms=moe_us / 1e3, moe_share=moe_us / total_us)
    if whisper:
        enc_us = _annotated_device_us(prof, labels[1])
        out.update(encoder_device_ms=enc_us / 1e3, decoder_device_ms=(total_us - enc_us) / 1e3,
                   encoder_share=enc_us / total_us)
    emit(out)
    out.update(spec=spec, model=model, toks=pbatch["tokens"], batch_inputs=pbatch, calls=calls,
               first_moe=first_moe.get(0))
    return out


def lm_serving(torch, np, spec, model, phase: str, requests: int = 16) -> dict:
    """``BatchedServer`` (batch 8, 32 new tokens, cache 256) twice on
    ``requests`` requests of 8-64 tokens from ``default_rng(0)``: greedy
    outputs equal across the runs, and the tokens the requests hold per
    second. (The smollm, OLMoE and Mamba2 paths serve 8, one batch, since the
    Qwen2-VL and Whisper phases took the run near its time limit.)"""
    from repro_torch.serve import BatchedServer, ServeConfig

    cfg = spec.lm
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).tolist()
               for n in rng.integers(8, 65, size=requests)]
    scfg = ServeConfig(batch_size=8, max_new_tokens=32, cache_len=256)
    outs, times = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(BatchedServer(spec, model, scfg).generate(prompts))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if outs[0] != outs[1]:
        fail(f"{phase}: two greedy runs of the same requests differ")
    if any(len(o) != 32 or not all(0 <= t < cfg.vocab for t in o) for o in outs[0]):
        fail(f"{phase}: an output is not 32 in-vocabulary tokens")
    steps = sum(max(len(p) for p in prompts[lo:lo + 8]) + 31 for lo in range(0, requests, 8))
    # the tokens the requests hold: each prompt and what it generated (a
    # shorter prompt's row repeats its last token until the batch's longest
    # prompt is in, and those repeats are not counted), over both runs' wall
    served = sum(len(p) + len(o) for p, o in zip(prompts, outs[0]))
    generated = sum(len(o) for o in outs[0])
    serve = {"phase": phase, "arch": spec.arch_id, "requests": requests, "batch": 8,
             "new_tokens": 32, "prompt_lens": [len(p) for p in prompts], "decode_steps": steps,
             "serve_s": times, "identical": True,
             "decode_tokens_per_s": 2 * served / sum(times),
             "generated_tokens_per_s": 2 * generated / sum(times),
             "first_outputs": outs[0][:2]}
    emit(serve)
    return serve


def lm_card_vs_cpu(torch, np, arch: str, phase: str) -> dict:
    """The reduced ``arch`` in f32 from the port's seed-0 init, on the card
    vs the CPU under deterministic algorithms: the forward (Qwen2-VL's with
    its patches merged, at 3-D M-RoPE ids) and 16 decode steps to
    rtol/atol ``LM_RTOL`` / ``LM_ATOL``."""
    import copy

    from repro_torch.configs import get_arch
    from repro_torch.models import qwen2_vl as vlm_mod
    from repro_torch.models import transformer as T

    red = get_arch(arch, reduced=True)
    m_cpu = red.init_params(torch.Generator().manual_seed(0), "cpu")
    m_gpu = copy.deepcopy(m_cpu).to("cuda")
    rng = np.random.default_rng(1)
    t_cpu = torch.from_numpy(rng.integers(0, red.lm.vocab, size=(2, 64)))
    patches = (torch.from_numpy((rng.normal(size=(2, red.n_patches, red.lm.d_model)) * 0.02)
                                .astype(np.float32)) if red.kind == "vlm" else None)

    def forward(m, toks, p):
        if p is None:
            return T.forward(m, red.lm, toks)[0]
        x, pos = vlm_mod.vlm_forward_inputs(m, red.lm, toks, p, red.grid_hw)
        return T.forward(m, red.lm, inputs_embeds=x, positions=pos)[0]

    torch.use_deterministic_algorithms(True)
    try:
        with torch.no_grad():
            got = forward(m_gpu, t_cpu.cuda(), None if patches is None else patches.cuda()).cpu()
            want = forward(m_cpu, t_cpu, patches)
        if not torch.allclose(got, want, rtol=LM_RTOL, atol=LM_ATOL):
            fail(f"{phase}: forward logits differ by {(got - want).abs().max().item()}")
        diffs = [got - want]
        c_cpu = T.init_cache(red.lm, 2, 16, "cpu")
        c_gpu = T.init_cache(red.lm, 2, 16, "cuda")
        for i in range(16):
            a, c_cpu = T.decode_step(m_cpu, red.lm, c_cpu, t_cpu[:, i:i + 1])
            b, c_gpu = T.decode_step(m_gpu, red.lm, c_gpu, t_cpu[:, i:i + 1].cuda())
            if not torch.allclose(b.cpu(), a, rtol=LM_RTOL, atol=LM_ATOL):
                fail(f"{phase}: decode step {i} logits differ")
            diffs.append(b.cpu() - a)
    finally:
        torch.use_deterministic_algorithms(False)
    conf = {"phase": phase, "arch": red.arch_id, "dtype": red.lm.dtype,
            "tokens": [2, 64], "patches": red.n_patches, "decode_steps": 16,
            "max_abs_diff": max(d.abs().max().item() for d in diffs),
            "rtol": LM_RTOL, "atol": LM_ATOL}
    emit(conf)
    return conf


def lm_path(torch, np, fa_mod) -> dict:
    """The LM substrate's serving side on smollm-135m at full width (random
    weights from the port's init, seed 0): ``lm_prefill`` (B 4 x S 2,048,
    30 ``flash_attention`` launches a forward), prefill vs decode on
    256-token prompts (bf16 and the same weights in f32), ``BatchedServer``
    twice on 8 requests, and the reduced model in f32 on the card vs the
    CPU."""
    out = lm_prefill(torch, np, fa_mod, LM_ARCH, LM_BATCH, LM_SEQ, "lm prefill")
    spec, model, toks = out.pop("spec"), out.pop("model"), out.pop("toks")
    out.pop("first_moe")
    cons = lm_consistency(torch, np, spec, model, toks[:, :256].contiguous(), "lm consistency")
    serve = lm_serving(torch, np, spec, model, "lm serving", requests=8)
    conf = lm_card_vs_cpu(torch, np, LM_ARCH, "lm card vs cpu")
    out.update(consistency=cons, serving=serve, card_vs_cpu=conf)
    del model, spec
    return out


# --------------------------------------------------------------- LM training
LM_TRAIN_STEPS, LM_TRAIN_LR = 20, 3e-4
LM_CONF_STEPS = 5  # the reduced model, card vs CPU and card twice
LM_CONF_RTOL = LM_CONF_ATOL = 1e-4  # five f32 Adam steps, other summation orders


def _keeping_first(module, name: str, key_of, kept: dict):
    """Wrap ``module.name`` so that the arguments of its first call of each
    ``key_of(args)`` land in ``kept``; returns the restoring function.
    (``recording`` keeps every call: the training phase's 600 backward
    calls would hold tens of GB of saved activations.)"""
    real = getattr(module, name)

    def spy(*args):
        kept.setdefault(key_of(args), args)
        return real(*args)

    setattr(module, name, spy)
    return lambda: setattr(module, name, real)


def _lm_conformance(torch, np, arch: str, lr: float) -> dict:
    """The reduced ``arch`` in f32, ``LM_CONF_STEPS`` steps of ``launch/train.py``'s
    ``run`` at ``lr`` on the CPU and twice on the card from the same seeded
    weights, under deterministic algorithms."""
    from repro_torch.launch import train as lm_train

    def args(device: str):
        return lm_train.parser().parse_args(
            ["--arch", arch, "--reduced", "--steps", str(LM_CONF_STEPS), "--seed", "1",
             "--lr", str(lr), "--device", device])

    torch.use_deterministic_algorithms(True)
    try:
        cpu, card, again = (lm_train.run(args(d)) for d in ("cpu", "cuda", "cuda"))
    finally:
        torch.use_deterministic_algorithms(False)
    if card["spec"].lm.dtype != "float32":
        fail(f"{arch} training conformance: the reduced model is not f32")
    loss_diff = float(np.max(np.abs(np.subtract(card["losses"], cpu["losses"]))))
    if not np.allclose(card["losses"], cpu["losses"], rtol=LM_CONF_RTOL, atol=LM_CONF_ATOL):
        fail(f"{arch} training conformance: card vs CPU losses differ by {loss_diff}")
    want = cpu["model"].state_dict()
    param_diff = 0.0
    for name, t in card["model"].state_dict().items():
        param_diff = max(param_diff, (t.cpu() - want[name]).abs().max().item())
        if not torch.allclose(t.cpu(), want[name], rtol=LM_CONF_RTOL, atol=LM_CONF_ATOL):
            fail(f"{arch} training conformance: {name} card vs CPU differs")
    twin = again["model"].state_dict()
    if card["losses"] != again["losses"] or any(
            not torch.equal(t, twin[n]) for n, t in card["model"].state_dict().items()):
        fail(f"{arch} training conformance: two same-seed card runs differ")
    return {"arch": card["arch"], "steps": LM_CONF_STEPS, "dtype": "float32", "lr": lr,
            "loss_max_abs_diff": loss_diff, "param_max_abs_diff": param_diff,
            "card_runs_identical": True, "losses_card": card["losses"],
            "rtol": LM_CONF_RTOL, "atol": LM_CONF_ATOL}


def lm_train_phase(torch, np, fa_mod, arch: str, steps: int, phase: str, layers: int = 0,
                   trend_gate: bool = False, profile_required: bool = True,
                   batch: int = LM_BATCH, seq: int = LM_SEQ) -> dict:
    """LM training at full width through ``repro_torch.launch.train``'s
    ``run`` (B ``batch`` x S ``seq``, by default the prefill's 4 x 2,048; lr
    3e-4, seed 0; bf16 weights from the port's init, which Adam turns f32
    at step 1 as ``repro``'s does), cut to ``layers`` if given: launches
    zeroed before and read after each step (per step and microbatch
    ``flash_attention`` one forward per attention layer (Whisper: each
    encoder and decoder layer), twice with remat, and as many backward
    calls of ``bwd_plan``'s launches in the step's dtype), every parameter f32
    after step 1 (a MoE router f32 from the start, its aux loss finite in
    every call), the loss falling: the first step's batch scored again
    after the last step below its first loss (and with ``trend_gate`` the
    last step's loss below the first's; on fresh random batches at random
    init that trend sits inside the batches' spread, ±0.01, for OLMoE's
    50,304-token untied head over 10 steps); tokens/s and the step wall with the bf16
    first step apart; one more step profiled for the flash forward's and
    backward's device time (and the MoE layers' forward and recompute); the
    first backward call of each (shape, dtype) recorded. Without
    ``profile_required`` a profile that keeps too few flash records in
    ``CUPTI_TRIES`` tries is reported with its counts and no flash times,
    instead of failing the run."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.launch import train as lm_train
    from repro_torch.models import moe as moe_mod

    args = lm_train.parser().parse_args(
        ["--arch", arch, "--batch", str(batch), "--seq", str(seq), "--layers", str(layers),
         "--steps", str(steps), "--lr", str(LM_TRAIN_LR), "--seed", "0"])
    per_step, dtypes = [], []
    seen = {"fwd": 0, "bwd": 0}
    auxes: list = []

    def after_step(step, model, loss):
        per_step.append({"fwd": fa_mod.launches - seen["fwd"],
                         "bwd": fa_mod.bwd_launches - seen["bwd"]})
        seen.update(fwd=fa_mod.launches, bwd=fa_mod.bwd_launches)
        dtypes.append(sorted({str(p.dtype).replace("torch.", "") for p in model.parameters()}))

    def aux_spy(p, cfg, x):
        y, aux = real_moe(p, cfg, x)
        auxes.append(aux.detach())
        return y, aux

    kept: dict = {}
    restore = _keeping_first(ops, "flash_attention_bwd", lambda a: (
        tuple(a[0].shape), tuple(a[1].shape), str(a[0].dtype), a[6], a[7]), kept)
    real_moe, moe_mod.moe_forward = moe_mod.moe_forward, aux_spy
    fa_mod.launches = fa_mod.bwd_launches = fa_mod.copies = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        res = lm_train.run(args, after_step=after_step)
    finally:
        restore()
        moe_mod.moe_forward = real_moe
    spec, model = res["spec"], res["model"]
    whisper = spec.kind == "whisper"
    cfg = spec.whisper if whisper else spec.lm
    launches = {"flash_attention": fa_mod.launches, "flash_attention_bwd": fa_mod.bwd_launches}
    if fa_mod.copies:
        fail(f"{phase}: the flash wrappers copied {fa_mod.copies} f32 operands off 16 bytes; "
             "the model's own q, k, v and dO must need none")
    k_mb = spec.microbatches
    mb = batch // k_mb
    # each microbatch's attention calls: (Sq = Skv, causal)
    if whisper:
        attn_calls = [(cfg.n_audio_frames, False)] * cfg.n_layers + [(seq, True)] * cfg.n_layers
    else:
        attn_calls = [(seq, True)] * sum(m == "attn" for m, _ in cfg.block_list())
    n_attn = len(attn_calls)
    n_moe = 0 if whisper else sum(f == "moe" for _, f in cfg.block_list())

    def want(dtype):
        return {"fwd": k_mb * n_attn * (2 if cfg.remat else 1),
                "bwd": k_mb * sum(fa_mod.bwd_plan(dtype, mb, s_, s_, cfg.n_heads, cfg.n_kv,
                                                  cfg.head_dim)["launches"]
                                  for s_, _ in attn_calls)}

    wants = [want(getattr(torch, cfg.dtype) if i == 0 else torch.float32)
             for i in range(steps)]
    if per_step != wants:
        fail(f"{phase}: launches a step {per_step}, want {wants} (attention layers "
             f"{n_attn}, remat {cfg.remat})")
    if cfg.dtype != "bfloat16" or dtypes[0] != ["float32"]:
        fail(f"{phase}: parameter dtypes after step 1 {dtypes[0]} (config {cfg.dtype}); "
             "repro's Adam turns every bf16 parameter f32 at step 1")
    if whisper and res["init_dtypes"].get("enc_pos") != torch.bfloat16:
        fail(f"{phase}: enc_pos is not a bf16 parameter before step 1 (repro trains it)")
    losses = res["losses"]
    first = lm_train.synth_batch(np.random.default_rng(int(args.seed)), spec, batch, seq,
                                 "cuda")  # run's first batch: its stream's first draw
    with torch.no_grad():
        first_after = float(spec.make_train_loss()(model, first))
    if not (np.all(np.isfinite(losses)) and first_after < losses[0]
            and (losses[-1] < losses[0] or not trend_gate)):
        fail(f"{phase}: the loss did not fall: {losses}; the first batch after "
             f"{steps} steps {first_after}")
    tokens = batch * seq
    f32_s = res["step_s"][1:]
    out = {"phase": phase, "arch": spec.arch_id, "layers": cfg.n_layers, "batch": batch,
           "seq": seq, "steps": steps, "lr": LM_TRAIN_LR, "config_dtype": cfg.dtype,
           "remat": cfg.remat, "microbatches": spec.microbatches,
           "params": sum(p.numel() for p in model.parameters()),
           "dtypes_after_step": dtypes[:2], "losses": losses,
           "first_batch_loss_after": first_after,
           "launches": launches, "launches_per_step": wants[-1],
           "bwd_calls_per_step": k_mb * n_attn,
           "step_s": res["step_s"],
           "bf16_step_s": res["step_s"][0], "f32_step_s_median": statistics.median(f32_s),
           "tokens_per_s": res["tokens_per_s"],
           "f32_tokens_per_s": tokens * len(f32_s) / sum(f32_s),
           "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}
    if n_moe:
        routers = {n: str(d).replace("torch.", "") for n, d in res["init_dtypes"].items()
                   if n.endswith(".router")}
        if len(routers) != n_moe or set(routers.values()) != {"float32"}:
            fail(f"{phase}: router dtypes before step 1 {routers}; a bf16 model keeps them f32")
        aux = torch.stack(auxes).float()
        # each MoE layer's forward every step (a remat recompute stops once it has rebuilt
        # what the backward needs, before the MoE returns: torch's checkpoint early stop)
        if len(auxes) != n_moe * steps or not torch.isfinite(aux).all():
            fail(f"{phase}: {len(auxes)} MoE aux losses in {steps} steps, or not all finite")
        out.update(router_dtype_at_init="float32", aux_calls=len(auxes),
                   aux_min=aux.min().item(), aux_max=aux.max().item())

    # one more (f32) step profiled: the flash kernels' share of its device time
    step_batch = lm_train.synth_batch(res["rng"], spec, batch, seq, "cuda")
    state = res["opt_state"]
    for _ in range(CUPTI_TRIES):  # until the profile keeps every flash record
        with annotated(torch, moe_mod, "moe_forward", "moe_forward"), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model, state, loss = res["step_fn"](model, state, step_batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.key != "moe_forward"]
        fwd = [e for e in dev if "flash_fwd_kernel" in e.key]
        bwd = [e for e in dev if "flash_bwd_" in e.key]
        records = {"fwd": sum(e.count for e in fwd), "bwd": sum(e.count for e in bwd)}
        if records == wants[-1]:
            break
    else:
        if profile_required:
            fail(f"{phase}: {CUPTI_TRIES} profiles of a step kept {records} flash kernel "
                 f"records of {wants[-1]} (the last try)")
    total_us = sum(e.self_device_time_total for e in dev)
    out["profiled_step"] = {"wall_ms": wall * 1e3, "device_ms": total_us / 1e3,
                            "flash_records_kept": records, "flash_records_launched": wants[-1]}
    if records == wants[-1]:
        out["profiled_step"].update(
            flash_fwd_ms=sum(e.self_device_time_total for e in fwd) / 1e3,
            flash_bwd_ms=sum(e.self_device_time_total for e in bwd) / 1e3,
            flash_bwd_by_kernel_ms={e.key: e.self_device_time_total / 1e3 for e in bwd},
            flash_share=sum(e.self_device_time_total for e in fwd + bwd) / total_us)
    if n_moe:
        out["profiled_step"]["moe_fwd_and_recompute_ms"] = _annotated_device_us(
            prof, "moe_forward") / 1e3
    out["bwd_calls"] = [{"shape": list(k[0]), "kv_shape": list(k[1]), "dtype": k[2],
                         "causal": k[3], "window": k[4]} for k in kept]
    emit(out)
    out["bwd_calls"] = list(kept.values())
    del model, res, state
    return out


def lm_training(torch, np, fa_mod) -> dict:
    """LM training on smollm-135m at full width (``lm_train_phase``, 20
    steps), then the reduced model's conformance (lr 3e-4)."""
    out = lm_train_phase(torch, np, fa_mod, LM_ARCH, LM_TRAIN_STEPS, "lm training",
                         trend_gate=True)
    out["conformance"] = _lm_conformance(torch, np, LM_ARCH, LM_TRAIN_LR)
    emit({"phase": "lm training conformance", **out["conformance"]})
    return out


def moe_layer_checks(torch, np, p, cfg, x, phase: str) -> dict:
    """One MoE layer alone on its recorded prefill input ``x`` (B, S, d):
    prefill grouping against groups of one token (decode's) at capacity
    factor ``MOE_CF_EXACT`` (no drops in either), in f32 (the same weights)
    and in bf16; then the card against the CPU in f32 on the first group of
    512 tokens at the config's own capacity (drops included). Rows whose
    routing (experts, and slots kept) agrees are held to rtol/atol
    ``LM_RTOL`` in f32 and to ``LM_BF16_REL`` of each row's largest |value|
    in bf16; every other row must route apart at a near-tie (the gap
    between the K-th and (K+1)-th router probabilities <= ``ROUTE_TIE``),
    or lie in a group where such a near-tie moved the slots."""
    import copy

    from repro_torch.models import moe as moe_mod

    cf8 = dataclasses.replace(cfg, capacity_factor=MOE_CF_EXACT)
    g1 = dataclasses.replace(cf8, group_size=1)
    B, S, d = x.shape
    K = cfg.top_k

    def routing(pm, c, xs):
        """Per token: the chosen experts and the kept ones (E where dropped),
        each sorted, and the K-th minus (K+1)-th probability."""
        r = moe_mod.route(pm, c, xs.reshape(-1, moe_mod.group_size(c, xs.shape[1]), d))
        top = torch.sort(r.probs, dim=-1, descending=True).values
        kept = torch.where(r.kept, r.top_idx, cfg.num_experts)
        return (r.top_idx.sort(-1).values.reshape(-1, K), kept.sort(-1).values.reshape(-1, K),
                (top[..., K - 1] - top[..., K]).reshape(-1))

    def run(pm, c, xs, chunk=None):
        """y (tokens, d) and its routing; ``chunk`` tokens a call (groups of
        one need (E, tokens, 4, d) expert inputs: at OLMoE's width 1 GiB
        of f32 a 512 tokens)."""
        parts = [xs] if chunk is None else list(xs.reshape(-1, chunk, d).split(1))
        ys, rs = [], []
        for xp in parts:
            ys.append(moe_mod.moe_forward(pm, c, xp)[0].reshape(-1, d))
            rs.append(routing(pm, c, xp))
        return torch.cat(ys), [torch.cat(t) for t in zip(*rs)]

    def compare(ya, ra, yb, rb, group: int, dtype: str, what: str) -> dict:
        same = (ra[0] == rb[0]).all(-1) & (ra[1] == rb[1]).all(-1)
        diff = ~same
        tie = diff & ((ra[0] != rb[0]).any(-1)) & (torch.minimum(ra[2], rb[2]) <= ROUTE_TIE)
        tie_groups = tie.reshape(-1, group).any(-1, keepdim=True).expand(-1, group).reshape(-1)
        unexplained = diff & ~tie & ~tie_groups
        if unexplained.any():
            fail(f"{phase} {what}: {int(unexplained.sum())} tokens route apart away from any "
                 f"near-tie (gap <= {ROUTE_TIE})")
        a, b = ya[same].float(), yb[same].float()
        err = (a - b).abs().max().item() if len(a) else 0.0
        row = ((a - b).abs().amax(-1) / b.abs().amax(-1).clamp_min(1e-30)).max().item() \
            if len(a) else 0.0
        ok = (torch.allclose(a, b, rtol=LM_RTOL, atol=LM_ATOL) if dtype == "float32"
              else row <= LM_BF16_REL)
        if not ok:
            fail(f"{phase} {what}: rows routed alike differ by {err} (row-scaled {row})")
        return {"tokens": int(same.numel()), "routed_apart": int(diff.sum()),
                "near_ties": int(tie.sum()), "max_abs_err": err, "row_rel_err": row}

    out = {"phase": phase, "input": list(x.shape), "input_dtype": str(x.dtype)[6:],
           "top_k": K, "experts": cfg.num_experts}
    with torch.no_grad():
        for dtype in ("float32", "bfloat16"):
            pm = copy.deepcopy(p).to(getattr(torch, dtype))
            pm.router.data = p.router.data.float()  # the router stays f32
            xs = x.to(getattr(torch, dtype))
            ya, ra = run(pm, cf8, xs)
            yb, rb = run(pm, g1, xs, chunk=512)
            out[f"prefill_vs_g1_{dtype}"] = compare(
                ya, ra, yb, rb, moe_mod.group_size(cf8, S), dtype, f"prefill groups vs g 1 {dtype}")
            del pm, ya, yb
        p32 = copy.deepcopy(p).float()
        xg = x[:1, :cfg.group_size].float()
        ya, ra = run(p32, cfg, xg)
        p_cpu = copy.deepcopy(p32).cpu()
        yb, rb = run(p_cpu, cfg, xg.cpu())
        out["card_vs_cpu_float32"] = compare(
            ya.cpu(), [t.cpu() for t in ra], yb, rb, cfg.group_size, "float32", "card vs CPU")
        out["card_vs_cpu_float32"]["dropped_choice_share"] = (
            ra[1] == cfg.num_experts).float().mean().item()
    emit(out)
    return out


def lm_moe(torch, np, fa_mod) -> dict:
    """``lm_moe``: OLMoE-1B-7B at full width and depth (16 layers, 64
    experts top-8, bf16; weights drawn on the card from seed 0):
    ``lm_prefill`` (B 4 x S 2,048, 16 ``flash_attention`` launches a
    forward, the MoE share, the capacity's drop share), layer 0 alone
    (``moe_layer_checks``), prefill vs decode on 4 prompts of 256 tokens
    (``lm_consistency``) and ``BatchedServer`` twice (``lm_serving``)."""
    out = lm_prefill(torch, np, fa_mod, MOE_ARCH, LM_BATCH, LM_SEQ, "lm_moe prefill",
                     draw_on_device=True)
    spec, model, toks = out.pop("spec"), out.pop("model"), out.pop("toks")
    p0, cfg0, x0 = out.pop("first_moe")
    out["layer"] = moe_layer_checks(torch, np, p0, cfg0, x0, "lm_moe layer")
    del x0
    out["consistency"] = lm_consistency(torch, np, spec, model, toks[:, :256].contiguous(),
                                        "lm_moe consistency")
    out["serving"] = lm_serving(torch, np, spec, model, "lm_moe serving", requests=8)
    del model, spec, p0
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ssm_chunks(torch, np, spec, model, prompts, phase: str) -> dict:
    """The chunked SSD's carry across chunks at full width, in f32 (a copy
    of the weights): every position's final hidden state with chunks of 256
    against one chunk of ``prompts``' length, held to ``LM_F32_REL``
    (``repro``'s tests/test_models.py TestMamba2.test_chunk_boundaries_invisible;
    prefill vs decode runs 256 tokens, one chunk)."""
    import copy

    from repro_torch.models import transformer as T

    m32 = copy.deepcopy(model).float()
    cfg = dataclasses.replace(spec.lm, dtype="float32")
    one = dataclasses.replace(cfg, mamba=dataclasses.replace(cfg.mamba, chunk=prompts.shape[1]))
    with torch.no_grad():
        a = T.hidden_states(m32, cfg, prompts)[0]
        b = T.hidden_states(m32, one, prompts)[0]
    del m32
    out = {"phase": phase, "prompts": list(prompts.shape), "chunk": cfg.mamba.chunk,
           "chunks": prompts.shape[1] // cfg.mamba.chunk, "rel": _rel(a, b), "bound": LM_F32_REL}
    emit(out)
    if not out["rel"] < LM_F32_REL:
        fail(f"{phase}: chunks of {cfg.mamba.chunk} and one chunk differ by {out['rel']}")
    return out


def lm_ssm(torch, np, fa_mod) -> dict:
    """``lm_ssm``: Mamba2-1.3B at full width and depth (48 layers, bf16;
    weights drawn on the CPU from seed 0, so a CPU can rebuild them):
    ``lm_prefill`` (B 4 x S 2,048, no flash launch), chunks against one
    chunk on 4 x ``SSM_CHUNKS_SEQ`` tokens (``ssm_chunks``), prefill vs
    decode on 4 prompts of 256 tokens (f32 gated, bf16 printed beside each
    path's distance to f32) and ``BatchedServer`` twice."""
    out = lm_prefill(torch, np, fa_mod, SSM_ARCH, LM_BATCH, LM_SEQ, "lm_ssm prefill")
    spec, model, toks = out.pop("spec"), out.pop("model"), out.pop("toks")
    out.pop("first_moe")
    out["chunks"] = ssm_chunks(torch, np, spec, model, toks[:, :SSM_CHUNKS_SEQ].contiguous(),
                               "lm_ssm chunks")
    out["consistency"] = lm_consistency(torch, np, spec, model, toks[:, :256].contiguous(),
                                        "lm_ssm consistency", gate_bf16=False)
    out["serving"] = lm_serving(torch, np, spec, model, "lm_ssm serving", requests=8)
    del model, spec
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_hybrid(torch, np, fa_mod) -> dict:
    """``lm_hybrid``: Jamba-v0.1-52B at full width, depth cut to one 8-layer
    period (``HYBRID_LAYERS``: Mamba2 and attention mixers, dense and MoE
    ffns; the whole model's 104 GB of bf16 weights do not fit one card;
    weights drawn on the card from seed 0): ``lm_prefill`` (B 1 x S 2,048,
    one ``flash_attention`` launch a forward), then prefill vs decode on 4
    prompts of 256 tokens, the f32 side on the model itself turned f32 (a
    53 GB f32 copy beside the bf16 one would not fit)."""
    out = lm_prefill(torch, np, fa_mod, HYBRID_ARCH, 1, LM_SEQ, "lm_hybrid prefill",
                     layers=HYBRID_LAYERS, draw_on_device=True)
    spec, model = out.pop("spec"), out.pop("model")
    out.pop("toks"), out.pop("first_moe")
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, spec.lm.vocab, size=(4, 256))).to("cuda")
    out["consistency"] = lm_consistency(torch, np, spec, model, prompts, "lm_hybrid consistency",
                                        in_place_f32=True)
    del model, spec
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_moe_training(torch, np, fa_mod) -> dict:
    """``lm_moe_training``: OLMoE at full width, depth cut to
    ``MOE_TRAIN_LAYERS`` (Adam's f32 state for all 16 layers would take
    about 111 GB), ``MOE_TRAIN_STEPS`` steps of ``lm_train_phase``."""
    out = lm_train_phase(torch, np, fa_mod, MOE_ARCH, MOE_TRAIN_STEPS, "lm_moe_training",
                         layers=MOE_TRAIN_LAYERS, profile_required=False)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_reduced(torch, np) -> dict:
    """The reduced Jamba period and Mixtral (its sliding-window MoE) in f32,
    card vs CPU (``lm_card_vs_cpu``), and the reduced Jamba's training
    conformance at ``LM_BLOCKS_CONF_LR``."""
    out = {arch: lm_card_vs_cpu(torch, np, arch, f"{arch} card vs cpu")
           for arch in (HYBRID_ARCH, MIXTRAL_ARCH)}
    out["training"] = _lm_conformance(torch, np, HYBRID_ARCH, LM_BLOCKS_CONF_LR)
    emit({"phase": "lm_hybrid training conformance", **out["training"]})
    return out


def lm_blocks_summary(lmoe: dict, lssm: dict, lhyb: dict, lmt: dict, lred: dict) -> dict:
    """The MoE, SSM and hybrid phases' end-to-end numbers for the summary."""
    out = {}
    for name, r in (("lm_moe", lmoe), ("lm_ssm", lssm), ("lm_hybrid", lhyb)):
        c = r["consistency"]
        out[name] = {k: r[k] for k in (
            "arch", "layers", "batch", "seq", "params", "prefill_tokens_per_s",
            "forward_device_ms", "forward_host_ms", "paced_by", "flash_share", "launches",
            "moe_share", "moe_device_ms", "dropped_choice_share") if k in r}
        out[name]["consistency"] = {k: c[k] for k in (
            "f32_prefill_vs_decode", "bf16_prefill_vs_decode", "bf16_prefill_vs_f32",
            "bf16_decode_vs_f32", "gated")}
        for d in ("f32", "bf16"):
            if f"routing_{d}" in c:
                out[name]["consistency"][f"routing_{d}"] = {
                    k: c[f"routing_{d}"][k] for k in ("differences", "first")}
        if "chunks" in r:
            out[name]["chunks_rel"] = r["chunks"]["rel"]
        if "serving" in r:
            out[name].update({k: r["serving"][k] for k in ("decode_tokens_per_s",
                                                           "generated_tokens_per_s")})
    out["lm_moe_layer"] = {k: lmoe["layer"][k] for k in (
        "prefill_vs_g1_float32", "prefill_vs_g1_bfloat16", "card_vs_cpu_float32")}
    out["lm_moe_training"] = {k: lmt[k] for k in (
        "arch", "layers", "tokens_per_s", "f32_tokens_per_s", "bf16_step_s",
        "f32_step_s_median", "profiled_step", "launches", "peak_allocated_gib",
        "aux_min", "aux_max", "first_batch_loss_after")}
    out["lm_moe_training"].update(loss_first=lmt["losses"][0], loss_last=lmt["losses"][-1])
    out["lm_reduced"] = {a: lred[a]["max_abs_diff"] for a in (HYBRID_ARCH, MIXTRAL_ARCH)}
    out["lm_reduced"]["jamba_training"] = {k: lred["training"][k] for k in (
        "loss_max_abs_diff", "param_max_abs_diff", "card_runs_identical")}
    return out


# ------------------------------------------------------ Qwen2-VL and Whisper
# Qwen2-VL-7B at full width and depth (about 7.6 B parameters with its untied 152,064-row
# head, 15.2 GB in bf16; the f32 side of prefill vs decode turns it f32 in place), trained at
# full width cut to 2 layers (parameters, gradients and Adam's two moments in f32 for all 28
# would take about 122 GB; for 2, about 1.56 B parameters, 25 GB); the reduced
# model's training against the CPU at LM_BLOCKS_CONF_LR, since its key biases have a zero
# gradient (q . bk is one constant a softmax row) whose f32 rounding sets Adam's first sign
VLM_ARCH, VLM_TRAIN_LAYERS, VLM_TRAIN_STEPS = "qwen2-vl-7b", 2, 10
# Whisper-tiny at full width and depth: 8 requests of 1,500 frames and the 448 trained
# decoder positions; teacher forcing vs 64 decode steps on 4 of them; serving 8 requests of
# 4 prompt tokens and 64 new ones into a cache of 448 slots
WHISPER_ARCH, WHISPER_BATCH, WHISPER_SEQ = "whisper-tiny", 8, 448
WHISPER_DECODE, WHISPER_PROMPT, WHISPER_TRAIN_STEPS = 64, 4, 20


def whisper_consistency(torch, np, spec, model, audio, tokens, phase: str) -> dict:
    """Teacher forcing vs decode: the logits at the last of ``tokens``' S
    positions from ``decode_train`` over the encoded ``audio`` and from S
    decode steps through ``init_cache`` (relative max, ``repro``'s
    measure), in the model's bf16 and with the same weights in f32 (a
    copy), gated at ``LM_BF16_REL`` and ``LM_F32_REL``."""
    import copy

    from repro_torch.models import whisper as W

    V = spec.whisper.vocab
    S = tokens.shape[1]

    def both(m, cfg, a):
        with torch.no_grad():
            forced = W.decode_train(m, cfg, W.encode(m, cfg, a), tokens)[:, -1, :V]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache = W.init_cache(m, cfg, a, S)
        for i in range(S):
            logits, cache = W.decode_step(m, cfg, cache, tokens[:, i:i + 1])
        torch.cuda.synchronize()
        return forced, logits[:, :V], time.perf_counter() - t0

    f16, d16, dec_s = both(model, spec.whisper, audio)
    m32 = copy.deepcopy(model).float()
    f32, d32, _ = both(m32, dataclasses.replace(spec.whisper, dtype="float32"), audio.float())
    del m32
    out = {"phase": phase, "arch": spec.arch_id, "audio": list(audio.shape),
           "tokens": list(tokens.shape),
           "f32_teacher_vs_decode": _rel(d32, f32), "bf16_teacher_vs_decode": _rel(d16, f16),
           "bf16_teacher_vs_f32": _rel(f16, f32), "bf16_decode_vs_f32": _rel(d16, f32),
           "f32_bound": LM_F32_REL, "bf16_bound": LM_BF16_REL,
           "decode_steps_per_s": S / dec_s}
    emit(out)
    for dtype, bound in (("f32", LM_F32_REL), ("bf16", LM_BF16_REL)):
        if not out[f"{dtype}_teacher_vs_decode"] < bound:
            fail(f"{phase}: {dtype} teacher forcing vs decode differ by "
                 f"{out[f'{dtype}_teacher_vs_decode']} (bound {bound})")
    return out


def whisper_serving(torch, np, spec, model, phase: str) -> dict:
    """``serve_lm_torch.whisper_greedy`` twice on ``WHISPER_BATCH`` requests
    (frame embeddings and ``WHISPER_PROMPT`` prompt tokens from
    ``default_rng(0)``, ``WHISPER_DECODE`` new tokens, a cache of
    ``WHISPER_SEQ``): greedy outputs equal, and the tokens the requests
    hold (prompts and outputs) per second over both runs' wall, the audio's
    encoding included."""
    import serve_lm_torch

    cfg = spec.whisper
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, size=(WHISPER_BATCH, WHISPER_PROMPT))
    audio = torch.from_numpy((rng.normal(size=(WHISPER_BATCH, cfg.n_audio_frames, cfg.d_model))
                              * 0.02).astype(np.float32)).to("cuda", spec.dtype)
    outs, times = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(serve_lm_torch.whisper_greedy(spec, model, audio, prompts, WHISPER_DECODE,
                                                  WHISPER_SEQ))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if outs[0] != outs[1]:
        fail(f"{phase}: two greedy runs of the same requests differ")
    if any(len(o) != WHISPER_DECODE or not all(0 <= t < cfg.vocab for t in o) for o in outs[0]):
        fail(f"{phase}: an output is not {WHISPER_DECODE} in-vocabulary tokens")
    served = WHISPER_BATCH * (WHISPER_PROMPT + WHISPER_DECODE)
    out = {"phase": phase, "arch": spec.arch_id, "requests": WHISPER_BATCH,
           "audio_frames": cfg.n_audio_frames, "prompt_len": WHISPER_PROMPT,
           "new_tokens": WHISPER_DECODE, "cache_len": WHISPER_SEQ, "serve_s": times,
           "identical": True, "decode_tokens_per_s": 2 * served / sum(times),
           "generated_tokens_per_s": 2 * WHISPER_BATCH * WHISPER_DECODE / sum(times),
           "first_outputs": outs[0][:2]}
    emit(out)
    return out


def whisper_card_vs_cpu(torch, np, phase: str) -> dict:
    """Whisper-tiny at full width in f32 from the port's seed-0 init, on the
    card vs the CPU under deterministic algorithms: the encoder states of 2
    x 1,500 frames, the decoder's logits of 32 tokens over them and 16
    decode steps, to rtol/atol ``LM_RTOL`` / ``LM_ATOL``. Then the reduced
    config (head_dim 24) on the card: the flash kernel's wrapper must refuse
    it, with no route to the plain attention."""
    import copy

    from repro_torch.configs import get_arch
    from repro_torch.models import whisper as W

    full = get_arch(WHISPER_ARCH)
    cfg = dataclasses.replace(full.whisper, dtype="float32")
    m_cpu = W.init_whisper(torch.Generator().manual_seed(0), cfg, "cpu")
    m_gpu = copy.deepcopy(m_cpu).to("cuda")
    rng = np.random.default_rng(2)
    audio = torch.from_numpy((rng.normal(size=(2, cfg.n_audio_frames, cfg.d_model)) * 0.02)
                             .astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 32)))
    diffs = {}

    def check(name, got, want):
        diffs[name] = max(diffs.get(name, 0.0), (got.cpu() - want).abs().max().item())
        if not torch.allclose(got.cpu(), want, rtol=LM_RTOL, atol=LM_ATOL):
            fail(f"{phase}: {name} differ by {diffs[name]}")

    torch.use_deterministic_algorithms(True)
    try:
        with torch.no_grad():
            enc_g, enc_c = W.encode(m_gpu, cfg, audio.cuda()), W.encode(m_cpu, cfg, audio)
            check("encoder states", enc_g, enc_c)
            check("decoder logits", W.decode_train(m_gpu, cfg, enc_g, toks.cuda()),
                  W.decode_train(m_cpu, cfg, enc_c, toks))
        c_gpu = W.init_cache(m_gpu, cfg, audio.cuda(), 16)
        c_cpu = W.init_cache(m_cpu, cfg, audio, 16)
        for i in range(16):
            b, c_gpu = W.decode_step(m_gpu, cfg, c_gpu, toks[:, i:i + 1].cuda())
            a, c_cpu = W.decode_step(m_cpu, cfg, c_cpu, toks[:, i:i + 1])
            check("decode step logits", b, a)
    finally:
        torch.use_deterministic_algorithms(False)
    red = get_arch(WHISPER_ARCH, reduced=True)
    small = red.init_params(torch.Generator().manual_seed(0), "cuda")
    try:
        W.encode(small, red.whisper, torch.zeros(1, red.whisper.n_audio_frames,
                                                 red.whisper.d_model, device="cuda"))
    except ValueError as e:
        if "head_dim" not in str(e):
            raise
        refused = str(e)
    else:
        fail(f"{phase}: the reduced Whisper (head_dim {red.whisper.head_dim}) ran on the card; "
             "the flash kernel's wrapper must refuse it")
    out = {"phase": phase, "arch": full.arch_id, "dtype": "float32", "audio": list(audio.shape),
           "tokens": list(toks.shape), "decode_steps": 16, "max_abs_diff": diffs,
           "rtol": LM_RTOL, "atol": LM_ATOL, "reduced_refused": refused}
    emit(out)
    return out


def lm_vlm(torch, np, fa_mod):
    """``lm_vlm``: Qwen2-VL-7B at full width and depth (28 layers, 28 heads
    over 4 KV heads at hd 128, bf16; weights drawn on the card from seed
    0): ``lm_prefill`` (B 4 x S 2,048 with the 1,024-patch span after BOS,
    28 ``flash_attention`` launches a forward), ``BatchedServer`` twice on
    text (``lm_serving``), text-only prefill vs decode on 4 prompts of 256
    tokens (``lm_consistency``, the f32 side on the model turned f32 in
    place), the reduced model card vs CPU with patches (``lm_card_vs_cpu``);
    then training at full width cut to ``VLM_TRAIN_LAYERS`` layers
    (``lm_train_phase``, 2 microbatches a step) and the reduced model's
    conformance. Returns the serving and the training records."""
    out = lm_prefill(torch, np, fa_mod, VLM_ARCH, LM_BATCH, LM_SEQ, "lm_vlm prefill",
                     draw_on_device=True)
    spec, model, toks = out.pop("spec"), out.pop("model"), out.pop("toks")
    out.pop("batch_inputs"), out.pop("first_moe")
    out["serving"] = lm_serving(torch, np, spec, model, "lm_vlm serving")
    out["consistency"] = lm_consistency(torch, np, spec, model, toks[:, :256].contiguous(),
                                        "lm_vlm consistency", in_place_f32=True)
    del model, spec, toks
    gc.collect()
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = lm_card_vs_cpu(torch, np, VLM_ARCH, "lm_vlm card vs cpu")
    train = lm_train_phase(torch, np, fa_mod, VLM_ARCH, VLM_TRAIN_STEPS, "lm_vlm training",
                           layers=VLM_TRAIN_LAYERS, profile_required=False)
    train["conformance"] = _lm_conformance(torch, np, VLM_ARCH, LM_BLOCKS_CONF_LR)
    emit({"phase": "lm_vlm training conformance", **train["conformance"]})
    gc.collect()
    torch.cuda.empty_cache()
    return out, train


def lm_whisper(torch, np, fa_mod):
    """``lm_whisper``: Whisper-tiny at full width and depth (4 + 4 layers,
    6 heads of hd 64, bf16; weights drawn on the CPU from seed 0):
    ``lm_prefill`` (B 8 x 1,500 frames and 448 tokens, 8 ``flash_attention``
    launches a forward: 4 non-causal in the encoder, 4 causal in the
    decoder; the encoder's and decoder's device time), teacher forcing vs 64
    decode steps (``whisper_consistency``), greedy serving twice
    (``whisper_serving``), full width in f32 card vs CPU and the reduced
    config refused on the card (``whisper_card_vs_cpu``); then training, B 8
    x 448 tokens over 1,500 frames, ``WHISPER_TRAIN_STEPS`` steps
    (``lm_train_phase``). Its host-paced forward and step launch hundreds of
    small kernels, and CUPTI has lost flash records in their profiles on
    the H100 (one full run in two, each phase): both profiles report the
    records they kept instead of failing the run. Returns the serving and
    the training records."""
    out = lm_prefill(torch, np, fa_mod, WHISPER_ARCH, WHISPER_BATCH, WHISPER_SEQ,
                     "lm_whisper prefill", profile_required=False)
    spec, model, toks = out.pop("spec"), out.pop("model"), out.pop("toks")
    audio = out.pop("batch_inputs")["audio_embeds"]
    out.pop("first_moe")
    out["consistency"] = whisper_consistency(torch, np, spec, model, audio[:4],
                                             toks[:4, :WHISPER_DECODE].contiguous(),
                                             "lm_whisper consistency")
    out["serving"] = whisper_serving(torch, np, spec, model, "lm_whisper serving")
    del model, spec, toks, audio
    out["card_vs_cpu"] = whisper_card_vs_cpu(torch, np, "lm_whisper card vs cpu")
    train = lm_train_phase(torch, np, fa_mod, WHISPER_ARCH, WHISPER_TRAIN_STEPS,
                           "lm_whisper training", batch=WHISPER_BATCH, seq=WHISPER_SEQ,
                           profile_required=False)
    gc.collect()
    torch.cuda.empty_cache()
    return out, train


def vlm_whisper_summary(lvlm: dict, lvt: dict, lwh: dict, lwt: dict) -> dict:
    """The Qwen2-VL and Whisper phases' end-to-end numbers for the summary."""
    prefill_keys = ("arch", "layers", "batch", "seq", "params", "prefill_tokens_per_s",
                    "forward_device_ms", "forward_host_ms", "paced_by", "flash_share",
                    "launches", "encoder_device_ms", "decoder_device_ms", "encoder_share",
                    "profile_flash_records_kept")
    train_keys = ("arch", "layers", "tokens_per_s", "f32_tokens_per_s", "bf16_step_s",
                  "f32_step_s_median", "profiled_step", "launches", "launches_per_step",
                  "peak_allocated_gib", "first_batch_loss_after")
    out = {}
    for name, r, t in (("lm_vlm", lvlm, lvt), ("lm_whisper", lwh, lwt)):
        c = r["consistency"]
        out[name] = {k: r[k] for k in prefill_keys if k in r}
        out[name]["consistency"] = {k: v for k, v in c.items() if k.startswith(("f32_", "bf16_"))
                                    and not k.endswith("_bound")}
        out[name].update({k: r["serving"][k] for k in ("decode_tokens_per_s",
                                                       "generated_tokens_per_s")})
        out[name]["card_vs_cpu_max_abs_diff"] = r["card_vs_cpu"]["max_abs_diff"]
        out[f"{name}_training"] = {k: t[k] for k in train_keys}
        out[f"{name}_training"].update(loss_first=t["losses"][0], loss_last=t["losses"][-1])
    out["lm_vlm_training"]["conformance"] = {k: lvt["conformance"][k] for k in (
        "loss_max_abs_diff", "param_max_abs_diff", "card_runs_identical")}
    return out


def flash_build_phase(torch, build, fa_mod, lib) -> None:
    """The flash kernel as built: each instantiation's registers, local
    memory bytes (spills and stack) and dynamic shared memory, and whether
    its SASS holds HGMMA (``cuobjdump -sass`` on the library); the same for
    each of the backward's kernels (``bwd_kernel_attrs``). The bf16
    instantiations of the forward and of the backward's dK/dV and dQ
    kernel must run on the tensor cores, and no instantiation of either
    may use local memory."""
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
            if rec["local_bytes"]:
                fail(f"flash build: the {kernel} kernel at hd {hd} uses {rec['local_bytes']} "
                     "bytes of local memory (spills)")
    # the backward's kernels, both dtypes; the bf16 dK/dV and dQ kernel's HGMMA count
    out["backward"] = {}
    for dtype in (torch.bfloat16, torch.float32):
        for hd in fa_mod.HEAD_DIMS:
            recs = fa_mod.bwd_kernel_attrs(dtype, hd)
            out["backward"][f"{str(dtype).replace('torch.', '')} hd {hd}"] = recs
            for name, rec in recs.items():
                if rec["local_bytes"]:
                    fail(f"flash build: the backward's {name} kernel ({dtype}, hd {hd}) uses "
                         f"{rec['local_bytes']} bytes of local memory (spills)")
            if dtype != torch.bfloat16:
                continue
            names = [n for n in bodies if f"flash_bwd_tiles_wgmmaILi{hd}E" in n]
            if len(names) != 1:
                fail(f"flash build: {len(names)} SASS functions for flash_bwd_tiles_wgmma "
                     f"hd {hd}: {names}")
            recs["tiles"]["hgmma"] = bodies[names[0]].count("HGMMA")
            if not recs["tiles"]["hgmma"]:
                fail(f"flash build: the backward's bf16 dK/dV and dQ kernel at hd {hd} has no "
                     "HGMMA in its SASS: it does not run on the tensor cores")
    emit(out)


# the recorded ivf_list_topk calls' sizes (P, lpad, d, S) whose shared-path
# instantiations the build line reports, with the clusters a plan may take
IVF_BUILD_SHAPES = {"ub items": (8, 519, 64, 419), "ub users": (8, 227, 64, 129),
                    "ub exhaustive": (64, 519, 64, 33216), "1M arm": (12, 611, 32, 416)}


def launch_floor_phase(torch, build) -> dict:
    """The time ``measure`` reports for an empty kernel of the same library
    (``g4r_empty``, one launch a call; in no kernel count): one block of 32
    threads, and one wave of 256-thread blocks (the card's SMs x 8). The
    kernels' times and bounds are read against it."""
    lib = build.library()
    stream = torch.cuda.current_stream().cuda_stream
    waves = torch.cuda.get_device_properties(0).multi_processor_count * 8
    out = {"phase": "launch floor"}
    for name, blocks, threads in (("one_block", 1, 32), ("one_wave", waves, 256)):
        build.check(lib.g4r_empty(blocks, threads, stream), "empty kernel")
        m = measure(lambda: lib.g4r_empty(blocks, threads, stream), 200)
        out[name] = {"blocks": blocks, "threads": threads, "ms": m["device_ms"],
                     "call_ms": m["call_ms"], "ms_from": m["ms_from"]}
    emit(out)
    return out


def kernel_build_phase(topk_mod, inbatch_mod, seg_mod, ivf_mod, adagrad_mod) -> dict:
    """Registers, local memory bytes (spills and stack), shared memory and
    residency of each ``topk`` instantiation (one per list length; resident
    blocks an SM and resident 8-block clusters), of the ``inbatch_loss``
    kernel at d 64, 256 and 768, of both ``seg_aggr`` forward and backward
    accesses and both ``row_adagrad`` ones (16- and 4-byte, with the grid
    cap), and of the ``ivf_list_topk`` shared path at the recorded
    calls' sizes in every cluster size its blocks fit (resident blocks an
    SM and resident clusters) and of its global path. Any local memory
    fails, and so do fewer than two resident blocks an SM at the main
    path's sizes of ``topk`` and ``inbatch_loss``."""
    ivf = {}
    for name, (P, lpad, d, S) in IVF_BUILD_SHAPES.items():
        for c in range(1, ivf_mod.MAX_CLUSTER + 1):
            ppb = -(-P // c)
            if ivf_mod.shared_bytes(ppb, lpad, d, c, S) <= ivf_mod.SHARED_CAP:
                ivf[f"{name} cluster {c}"] = ivf_mod.kernel_attrs(ivf_mod.load_mode(d, True), c,
                                                                  ppb, lpad, d, S)
    for load, d in (("bytes", 128), ("bytes", 20)):
        ivf[f"{load} d {d} cluster 2"] = ivf_mod.kernel_attrs(load, 2, 4, 519, d, 419)
    ivf["global path"] = ivf_mod.kernel_attrs("prefetch4", 0, 1, 1, 64, 1)
    out = {"phase": "kernel build",
           "topk": {f"k <= {k}": topk_mod.kernel_attrs(k, topk_mod.MAX_CLUSTER)
                    for k in (32, 64, 128, 256)},
           "inbatch_loss": {f"d {d}": inbatch_mod.kernel_attrs(d) for d in (64, 256, 768)},
           "seg_aggr": {"16-byte": seg_mod.kernel_attrs(True),
                        "4-byte": seg_mod.kernel_attrs(False)},
           "seg_aggr_bwd": {"16-byte": seg_mod.kernel_attrs(True, backward=True),
                            "4-byte": seg_mod.kernel_attrs(False, backward=True)},
           "row_adagrad": {"16-byte": adagrad_mod.kernel_attrs(True),
                           "4-byte": adagrad_mod.kernel_attrs(False)},
           "ivf_list_topk": ivf}
    emit(out)
    for kernel in ("topk", "inbatch_loss", "seg_aggr", "seg_aggr_bwd", "row_adagrad",
                   "ivf_list_topk"):
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


def _flash_fwd_plain(torch, ref, q, k, v, causal, window, block: int = 1024):
    """``attention_fwd_ref`` (output and LSE), in query blocks of ``block``
    where Sq is larger."""
    if q.shape[1] <= block:
        return ref.attention_fwd_ref(q, k, v, causal, window)
    parts = [ref.attention_fwd_ref(q[:, i:i + block], k, v, causal, window, i)
             for i in range(0, q.shape[1], block)]
    return torch.cat([o for o, _ in parts], dim=1), torch.cat([m for _, m in parts], dim=2)


def _check_flash_fwd(torch, got, want, what: str) -> dict:
    """The forward kernel's output against its plain version's: f32 to
    FLASH_RTOL / FLASH_ATOL, bf16 to FLASH_BF16_ATOL and FLASH_BF16_ROW_REL;
    fails on a disagreement, else returns the errors and |want|'s scale."""
    err = (got.float() - want.float()).abs().max().item()
    row_rel = _row_rel(got, want)
    want_abs = want.float().abs()
    scale = {"want_abs_max": want_abs.max().item(), "want_abs_median": want_abs.median().item()}
    del want_abs
    ok = (err <= FLASH_BF16_ATOL and row_rel <= FLASH_BF16_ROW_REL
          if got.dtype == torch.bfloat16
          else torch.allclose(got, want, rtol=FLASH_RTOL, atol=FLASH_ATOL))
    if not ok:
        fail(f"{what} disagrees with its plain version: max abs {err}, row-scaled {row_rel}, "
             f"|want| {scale}")
    return {"max_abs_err": err, "row_rel_err": row_rel, **scale}


def _flash_record(torch, np, ref, fa_cuda, q, k, v, causal, window, source: str,
                  with_lse: bool = False) -> dict:
    """The forward kernel against its plain version on one call, and a
    re-run bitwise, timed beside the plain version, SDPA and the bound.
    ``with_lse``: the call as the training forward makes it, which also
    writes the LSE (checked too)."""
    import torch.nn.functional as F

    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    what = (f"flash_attention {tuple(q.shape)} K={K} {q.dtype} causal={causal} "
            f"window={window} ({source})")
    if with_lse:
        got, lse = fa_cuda(q, k, v, causal, window, with_lse=True)
        want, want_lse = _flash_fwd_plain(torch, ref, q, k, v, causal, window)
        lse_err = (lse - want_lse).abs().max().item()
        if not torch.allclose(lse, want_lse, rtol=FLASH_LSE_RTOL, atol=FLASH_LSE_ATOL):
            fail(f"{what}: its LSE disagrees with the plain one by {lse_err}")
        again, again_lse = fa_cuda(q, k, v, causal, window, with_lse=True)
        rerun = torch.equal(again, got) and torch.equal(again_lse, lse)
        del lse, want_lse, again_lse
    else:
        got = fa_cuda(q, k, v, causal, window)
        want = _flash_plain(torch, ref, q, k, v, causal, window)
        again = fa_cuda(q, k, v, causal, window)
        rerun = torch.equal(again, got)
    torch.cuda.synchronize()
    del again
    if not rerun:
        fail(f"{what}: a re-run is not bitwise equal")
    checked = _check_flash_fwd(torch, got, want, what)
    bf16 = q.dtype == torch.bfloat16
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
    kern = measure(lambda: fa_cuda(q, k, v, causal, window, with_lse=with_lse), 5 if big else 50,
                   floor_ms=tc_ms)
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
           "with_lse": with_lse, **checked, "rerun_bitwise": True,
           **times(kernel=kern, plain=plain, library=lib),
           "band_pairs": pairs, "flop": flops,
           "kernel_tflop_per_s": flops / kern["device_ms"] / 1e9,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "f32_core_bound_ms": f32_core_ms, "bf16_tc_bound_ms": tc_ms}
    if with_lse:
        rec["lse_max_abs_err"] = lse_err
    if bf16:
        rec["exact_share"] = (got == want).float().mean().item()
    emit(rec)
    return rec


def flash_phase(torch, np, ref, fa_cuda, paths: dict):
    """The kernel against its plain version on the first prefill call of
    each shape of each path (source -> calls), then at synthetic shapes: f32
    causal and not, a tail tile, qwen2's G 7, hd 32, hd 128 with a tail
    tile and a 64-key window, starcoder2's bf16 layout with its 4,096
    window. Returns the first path's largest record and the other
    paths' records."""
    recs = {src: [_flash_record(torch, np, ref, fa_cuda, q, k, v, kw.get("causal", True),
                                kw.get("window"), src) for (q, k, v), kw in calls]
            for src, calls in paths.items()}
    first, *rest = recs.values()
    main = max(first, key=lambda r: r["flop"])
    others = [r for rs in rest for r in rs]
    gen = torch.Generator(device="cuda").manual_seed(3)
    for (B, S, H, K, hd), dtype, causal, window in FLASH_SYNTHETIC:
        dtype = getattr(torch, dtype)
        q = torch.randn(B, S, H, hd, device="cuda", generator=gen).to(dtype)
        k = torch.randn(B, S, K, hd, device="cuda", generator=gen).to(dtype)
        v = torch.randn(B, S, K, hd, device="cuda", generator=gen).to(dtype)
        _flash_record(torch, np, ref, fa_cuda, q, k, v, causal, window, "synthetic")
    return main, others


def _flash_bwd_record(torch, np, ref, fa_mod, q, k, v, o, lse, do, causal, window,
                      source: str) -> dict:
    """The forward kernel's ``o`` and ``lse`` that the call was given against
    ``attention_fwd_ref``'s (both feed the plain version below as well, so
    only this check sees them); the backward kernel against
    ``attention_bwd_ref`` on the call (the same q, k, v, o, lse and dO), a
    bitwise re-run, in bf16 also against ``bwd_kernel_emulation`` (whose
    own distance to the plain version is recorded beside the kernel's), and
    its time beside the
    plain version's, the library's (the backward of
    ``scaled_dot_product_attention(enable_gqa=True)`` through autograd,
    timed apart from its forward) and the bound (10 hd FLOP a (query, key)
    pair of the band: S recomputed, dP, dV, dQ, dK)."""
    import torch.nn.functional as F

    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    bwd = fa_mod.flash_attention_bwd_cuda
    block = 1024 if Sq > 1024 else None
    what = (f"flash_attention {tuple(q.shape)} K={K} {q.dtype} causal={causal} "
            f"window={window} ({source}, the backward's input)")
    want_o, want_lse = _flash_fwd_plain(torch, ref, q, k, v, causal, window)
    fwd = _check_flash_fwd(torch, o, want_o, what)
    lse_err = (lse - want_lse).abs().max().item()
    if not torch.allclose(lse, want_lse, rtol=FLASH_LSE_RTOL, atol=FLASH_LSE_ATOL):
        fail(f"{what}: its LSE disagrees with the plain one by {lse_err}")
    del want_o, want_lse

    def plain():
        return ref.attention_bwd_ref(q, k, v, o, lse, do, causal, window, block_q=block)

    got = bwd(q, k, v, o, lse, do, causal, window)
    want = plain()
    torch.cuda.synchronize()
    errs = {n: (g.float() - w.float()).abs().max().item() for n, g, w in zip("qkv", got, want)}
    rels = {n: _row_rel(g, w, FLASH_BWD_ROW_FLOOR) for n, g, w in zip("qkv", got, want)}
    if not all(flash_bwd_ok(g, w) for g, w in zip(got, want)):
        fail(f"flash_attention_bwd {tuple(q.shape)} K={K} {q.dtype} causal={causal} "
             f"window={window} ({source}) disagrees with attention_bwd_ref: max abs {errs}, "
             f"row-scaled {rels}, |want| max {[w.abs().max().item() for w in want]}")
    again = bwd(q, k, v, o, lse, do, causal, window)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"flash_attention_bwd {tuple(q.shape)} ({source}): a re-run is not bitwise equal")
    emulated = {}
    if q.dtype == torch.bfloat16:  # the kernel's arithmetic on the same inputs
        emu = bwd_kernel_emulation(q, k, v, o, lse, do, causal, window)
        emulated = {
            "emulation_row_rel_err": {n: _row_rel(e, w, FLASH_BWD_ROW_FLOOR)
                                      for n, e, w in zip("qkv", emu, want)},
            "kernel_vs_emulation_row_rel_err": {n: _row_rel(g, e, FLASH_BWD_ROW_FLOOR)
                                                for n, g, e in zip("qkv", got, emu)}}
        if not all(flash_bwd_ok(g, e) for g, e in zip(got, emu)):
            fail(f"flash_attention_bwd {tuple(q.shape)} ({source}) disagrees with the "
                 f"emulation of its arithmetic: {emulated}")
        del emu
    del got, again
    bf16 = q.dtype == torch.bfloat16
    pairs = _band_pairs(np, Sq, Skv, causal, window)
    flops = 10.0 * hd * pairs * B * H
    nbytes = (2 * (q.numel() + k.numel() + v.numel()) + o.numel() + do.numel()) \
        * q.element_size() + lse.numel() * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (BF16_FLOP_PER_S if bf16 else FP32_FLOP_PER_S) * 1e3
    big = flops > 1e11
    kern = measure(lambda: bwd(q, k, v, o, lse, do, causal, window), 5 if big else 20,
                   floor_ms=max(t_bytes, t_ops))
    pl = measure(plain, 2 if big else 10, warmup=1, floor_ms=max(t_bytes, t_ops))
    leaves = [t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)]
    if window is None:
        lib_out = F.scaled_dot_product_attention(*leaves, is_causal=causal, enable_gqa=True)
    else:
        i = torch.arange(Sq, device=q.device)[:, None]
        j = torch.arange(Skv, device=q.device)[None, :]
        band = j > i - window
        if causal:
            band &= j <= i
        lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=band, enable_gqa=True)
    g_out = do.transpose(1, 2)
    # the library's own distance to the plain version (not gated): what a
    # tensor-core backward that rounds its operands reads on these inputs
    lib_rel = {n: _row_rel(g.transpose(1, 2), w, FLASH_BWD_ROW_FLOOR) for n, g, w in zip(
        "qkv", torch.autograd.grad(lib_out, leaves, g_out, retain_graph=True), want)}
    del want
    lib = measure(lambda: torch.autograd.grad(lib_out, leaves, g_out, retain_graph=True),
                  5 if big else 20, floor_ms=max(t_bytes, t_ops))
    del lib_out, leaves
    dtype = str(q.dtype).replace("torch.", "")
    rec = {"phase": "kernel", "name": "flash_attention_bwd", "source": source,
           "shape": {"B": B, "Sq": Sq, "Skv": Skv, "H": H, "K": K, "hd": hd},
           "dtype": dtype, "causal": causal, "window": window,
           "max_abs_err": max(errs.values()), "max_abs_err_by_grad": errs,
           "plan": fa_mod.bwd_plan(q.dtype, B, Sq, Skv, H, K, hd),
           "row_rel_err": rels, **emulated, "library_row_rel_err": lib_rel,
           "do_abs_max": do.abs().max().item(),
           "rerun_bitwise": True,
           "o_max_abs_err": fwd["max_abs_err"], "o_row_rel_err": fwd["row_rel_err"],
           "lse_max_abs_err": lse_err,
           **times(kernel=kern, plain=pl, library=lib),
           "band_pairs": pairs, "flop": flops,
           "kernel_tflop_per_s": flops / kern["device_ms"] / 1e9,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    emit(rec)
    return rec


def flash_bwd_phase(torch, np, ref, fa_mod, paths: dict, prefill_keys: set):
    """The backward kernel on the first training call of each (shape,
    dtype) of each path (source -> calls), then at ``FLASH_SYNTHETIC``'s
    shapes (the forward kernel's output and LSE, a random dO): f32 causal
    and not, a tail tile, qwen2's G 7, hd 32, hd 128 with a tail tile and a
    64-key window, starcoder2's bf16 layout with its 4,096 window. The
    forward kernel, with its LSE, on each training call whose key the
    prefills' records do not have (the f32 steps'). Returns
    the first path's main backward record (its largest f32 call), the
    other paths' backward records and those forward records."""
    fwd = [_flash_record(torch, np, ref, fa_mod.flash_attention_cuda, q, k, v, causal, window,
                         src, with_lse=True)
           for src, calls in paths.items() for q, k, v, _, _, _, causal, window in calls
           if _flash_key(((q, k), {"causal": causal, "window": window})) not in prefill_keys]
    recs = {src: [_flash_bwd_record(torch, np, ref, fa_mod, *c, src) for c in calls]
            for src, calls in paths.items()}
    first, *rest = recs.values()
    main = max(first, key=lambda r: (r["dtype"] == "float32", r["flop"]))
    others = [r for rs in rest for r in rs]
    gen = torch.Generator(device="cuda").manual_seed(4)
    for (B, S, H, K, hd), dtype, causal, window in FLASH_SYNTHETIC:
        dtype = getattr(torch, dtype)
        q = torch.randn(B, S, H, hd, device="cuda", generator=gen).to(dtype)
        k = torch.randn(B, S, K, hd, device="cuda", generator=gen).to(dtype)
        v = torch.randn(B, S, K, hd, device="cuda", generator=gen).to(dtype)
        do = torch.randn(B, S, H, hd, device="cuda", generator=gen).to(dtype)
        o, lse = fa_mod.flash_attention_cuda(q, k, v, causal, window, with_lse=True)
        _flash_bwd_record(torch, np, ref, fa_mod, q, k, v, o, lse, do, causal, window,
                          "synthetic")
    return main, others, fwd


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
    kernel_build_phase(topk_mod, inbatch_mod, seg_mod, ivf_mod, adagrad_mod)

    modules = {"seg_aggr": seg_mod, "topk": topk_mod, "inbatch_loss": inbatch_mod,
               "row_adagrad": adagrad_mod, "window_pairs": wp_mod, "ivf_list_topk": ivf_mod}
    mp = main_path(torch, np, modules)
    iv = ivf_serving_path(torch, np, modules, mp)
    m1 = million_arm(torch, np, modules)
    tr = training_path(torch, np, modules, mp["recall"]["u2i"])
    fu = fused_training_path(torch, np, modules, mp["recall"]["u2i"])
    conf = conformance_phase(torch, np)
    ot = observed_training(torch, np, modules, tr)
    mpt = mp_training(torch, np, modules, tr)
    of = observed_fused(torch, np, modules, fu)
    oc = observed_conformance(torch, np)
    ws = warm_start_phase(torch, np, tr, mp["recall"]["u2i"])
    sw = sweep_phase(torch, np, modules)
    lm = lm_path(torch, np, fa_mod)
    lt = lm_training(torch, np, fa_mod)
    lmoe = lm_moe(torch, np, fa_mod)
    lssm = lm_ssm(torch, np, fa_mod)
    lhyb = lm_hybrid(torch, np, fa_mod)
    lmt = lm_moe_training(torch, np, fa_mod)
    lvlm, lvt = lm_vlm(torch, np, fa_mod)
    lwh, lwt = lm_whisper(torch, np, fa_mod)
    lred = lm_reduced(torch, np)
    gc.collect()
    torch.cuda.empty_cache()  # the IVF phases' blocks: leave the card's memory free
    emit({"phase": "clocks", "before_kernel_phases": sm_clocks(),
          "reserved_gib": torch.cuda.memory_reserved() / 2**30})
    floor = launch_floor_phase(torch, build)
    seg = seg_aggr_phase(torch, ref, seg_mod.seg_aggr_cuda,
                         {"serving": mp["calls"]["seg_aggr"], "training": tr["kept"]["seg_aggr"],
                          "fused training": fu["kept"]["seg_aggr"]})
    topk = topk_phase(torch, ref, topk_mod,
                      {"serving": mp["calls"]["topk"], "1M arm": m1["topk_calls"]})
    seg_bwd = seg_aggr_bwd_phase(torch, ref, seg_mod,
                                 {"training": tr["kept"]["seg_aggr_bwd"],
                                  "fused training": fu["kept"]["seg_aggr_bwd"]})
    inbatch = inbatch_phase(torch, ref, inbatch_mod, tr["kept"]["inbatch_loss"])
    adagrad = row_adagrad_phase(torch, ref, adagrad_mod.row_adagrad_scatter_cuda,
                                tr["kept"]["row_adagrad"])
    wp = window_pairs_phase(torch, ref, wp_mod.window_pair_ids_cuda, fu["window_pairs_calls"])
    ivf = ivf_phase(torch, ref, ivf_mod,
                    {"ivf serving": iv["calls"]["ivf serving"],
                     "ivf exhaustive": iv["calls"]["ivf exhaustive"], "1M arm": m1["calls"]})
    prefill_calls = {"lm prefill path": lm["calls"], "lm_moe prefill path": lmoe["calls"],
                     "lm_hybrid prefill path": lhyb["calls"], "lm_vlm prefill path": lvlm["calls"],
                     "lm_whisper prefill path": lwh["calls"]}
    flash, flash_others = flash_phase(torch, np, ref, fa_mod.flash_attention_cuda, prefill_calls)
    flash_bwd, flash_bwd_others, flash_train = flash_bwd_phase(
        torch, np, ref, fa_mod,
        {"lm training path": lt["bwd_calls"], "lm_moe_training path": lmt["bwd_calls"],
         "lm_vlm training path": lvt["bwd_calls"], "lm_whisper training path": lwt["bwd_calls"]},
        {_flash_key(c) for calls in prefill_calls.values() for c in calls})

    def timing(rec):
        return {"max_abs_err": rec["max_abs_err"], "ms": rec["kernel_ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
                "ms_from": {k: rec["ms_from"][k] for k in ("kernel", "plain", "library")}}

    def entry(name, rec, source, replaces, by_path, other_calls=()):
        out = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": sum(by_path.values()), "launches_by_path": by_path, **timing(rec)}
        if other_calls:  # the same kernel timed at another call of the path
            out["other_calls"] = [{"source": r["source"], "shape": r["shape"],
                                   "dtype": r["dtype"], **timing(r)} for r in other_calls]
        return out

    tl, fl = tr["launches"], fu["launches"]
    ml = mpt["mp_0"]["launches"]  # the run whose every sampling round crossed to a worker
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
          "launch_floor_ms": {k: floor[k]["ms"] for k in ("one_block", "one_wave")},
          "observed_training": {k: ot[k] for k in (
              "phase_ms_per_step", "phase_thread_cpu_ms_per_step", "device_span_ms",
              "wall_ms_per_step", "consumer_share_of_wall", "producer_share_of_wall",
              "pairs_per_s_plain", "pairs_per_s_observed", "observed_over_plain", "spans",
              "dropped_spans", "h2d_alone", "serial_control")},
          "mp_training": {k: mpt[k] for k in (
              "cpu_count", "engine_workers", "pairs_per_s", "shm_free_bytes_before",
              "losses_bitwise_equal", "cli", "phase_s")} | {
              n: {"phase_ms_per_step": mpt[n]["split"][0]["phase_ms_per_step"],
                  "phase_thread_cpu_ms_per_step":
                  mpt[n]["split"][0]["phase_thread_cpu_ms_per_step"],
                  "device_span_ms": mpt[n]["split"][0]["device_span_ms"],
                  "engine": mpt[n]["engine"][0]} for n in MP_CASES},
          "observed_fused": {k: of[k] for k in (
              "phase_ms_per_step", "phase_thread_cpu_ms_per_step", "device_span_ms",
              "wall_ms_per_step", "pairs_per_s_plain", "pairs_per_s_observed",
              "observed_over_plain")},
          "observed_conformance": {u: oc[u]["bitwise"] for u in ("sparse", "dense", "fused")},
          "warm_start": {k: {m: ws[k][m] for m in ("loss_first20_mean", "loss_last20_mean",
                                                   "u2i_trained")} for k in ("cold", "warm")},
          "sweep": [{k: r[k] for k in ("model", "method", "launches")} | {
              "u2i": r["metrics"]["u2i"]} for r in sw["runs"]],
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
              "card_vs_cpu_max_abs_diff": lm["card_vs_cpu"]["max_abs_diff"]},
          "lm_training": {k: lt[k] for k in (
              "arch", "tokens_per_s", "f32_tokens_per_s", "bf16_step_s", "f32_step_s_median",
              "profiled_step", "launches", "peak_allocated_gib")} | {
              "loss_first": lt["losses"][0], "loss_last": lt["losses"][-1],
              "conformance": {k: lt["conformance"][k] for k in (
                  "loss_max_abs_diff", "param_max_abs_diff", "card_runs_identical")}},
          **lm_blocks_summary(lmoe, lssm, lhyb, lmt, lred),
          **vlm_whisper_summary(lvlm, lvt, lwh, lwt)})
    print(json.dumps({"kernels": [
        entry("seg_aggr", seg, "src/repro_torch/kernels/csrc/seg_aggr.cu",
              "src/repro/kernels/seg_aggr.py:45",
              {"serving": mp["launches"]["seg_aggr"], "training": tl["seg_aggr"],
               "mp training": ml["seg_aggr"], "fused training": fl["seg_aggr"]}),
        entry("topk", topk, "src/repro_torch/kernels/csrc/topk.cu",
              "src/repro/kernels/topk.py:77",
              {"serving": mp["launches"]["topk"], "1M arm": m1["topk_launches"]}),
        entry("seg_aggr_bwd", seg_bwd, "src/repro_torch/kernels/csrc/seg_aggr.cu",
              "src/repro/kernels/seg_aggr.py:45",
              {"training": tl["seg_aggr_bwd"], "mp training": ml["seg_aggr_bwd"],
               "fused training": fl["seg_aggr_bwd"]}),
        entry("inbatch_loss", inbatch, "src/repro_torch/kernels/csrc/inbatch_loss.cu",
              "src/repro/kernels/inbatch_loss.py:41",
              {"training": tl["inbatch_loss"], "mp training": ml["inbatch_loss"],
               "fused training": fl["inbatch_loss"]}),
        entry("row_adagrad", adagrad, "src/repro_torch/kernels/csrc/row_adagrad.cu",
              "src/repro/kernels/row_adagrad.py:41",
              {"training": tl["row_adagrad"], "mp training": ml["row_adagrad"],
               "fused training": fl["row_adagrad"]}),
        entry("window_pairs", wp, "src/repro_torch/kernels/csrc/window_pairs.cu",
              "src/repro/kernels/window_pairs.py:38", {"fused training": fl["window_pairs"]}),
        entry("ivf_list_topk", ivf, "src/repro_torch/kernels/csrc/ivf.cu",
              "src/repro/kernels/ivf.py:97",
              {"ivf serving": iv["launches"]["ivf_list_topk"],
               "ivf exhaustive": iv["exhaustive"]["launches"], "1M arm": m1["launches"]}),
        entry("flash_attention", flash, "src/repro_torch/kernels/csrc/flash_attn.cu",
              "src/repro/kernels/flash_attn.py:81",
              {"lm prefill": lm["launches"]["flash_attention"],
               "lm training": lt["launches"]["flash_attention"],
               "lm_moe prefill": lmoe["launches"]["flash_attention"],
               "lm_ssm prefill": lssm["launches"]["flash_attention"],
               "lm_hybrid prefill": lhyb["launches"]["flash_attention"],
               "lm_moe_training": lmt["launches"]["flash_attention"],
               "vlm prefill": lvlm["launches"]["flash_attention"],
               "vlm training": lvt["launches"]["flash_attention"],
               "whisper prefill": lwh["launches"]["flash_attention"],
               "whisper training": lwt["launches"]["flash_attention"]},
              flash_others + flash_train),
        entry("flash_attention_bwd", flash_bwd, "src/repro_torch/kernels/csrc/flash_attn_bwd.cu",
              "src/repro/kernels/ops.py:139 (no VJP); src/repro/models/layers.py:205",
              {"lm training": lt["launches"]["flash_attention_bwd"],
               "lm_moe_training": lmt["launches"]["flash_attention_bwd"],
               "vlm training": lvt["launches"]["flash_attention_bwd"],
               "whisper training": lwt["launches"]["flash_attention_bwd"]}, flash_bwd_others),
    ]}), flush=True)
    print(smi, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
