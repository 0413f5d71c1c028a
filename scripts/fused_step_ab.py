#!/usr/bin/env python3
"""The fused training step of this checkout against another's, in turns, on
one CUDA card: what the pair stage costs the step.

    python3 scripts/fused_step_ab.py --other DIR [--rounds 3] [--steps 200]

DIR is a checkout of another commit (for example the parent, unpacked with
``git archive`` into a directory that ``.gitignore`` lists). Each turn is a
fresh process that imports ``repro_torch`` and ``examples/train_torch.py``
from one tree (its kernels built from its own sources into its own
``build/``), in the order other, this, this, other (``--rounds`` times),
and runs ``chip_smoke.py``'s fused phase on it: UB, LightGCN at dim 64 with
side info, 512 pairs a step, ``--sampling-backend fused``, no prefetcher,
seed 0. A turn reports pairs/s (the run's, whose first step holds the
warm-up, and the steady rate from the median period between step entries,
the first step left out), each step's dispatch (CUDA events and the host
clock around ``_fused_step``) and the host time between steps; the host ms
of one ``FusedSampler.sample_from`` (the trained run's sampler on one set of
draws: 30 blocks of 20 calls, each block ended by a synchronize, the
median; the card waits on the host there, so this is the sampler's host
cost); then a 40-step run (seed 1) under torch.profiler with
``chip_smoke.fused_profile_ranges``: the kernels launched a step inside
``FusedSampler.sample_from`` and inside its pair stage's dispatcher call
(``window_pair_draw``, or in a tree that predates it the gather
``window_pair_ids``, the first of the stage's launches), their device time,
and the kernels of one ``sample_from`` in order. The two trees' walk and
ego stages are the same code, so the difference of their ``sample_from``
launches and device time is the difference of their pair stages. One JSON
line a turn, then a summary line: each tree's medians over its turns and
their spread (largest minus smallest), and the card's name and power limit.

The host drifts between processes by more than the pair stage costs, so a
last process (``--rounds 0`` runs it alone) holds the two ``sample_from``s
side by side: this tree's package with the other tree's
``sampling/fused.py`` loaded from its file (the module its ``sample_from``
is; every other module is this tree's), both called on one sampler (the
fused phase's, after 2 steps) and one set of draws. Their batches must be
bitwise equal. Then their host ms a call, in blocks of ``--calls`` calls
each ended by a synchronize, alternating which goes first
(``--blocks`` blocks each): the medians, quartiles, and how many blocks
this tree's beat the other's next to it; and one profile of 40 calls each,
alternating, each call in its own ``record_function``: launches and device
us a call and each kernel's median us by its place in the call.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(steps: int) -> None:
    sys.path.append(ROOT)  # this tree's chip_smoke.py, after the turn's own tree
    import torch

    import chip_smoke
    import train_torch
    from repro_torch.kernels import build, ops
    from repro_torch.sampling import fused as fused_mod
    from repro_torch.train.trainer import Graph4RecTrainer

    build.build()
    events = []
    with chip_smoke.step_events(torch, Graph4RecTrainer, "_fused_step", events):
        res = train_torch.run(chip_smoke.fused_args(train_torch, 0, steps), eval_at_end=False)
        torch.cuda.synchronize()
    r = res["result"]
    if r.plan["sampling"] != "fused" or len(r.losses) != steps:
        sys.exit(f"fused_step_ab: planned {r.plan['sampling']!r}, {len(r.losses)} steps")
    period_ms = statistics.median((b[2] - a[2]) * 1e3 for a, b in zip(events[1:], events[2:]))
    sampler = res["trainer"]._fused_sampler
    draws = sampler.draw(torch.Generator(device="cuda").manual_seed(0))
    for _ in range(20):
        sampler.sample_from(draws)
    torch.cuda.synchronize()
    blocks = []
    for _ in range(30):
        t0 = time.perf_counter()
        for _ in range(20):
            sampler.sample_from(draws)
        torch.cuda.synchronize()
        blocks.append((time.perf_counter() - t0) / 20 * 1e3)
    prof = chip_smoke._train_profile(torch, train_torch, chip_smoke.fused_args(train_torch, 1, 40),
                                     "fused_step_ab profile",
                                     ranges=chip_smoke.fused_profile_ranges(ops, fused_mod))
    print(json.dumps({
        "tree": os.environ["PYTHONPATH"].split(os.pathsep)[0],
        "card": torch.cuda.get_device_name(0), "steps": steps,
        "pairs_per_s": r.pairs_seen / r.wall_time_s,
        "steady_pairs_per_s": r.pairs_seen / steps / period_ms * 1e3,
        "step_period_ms_median": period_ms, "step_wall_ms": r.wall_time_s / steps * 1e3,
        **chip_smoke._step_split(events), "sample_from_host_ms_median": statistics.median(blocks),
        "sample_from_host_ms_min": min(blocks),
        "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
        "ranges": prof["ranges"]}), flush=True)


def interleaved(other: str, blocks: int, calls: int) -> dict:
    """The two trees' ``sample_from`` in one process (the module docstring)."""
    import importlib.util

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "examples"), ROOT]
    import chip_smoke
    import train_torch
    from repro_torch.kernels import build

    build.build()
    spec = importlib.util.spec_from_file_location(
        "other_fused", os.path.join(other, "src", "repro_torch", "sampling", "fused.py"))
    other_fused = importlib.util.module_from_spec(spec)
    sys.modules["other_fused"] = other_fused  # its dataclasses look their module up
    spec.loader.exec_module(other_fused)
    res = train_torch.run(chip_smoke.fused_args(train_torch, 0, 2), eval_at_end=False)
    sampler = res["trainer"]._fused_sampler
    draws = sampler.draw(torch.Generator(device="cuda").manual_seed(0))
    fns = {"other": lambda: other_fused.FusedSampler.sample_from(sampler, draws),
           "this": lambda: sampler.sample_from(draws)}

    def leaves(tree) -> list:
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [x for t in tree for x in leaves(t)]
        return [] if tree is None else [tree]

    a, b = leaves(fns["other"]()), leaves(fns["this"]())
    if len(a) != len(b) or not all(torch.equal(x, y) for x, y in zip(a, b)):
        sys.exit("fused_step_ab: the two trees' sample_from batches differ")
    for fn in fns.values():
        for _ in range(20):
            fn()
    torch.cuda.synchronize()
    host = {"other": [], "this": []}
    for i in range(blocks):
        for who in (("other", "this") if i % 2 == 0 else ("this", "other")):
            t0 = time.perf_counter()
            for _ in range(calls):
                fns[who]()
            torch.cuda.synchronize()
            host[who].append((time.perf_counter() - t0) / calls * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(40):
            for who, fn in fns.items():
                with record_function(f"ab.{who}"):
                    fn()
        torch.cuda.synchronize()
    ranges = chip_smoke._range_kernels(torch, prof, {"ab.other", "ab.this"})
    out = {"what": "sample_from side by side", "card": torch.cuda.get_device_name(0),
           "blocks": blocks, "calls_a_block": calls, "batches_bitwise_equal": True,
           "this_faster_blocks": sum(t < o for t, o in zip(host["this"], host["other"]))}
    for who in fns:
        q = statistics.quantiles(host[who], n=4)
        per = [c for c in ranges[f"ab.{who}"] if len(c) == len(ranges[f"ab.{who}"][0])]
        out[who] = {"host_ms_median": statistics.median(host[who]),
                    "host_ms_quartiles": [q[0], q[2]],
                    "launches_a_call": statistics.median(len(c) for c in ranges[f"ab.{who}"]),
                    "device_us_a_call": statistics.median(sum(us for _, us in c)
                                                          for c in ranges[f"ab.{who}"]),
                    "kernel_us_by_place": [[per[0][i][0][:48],
                                            statistics.median(c[i][1] for c in per)]
                                           for i in range(len(per[0]))]}
    print(json.dumps(out), flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="a checkout of a commit to compare with")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--blocks", type=int, default=40)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--side-by-side", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.steps)
        return
    if args.side_by_side:
        interleaved(os.path.abspath(args.other), args.blocks, args.calls)
        return
    if not args.other:
        sys.exit("fused_step_ab: --other DIR is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    trees = {"other": os.path.abspath(args.other), "this": ROOT}
    turns = {"other": [], "this": []}
    for _ in range(args.rounds):
        for who in ("other", "this", "this", "other"):
            path = os.pathsep.join(os.path.join(trees[who], d) for d in ("src", "examples"))
            res = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                                  "--steps", str(args.steps)],
                                 env=dict(os.environ, PYTHONPATH=path), capture_output=True,
                                 text=True, timeout=900)
            if res.returncode:
                sys.exit(f"fused_step_ab: the {who} turn failed:\n{res.stderr[-3000:]}")
            rec = json.loads(res.stdout.strip().splitlines()[-1])
            rec["who"] = who
            turns[who].append(rec)
            print(json.dumps(rec), flush=True)
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--side-by-side", "--other",
                          args.other, "--blocks", str(args.blocks), "--calls", str(args.calls)],
                         capture_output=True, text=True, timeout=900)
    if res.returncode:
        sys.exit(f"fused_step_ab: the side-by-side process failed:\n{res.stderr[-3000:]}")
    print(res.stdout.strip().splitlines()[-1], flush=True)
    if not args.rounds:
        return
    summary = {"card": smi}
    for who, recs in turns.items():
        out = {}
        for key in ("pairs_per_s", "steady_pairs_per_s", "step_period_ms_median",
                    "step_wall_ms", "dispatch_ms_median", "dispatch_host_ms_median",
                    "between_steps_host_ms_median", "sample_from_host_ms_median"):
            vals = [t[key] for t in recs]
            out[key] = {"median": statistics.median(vals), "spread": max(vals) - min(vals)}
        for label in recs[0]["ranges"]:
            for key in ("launches_per_step", "device_us_per_step"):
                out[f"{label} {key}"] = statistics.median(t["ranges"][label][key] for t in recs)
        summary[who] = out
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    main()
