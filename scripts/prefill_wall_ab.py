#!/usr/bin/env python3
"""Prefill wall of this checkout against another's, in turns, on one CUDA
card: the host cost of the flash attention's dispatch.

    python3 scripts/prefill_wall_ab.py --other DIR [--rounds 2]

DIR is a checkout of another commit (for example the parent, unpacked with
``git archive`` into a directory that ``.gitignore`` lists). Each turn is a
fresh process that imports ``repro_torch`` from one tree (its kernels built
from its own sources into its own ``build/``), in the order other, this,
this, other (``--rounds`` times). A process times two prefills through
``ArchSpec.make_prefill`` at the sizes ``chip_smoke.py`` runs them, with
weights from ``init_params`` (seed 0) and inputs from ``default_rng(0)``:
smollm-135m (B 4 x S 2,048, bf16, 30 flash calls a forward) and
Whisper-tiny (B 8, 1,500 frames, 448 tokens, bf16, 8 flash calls a
forward, host-paced). Each forward's wall is the host clock around the
call and a ``torch.cuda.synchronize()``, 3 warm-ups then ``--reps`` timed;
its device time comes from CUDA events around the same call. One JSON line
a turn, then a summary line: each tree's median walls over its turns and
the run-to-run spread (the largest minus the smallest of the turns'
medians, per tree).
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


def worker(reps: int) -> None:
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attn as fa_mod

    build.build()
    rng = np.random.default_rng(0)
    cases = {}
    smol = get_arch("smollm-135m")
    tokens = torch.from_numpy(rng.integers(0, smol.lm.vocab, (4, 2048))).cuda()
    cases["smollm-135m"] = (smol, {"tokens": tokens})
    wh = get_arch("whisper-tiny")
    cfg = wh.whisper
    audio = torch.from_numpy(rng.standard_normal((8, cfg.n_audio_frames, cfg.d_model),
                                                 dtype=np.float32)).to("cuda", torch.bfloat16)
    wtok = torch.from_numpy(rng.integers(0, cfg.vocab, (8, 448))).cuda()
    cases["whisper-tiny"] = (wh, {"audio_embeds": audio, "tokens": wtok})
    out = {"tree": os.environ["PYTHONPATH"], "card": torch.cuda.get_device_name(0)}
    for name, (spec, batch) in cases.items():
        model = spec.init_params(torch.Generator().manual_seed(0), device="cuda")
        prefill = spec.make_prefill()
        for _ in range(3):
            prefill(model, batch)
        torch.cuda.synchronize()
        walls, device = [], []
        fa_mod.launches = 0
        for _ in range(reps):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            prefill(model, batch)
            stop.record()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            device.append(start.elapsed_time(stop))
        out[name] = {"wall_ms_median": statistics.median(walls), "wall_ms_min": min(walls),
                     "wall_ms_max": max(walls), "events_ms_median": statistics.median(device),
                     "flash_launches_per_forward": fa_mod.launches / reps}
        del model
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="a checkout of a commit to compare with")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.reps)
        return
    if not args.other:
        sys.exit("prefill_wall_ab: --other DIR is required")
    trees = {"other": os.path.abspath(args.other), "this": ROOT}
    turns = {"other": [], "this": []}
    for _ in range(args.rounds):
        for who in ("other", "this", "this", "other"):
            env = dict(os.environ, PYTHONPATH=os.path.join(trees[who], "src"))
            res = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                                  "--reps", str(args.reps)], env=env, capture_output=True,
                                 text=True, timeout=600)
            if res.returncode:
                sys.exit(f"prefill_wall_ab: the {who} turn failed:\n{res.stderr[-3000:]}")
            rec = json.loads(res.stdout.strip().splitlines()[-1])
            rec["who"] = who
            turns[who].append(rec)
            print(json.dumps(rec), flush=True)
    summary = {}
    for name in ("smollm-135m", "whisper-tiny"):
        for who in turns:
            meds = [t[name]["wall_ms_median"] for t in turns[who]]
            summary[f"{name} {who}"] = {"wall_ms_median": statistics.median(meds),
                                        "spread_ms": max(meds) - min(meds)}
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    main()
