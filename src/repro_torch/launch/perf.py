"""Roofline deltas of named variants of one (arch x shape) on one H100: the
counterpart of ``repro/launch/perf.py``.

    PYTHONPATH=src python -m repro_torch.launch.perf --arch qwen2-0.5b \\
        --shape train_4k --variants baseline,pad_heads

Each variant is a set of ``LMConfig`` / ``ArchSpec`` overrides (``repro``'s
perf knobs, under ``repro``'s names), counted by the dry run's
``run_one`` on fake tensors: nothing is timed (kernels are timed in turns by
``scripts/kernel_ab.py``). Most knobs steer XLA or the TPU mesh and select
nothing in the port (``block_q``, ``gather_head``, ``remat_policy``,
``shard_cache_seq``), so their rows equal ``baseline``'s; ``pad_heads``
(more query heads) and ``__microbatches`` (gradient accumulation) change
the traced step. Results append to ``--out``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict, Optional

from repro_torch.configs.registry import get_arch
from repro_torch.launch.dryrun import run_one
from repro_torch.utils import get_logger

log = get_logger("repro_torch.perf")

# named variants: LMConfig field overrides (+ ArchSpec-level '__microbatches')
VARIANTS: Dict[str, Dict] = {
    "baseline": {},
    "gather_head": {"gather_head": True},
    "block_q_512": {"block_q": 512},
    "block_q_1024": {"block_q": 1024},
    "remat_dots": {"remat_policy": "dots"},
    "gather_head+block_q_512": {"gather_head": True, "block_q": 512},
    "gather_head+remat_dots": {"gather_head": True, "remat_policy": "dots"},
    "all": {"gather_head": True, "block_q": 512, "remat_policy": "dots"},
    "mb_2": {"__microbatches": 2},
    "mb_1": {"__microbatches": 1},
    "gather_head+mb_2": {"gather_head": True, "__microbatches": 2},
    "cache_seq": {"shard_cache_seq": True},
    "cache_seq+gather_head": {"shard_cache_seq": True, "gather_head": True},
    "pad_heads": {"pad_heads": True},
    "pad_heads+block_q_512": {"pad_heads": True, "block_q": 512},
    "pad_heads+block_q_1024": {"pad_heads": True, "block_q": 1024},
}


def apply_variant(spec, overrides: Dict):
    arch_over = {k[2:]: v for k, v in overrides.items() if k.startswith("__")}
    lm_over = {k: v for k, v in overrides.items() if not k.startswith("__")}
    if lm_over:
        spec = dataclasses.replace(spec, lm=dataclasses.replace(spec.lm, **lm_over))
    if arch_over:
        spec = dataclasses.replace(spec, **arch_over)
    return spec


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variants", default="baseline,gather_head")
    ap.add_argument("--out", default="build/dryrun/perf.json")
    args = ap.parse_args(argv)

    results = []
    for name in args.variants.split(","):
        spec = apply_variant(get_arch(args.arch), VARIANTS[name])
        r = run_one(args.arch, args.shape, spec=spec)
        r["variant"] = name
        results.append(r)
        if r["status"] == "ok":
            log.info(
                "%-28s comp=%.3es mem=%.3es coll=%.3es dev_mem=%.2fGB dom=%s",
                name, r["compute_s"], r["memory_s"], r["collective_s"],
                r["memory"]["total_gb"], r["dominant"],
            )

    existing = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            existing = json.load(f)
    existing.extend(results)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(existing, f, indent=1)
    print(f"appended {len(results)} variants -> {args.out}")


if __name__ == "__main__":
    main()
