"""Two-stage warm-start workflow with the PyTorch port (paper §3.6, RQ6).

    PYTHONPATH=src:examples python examples/warm_start_torch.py [--device cpu]

The port's counterpart of ``examples/warm_start.py``. Stage 1 pre-trains the
node embeddings with metapath2vec (walks only, no ego graphs) and saves the
table with ``save_table``. Stage 2 trains LightGCN cold, then warm with the
table inherited through ``load_table`` and ``warm_start``, and compares
their recall. It runs on the card unless ``--device cpu``; the table goes
to ``--out`` (under ``build/`` by default).
"""
from __future__ import annotations

import argparse
import os
import time

from eval_torch import build_trainer
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.embedding import load_table, save_table, warm_start
from repro_torch.graph import SPECS, generate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="toy", choices=list(SPECS))
    ap.add_argument("--pretrain-steps", type=int, default=200)
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "warm_start", "mp2v.npz"),
                    metavar="NPZ", help="where stage 1 saves its node table")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def run(args: argparse.Namespace, device: DeviceLike = None) -> dict:
    """Both stages; returns the pre-training result and the cold and warm
    LightGCN results. ``device`` (or ``--device``) None is CUDA."""
    dev = resolve_device(device if device is not None else args.device)
    ds = generate(SPECS[args.dataset], seed=args.seed)
    # the benchmarks' trainer: prefetch 2, no calibration, recall at the end
    fixed = dict(prefetch_batches=2, auto_backend=False, eval_at_end=True)

    print("== stage 1: metapath2vec pre-training ==")
    walk_tr = build_trainer(ds, "metapath2vec", args.pretrain_steps, seed=args.seed,
                            device=dev, **fixed)
    t0 = time.perf_counter()
    walk_res = walk_tr.train()
    print(f"  {time.perf_counter() - t0:.1f}s,",
          {k: round(v, 4) for k, v in walk_res.eval_history[-1].items()})
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_table(args.out, {"node": walk_res.params["emb/node"]})

    print("== stage 2: LightGCN, cold vs warm ==")
    out = {"pretrain": walk_res, "table": args.out}
    for warm in (False, True):
        tr = build_trainer(ds, "lightgcn", args.steps, seed=args.seed, device=dev, **fixed)
        params = tr.init_params()
        if warm:
            params = warm_start(params, {f"emb/{k}": v for k, v in load_table(args.out).items()})
        res = tr.train(params)
        out["warm" if warm else "cold"] = res
        print(f"  {'warm' if warm else 'cold'}:",
              {k: round(v, 4) for k, v in res.eval_history[-1].items()})
    return out


def main() -> None:
    run(parser().parse_args())


if __name__ == "__main__":
    main()
