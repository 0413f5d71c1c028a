"""Recsys training on a CUDA card with the PyTorch port (``repro_torch``).

    PYTHONPATH=src python examples/train_torch.py --dataset ub --model lightgcn \
        --dim 64 --batch-pairs 512 --steps 200 --side-info --save build/model.npz

The port's counterpart of ``examples/train_recsys.py``, with the flags of it
that the port supports: walk → pair → ego sampling on the host or, with
``--sampling-backend fused``, on the device inside the step (the
``window_pairs`` kernel for the pairs), the GNN forward and
backward with the ``seg_aggr`` kernels, the in-batch softmax loss on the
``inbatch_loss`` kernel, row-wise AdaGrad on the tables (the ``row_adagrad``
kernel on the sparse path) and Adam on the GNN weights, then recall of the
trained embeddings. ``--save`` writes ``repro``'s flat ``.npz`` layout, which
``repro.train.checkpoint.load_flat`` and ``examples/recall_torch.py
--params`` both read. A machine without CUDA raises; ``run(args,
device="cpu")`` runs the plain PyTorch path.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

from recall_torch import GNN_MODELS, RELS, WALK_MODELS, model_config
from repro_torch import convert
from repro_torch.device import DeviceLike
from repro_torch.graph import SPECS, DistributedGraphEngine, generate
from repro_torch.sampling import EgoConfig, PairConfig, PipelineConfig
from repro_torch.train import Graph4RecTrainer, TrainerConfig
from repro_torch.walk import WalkConfig


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="toy", choices=list(SPECS))
    ap.add_argument("--model", default="lightgcn", choices=WALK_MODELS + GNN_MODELS)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--batch-pairs", type=int, default=256)
    ap.add_argument("--neg-mode", default="inbatch", choices=["inbatch", "random"])
    ap.add_argument("--order", default="walk_ego_pair",
                    choices=["walk_ego_pair", "walk_pair_ego"])
    ap.add_argument("--side-info", action="store_true")
    ap.add_argument("--partitions", type=int, default=4,
                    help="graph engine partitions (simulated servers)")
    ap.add_argument("--sampling-backend", default="host", choices=["host", "fused", "auto"],
                    help="'fused' samples walk->pair->ego on the device inside the "
                         "step when the graph fits the padded-adjacency budget "
                         "(falls back to 'host' otherwise); 'auto' lets start-of-run "
                         "calibration choose")
    ap.add_argument("--prefetch-batches", type=int, default=None,
                    help="prefetch queue depth; 0 = serial loop; unset = let the "
                         "calibrated backend plan decide")
    ap.add_argument("--save", default=None, metavar="CKPT.npz")
    ap.add_argument("--eval-recall", default="device",
                    choices=["device", "ivf", "bruteforce"],
                    help="retrieval path for the final recall evaluation: 'device' = "
                         "the streaming top-k kernel over every held-out user, 'ivf' = "
                         "the default IVF index (ivf_list_topk kernel), "
                         "'bruteforce' = the O(U*I) numpy oracle")
    ap.add_argument("--eval-max-users", type=int, default=0,
                    help="cap evaluated users (0 = all)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def configs(ds, args: argparse.Namespace):
    """(model config, pipeline config) as ``train_recsys.py`` builds them."""
    walk_based = args.model in WALK_MODELS
    # DeepWalk walks one relation pair; metapath2vec adds the behaviour
    # metapaths (paper §3.2)
    metapaths = ["u2click2i - i2click2u"]
    if args.model != "deepwalk":
        metapaths += [f"u2{b}2i - i2{b}2u" for b in ("buy",)
                      if f"u2{b}2i" in ds.graph.relations]
    model_cfg = dataclasses.replace(
        model_config(ds.graph, args.model, args.dim, args.side_info),
        loss="inbatch_softmax" if args.neg_mode == "inbatch" else "neg_sampling",
    )
    pipe_cfg = PipelineConfig(
        walk=WalkConfig(metapaths=metapaths, walk_len=6),
        pair=PairConfig(win_size=2, neg_mode=args.neg_mode),
        ego=None if walk_based else EgoConfig(relations=list(RELS), fanouts=[4, 3]),
        order=args.order, batch_pairs=args.batch_pairs,
    )
    return model_cfg, pipe_cfg


def run(args: argparse.Namespace, device: DeviceLike = None, **trainer_overrides) -> dict:
    """Train, evaluate and (``--save``) checkpoint; returns the results.
    ``trainer_overrides`` replace fields of the ``TrainerConfig`` the flags
    build (``sparse_min_rows=0`` forces the sparse step)."""
    ds = generate(SPECS[args.dataset], seed=args.seed)
    engine = DistributedGraphEngine(ds.graph, num_partitions=args.partitions)
    model_cfg, pipe_cfg = configs(ds, args)
    tcfg = TrainerConfig(num_steps=args.steps, sparse_lr=1.0, log_every=50, seed=args.seed,
                         prefetch_batches=args.prefetch_batches,
                         sampling_backend=args.sampling_backend,
                         eval_method=args.eval_recall, eval_max_users=args.eval_max_users)
    trainer = Graph4RecTrainer(ds, engine, model_cfg, pipe_cfg,
                               dataclasses.replace(tcfg, **trainer_overrides), device=device)
    t0 = time.perf_counter()
    result = trainer.train()
    train_s = time.perf_counter() - t0
    saved = None
    if args.save:
        saved = convert.save(args.save, {k: v.detach().cpu().numpy()
                                         for k, v in result.params.items()})
    return {"dataset": ds, "config": model_cfg, "trainer": trainer, "result": result,
            "train_s": train_s, "saved": saved}


def main() -> None:
    args = parser().parse_args()
    res = run(args)
    r = res["result"]
    print("plan:", r.plan["reason"])
    print(f"{len(r.losses)} steps, {r.pairs_seen} pairs in {r.wall_time_s:.2f}s "
          f"({r.pairs_seen / r.wall_time_s:.0f} pairs/s); loss {r.losses[0]:.4f} -> "
          f"{r.losses[-1]:.4f}")
    if r.eval_history:
        print("recall:", json.dumps({k: round(v, 4) for k, v in r.eval_history[-1].items()}))
    if res["saved"]:
        print("saved", res["saved"])


if __name__ == "__main__":
    main()
