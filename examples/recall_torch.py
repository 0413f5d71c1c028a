"""Recall serving on a CUDA card with the PyTorch port (``repro_torch``).

    PYTHONPATH=src python examples/recall_torch.py --dataset ub --dim 64 \
        --side-info --params /tmp/model.npz

Generates the dataset, takes the model's parameters from a checkpoint that
``examples/train_recsys.py --save`` wrote (``--params``) or draws them from
``--seed``, embeds every node on the card (``repro_torch.infer``, the
``seg_aggr`` kernel), and evaluates U2I/ICF/UCF recall
(``repro_torch.core.recall``) with the streaming ``topk`` kernel
(``--method device``), an IVF index on the ``ivf_list_topk`` kernel
(``--method ivf``, ``--ivf-nlist`` cells, ``--ivf-nprobe`` probed) or the
numpy brute force. ``--device cpu`` runs the plain PyTorch path instead;
without it a machine with no CUDA raises.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core.hetero import HeteroGNNConfig
from repro_torch.core.model import Graph4RecConfig
from repro_torch.core.recall import evaluate_recall
from repro_torch.device import resolve_device
from repro_torch.embedding import EmbeddingConfig, SlotSpec
from repro_torch.graph import SPECS, DistributedGraphEngine, generate
from repro_torch.infer import embed_all_nodes
from repro_torch.retrieval import IVFConfig

WALK_MODELS = ("deepwalk", "metapath2vec")
GNN_MODELS = ("lightgcn", "sage-mean", "sage-sum", "gat", "gin", "ngcf", "gatne")
RELS = ("u2click2i", "i2click2u")


def model_config(graph, model: str = "lightgcn", dim: int = 32,
                 side_info: bool = False) -> Graph4RecConfig:
    """The configuration ``examples/train_recsys.py`` trains, for ``model``."""
    walk_based = model in WALK_MODELS
    slots = (SlotSpec("slot0", 64, 3), SlotSpec("slot1", 64, 3)) if side_info else ()
    return Graph4RecConfig(
        embedding=EmbeddingConfig(num_nodes=graph.num_nodes, dim=dim, slots=slots),
        gnn=None if walk_based else HeteroGNNConfig(
            gnn_type={"gatne": "lightgcn"}.get(model, model), num_relations=2,
            num_layers=2, dim=dim,
            relation_agg="gatne" if model == "gatne" else "uniform"),
        fanouts=() if walk_based else (4, 3),
        relations=RELS,
        use_side_info=side_info,
    )


def train_pairs(ds) -> np.ndarray:
    """(Nt, 2) local (user, item) train interactions, as the trainer builds them."""
    return np.concatenate([np.stack([u, i], 1) for (u, i) in ds.train_edges.values()], 0)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="toy", choices=list(SPECS))
    ap.add_argument("--model", default="lightgcn", choices=WALK_MODELS + GNN_MODELS)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--side-info", action="store_true")
    ap.add_argument("--params", default=None, metavar="CKPT.npz",
                    help="repro checkpoint (train_recsys.py --save); default: "
                         "fresh parameters from --seed")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--top-k", type=int, default=100)
    ap.add_argument("--method", default="device", choices=["device", "ivf", "bruteforce"],
                    help="retrieval implementation (see repro_torch/core/recall.py)")
    ap.add_argument("--ivf-nlist", type=int, default=64)
    ap.add_argument("--ivf-nprobe", type=int, default=8)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def run(args: argparse.Namespace) -> dict:
    """Embed every node, then evaluate recall; returns the results."""
    dev = resolve_device(args.device)
    ds = generate(SPECS[args.dataset], seed=args.seed)
    cfg = model_config(ds.graph, args.model, args.dim, args.side_info)
    if args.params:
        model = convert.params_from_numpy(convert.load_params(args.params), cfg, dev)
    else:
        model = convert.init_params(cfg, seed=args.seed, device=dev)
    engine = DistributedGraphEngine(ds.graph, num_partitions=4)

    t0 = time.perf_counter()
    emb = embed_all_nodes(model, engine, ds.graph, batch_size=args.batch_size,
                          seed=args.seed, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    embed_s = time.perf_counter() - t0

    user_emb = emb[: ds.num_users]
    item_emb = emb[ds.num_users : ds.num_users + ds.num_items]
    t0 = time.perf_counter()
    ivf = IVFConfig(nlist=args.ivf_nlist, nprobe=args.ivf_nprobe, seed=args.seed)
    recall = evaluate_recall(user_emb, item_emb, train_pairs(ds), ds.test_pairs,
                             top_k=args.top_k, method=args.method, device=dev, ivf=ivf)
    recall_s = time.perf_counter() - t0
    return {"dataset": ds, "config": cfg, "embeddings": emb, "recall": recall,
            "embed_s": embed_s, "recall_s": recall_s, "device": str(dev), "ivf": ivf}


def main() -> None:
    args = parser().parse_args()
    res = run(args)
    n = res["embeddings"].shape[0]
    print(f"embedded {n} nodes on {res['device']} in {res['embed_s']:.3f}s "
          f"({n / res['embed_s']:.0f} nodes/s)")
    print(f"recall@{args.top_k} ({res['recall_s']:.3f}s):",
          json.dumps({k: round(v, 4) for k, v in res["recall"].items()}))


if __name__ == "__main__":
    main()
