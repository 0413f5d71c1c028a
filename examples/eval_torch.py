"""Multi-scenario recall evaluation with the PyTorch port: model x dataset x
strategy sweep.

    PYTHONPATH=src:examples python examples/eval_torch.py \
        --datasets toy,ub --models lightgcn,metapath2vec \
        --steps 200 --method device --report build/recall.json \
        --markdown build/recall.md

The port's counterpart of ``examples/eval_recsys.py`` (paper §4.2): for every
(dataset, model) scenario it trains (or loads exported embeddings), embeds
every node (``repro_torch.infer``), evaluates every recall strategy
(``repro_torch.core.recall``) and writes a JSON report and a markdown table
(``repro_torch.launch.recall_report``). ``--method device`` searches with
the ``topk`` kernel, ``--method ivf`` with an IVF index on the
``ivf_list_topk`` kernel, ``--method bruteforce`` with the numpy oracle.
``--load-embeddings`` / ``--export-embeddings`` skip or persist the
inference stage in ``repro``'s sharded npz, so either package reads the
other's. ``--trace`` writes one Perfetto-loadable trace of every scenario.

It runs on the card; ``--device cpu`` (or ``run(args, device="cpu")``) runs
the plain PyTorch path. ``--engine-backend mp`` samples from the
shared-memory graph service (``--engine-workers`` processes), with the
in-process engine's batches, bitwise.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional

from recall_torch import RELS, WALK_MODELS, train_pairs
from repro_torch.core.hetero import HeteroGNNConfig
from repro_torch.core.model import Graph4RecConfig, Graph4RecModel
from repro_torch.core.recall import evaluate_recall
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.embedding import EmbeddingConfig
from repro_torch.graph import SPECS, DistributedGraphEngine, generate
from repro_torch.infer import embed_all_nodes, export_embeddings, load_embeddings
from repro_torch.launch.recall_report import render_recall_report
from repro_torch.obs import Telemetry
from repro_torch.retrieval import IVFConfig
from repro_torch.sampling import EgoConfig, PairConfig, PipelineConfig
from repro_torch.train import Graph4RecTrainer, TrainerConfig
from repro_torch.walk import WalkConfig


def build_trainer(ds, model: str, steps: int, dim: int = 32, seed: int = 0,
                  device: DeviceLike = None, telemetry=None,
                  **cfg_overrides) -> Graph4RecTrainer:
    """The scenario trainer ``eval_recsys.py`` builds: ``model`` (a zoo GNN or
    a walk model) at ``dim`` on two click relations, 256 pairs a batch.
    ``cfg_overrides`` replace ``TrainerConfig`` fields; under
    ``engine_backend="mp"`` the trainer gets the bare graph and partitions it
    into shared memory for its workers."""
    walk_based = model in WALK_MODELS
    mc = Graph4RecConfig(
        embedding=EmbeddingConfig(num_nodes=ds.graph.num_nodes, dim=dim),
        gnn=None if walk_based else HeteroGNNConfig(
            gnn_type=model, num_relations=2, num_layers=2, dim=dim),
        fanouts=() if walk_based else (4, 3),
        relations=RELS,
    )
    pc = PipelineConfig(
        walk=WalkConfig(metapaths=["u2click2i - i2click2u"], walk_len=6),
        pair=PairConfig(win_size=2),
        ego=None if walk_based else EgoConfig(relations=list(RELS), fanouts=[4, 3]),
        batch_pairs=256,
    )
    cfg = dataclasses.replace(
        TrainerConfig(num_steps=steps, log_every=0, sparse_lr=1.0, seed=seed,
                      eval_at_end=False, telemetry=telemetry), **cfg_overrides)
    engine = (ds.graph if cfg.engine_backend == "mp"
              else DistributedGraphEngine(ds.graph, num_partitions=4))
    return Graph4RecTrainer(ds, engine, mc, pc, cfg, device=device)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--datasets", default="toy", help=f"comma list from {sorted(SPECS)}")
    ap.add_argument("--models", default="lightgcn,metapath2vec",
                    help="comma list of zoo GNNs and/or walk models")
    ap.add_argument("--strategies", default="icf,ucf,u2i")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--top-k", type=int, default=100)
    ap.add_argument("--top-n", type=int, default=20)
    ap.add_argument("--method", default="device", choices=["device", "ivf", "bruteforce"],
                    help="retrieval implementation (see repro_torch/core/recall.py)")
    ap.add_argument("--ivf-nlist", type=int, default=64)
    ap.add_argument("--ivf-nprobe", type=int, default=8)
    ap.add_argument("--split", default="test", choices=["val", "test"])
    ap.add_argument("--engine-backend", default="inproc", choices=["inproc", "mp"],
                    help="'mp' serves partitions from shared-memory worker processes "
                         "(repro_torch.graph.service) instead of in-process")
    ap.add_argument("--engine-workers", type=int, default=2,
                    help="worker processes for --engine-backend=mp")
    ap.add_argument("--export-embeddings", default=None, metavar="PATH",
                    help="save each scenario's (num_nodes, dim) matrix as sharded npz: "
                         "PATH.<dataset>.<model>.npz")
    ap.add_argument("--load-embeddings", default=None, metavar="PATH",
                    help="skip training+inference; evaluate a matrix saved by "
                         "--export-embeddings (single scenario only)")
    ap.add_argument("--trace", default=None, metavar="OUT.JSON",
                    help="enable the telemetry layer (repro_torch.obs) across every "
                         "scenario and write one Perfetto-loadable Chrome trace here")
    ap.add_argument("--report", default=None, help="write JSON results here")
    ap.add_argument("--markdown", default=None, help="write rendered table here")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def run(args: argparse.Namespace, device: DeviceLike = None) -> dict:
    """The sweep; returns the report payload, the markdown table, the
    telemetry and the paths written. ``device`` (or ``--device``) None is
    CUDA."""
    dev = resolve_device(device if device is not None else args.device)
    strategies = tuple(args.strategies.split(","))
    ivf = IVFConfig(nlist=args.ivf_nlist, nprobe=args.ivf_nprobe, seed=args.seed)
    telemetry: Optional[Telemetry] = Telemetry() if args.trace else None
    results, exported = [], []
    for ds_name in args.datasets.split(","):
        ds = generate(SPECS[ds_name], seed=args.seed)
        pairs = train_pairs(ds)
        eval_pairs = ds.test_pairs if args.split == "test" else ds.val_pairs
        for model in args.models.split(","):
            train_s = 0.0
            if args.load_embeddings:
                t0 = time.perf_counter()
                emb = load_embeddings(args.load_embeddings)
                embed_s = time.perf_counter() - t0
            else:
                trainer = build_trainer(ds, model, args.steps, args.dim, args.seed,
                                        device=dev, telemetry=telemetry,
                                        engine_backend=args.engine_backend,
                                        num_engine_workers=args.engine_workers)
                with trainer:  # reaps the mp engine's workers
                    t0 = time.perf_counter()
                    res = trainer.train()
                    train_s = time.perf_counter() - t0
                    t0 = time.perf_counter()
                    emb = embed_all_nodes(Graph4RecModel(trainer.model_cfg, res.params),
                                          trainer.engine, ds.graph, seed=args.seed,
                                          device=dev)
                    embed_s = time.perf_counter() - t0
            if args.export_embeddings:
                path = export_embeddings(f"{args.export_embeddings}.{ds_name}.{model}", emb,
                                         num_shards=4)
                exported.append(path)
                print(f"exported {ds_name}/{model} embeddings -> {path}")
            t0 = time.perf_counter()
            metrics = evaluate_recall(
                emb[: ds.num_users], emb[ds.num_users : ds.num_users + ds.num_items],
                pairs, eval_pairs, top_k=args.top_k, top_n=args.top_n,
                strategies=strategies, method=args.method, device=dev, ivf=ivf,
                telemetry=telemetry)
            eval_s = time.perf_counter() - t0
            results.append({
                "dataset": ds_name, "model": model, "method": args.method,
                "top_k": args.top_k, "num_users": ds.num_users, "num_items": ds.num_items,
                "metrics": metrics, "train_s": round(train_s, 3),
                "embed_s": round(embed_s, 3), "eval_s": round(eval_s, 3),
            })
            shown = {k: round(v, 4) for k, v in metrics.items() if "_" not in k}
            print(f"{ds_name}/{model} [{args.method}] {shown} (train {train_s:.1f}s, "
                  f"embed {embed_s:.1f}s, eval {eval_s:.1f}s)")
    trace = None
    if telemetry is not None:
        print(telemetry.text_summary())
        trace = telemetry.write_trace(args.trace)
        print("trace ->", trace, "(open in https://ui.perfetto.dev)")
    payload = {"split": args.split, "seed": args.seed, "results": results}
    if args.report:
        with open(args.report, "w") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")
        print("report ->", args.report)
    table = render_recall_report(results)
    if args.markdown:
        with open(args.markdown, "w") as f:
            f.write(table + "\n")
        print("markdown ->", args.markdown)
    return {"payload": payload, "markdown": table, "telemetry": telemetry, "trace": trace,
            "exported": exported, "device": str(dev)}


def main() -> None:
    args = parser().parse_args()
    res = run(args)
    if not args.markdown:
        print()
        print(res["markdown"])


if __name__ == "__main__":
    main()
