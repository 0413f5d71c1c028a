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
--params`` both read. ``--warm-start`` inherits pre-trained tables from a
``save_table`` npz (paper §3.6); ``--export-embeddings`` writes every node's
trained embedding as ``repro``'s sharded npz. ``--attribution`` prints the
per-step phase split, ``--trace`` writes a Perfetto-loadable trace and the
telemetry summary, ``--health`` arms the stall and loss watchdog.
``--engine-backend mp`` samples from the shared-memory graph service
(``repro_torch.graph.service``): CSR shards in ``/dev/shm`` served by
``--engine-workers`` spawned processes, rounds of at most
``--engine-local-threshold`` nodes answered in this process; the batches,
and so the losses, are the in-process engine's, bitwise. A machine
without CUDA raises; ``--device cpu`` (or ``run(args, device="cpu")``) runs
the plain PyTorch path.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

from recall_torch import GNN_MODELS, RELS, WALK_MODELS, model_config
from repro_torch import convert
from repro_torch.core.model import Graph4RecModel
from repro_torch.device import DeviceLike
from repro_torch.embedding import load_table, warm_start
from repro_torch.graph import SPECS, DistributedGraphEngine, GraphClient, generate
from repro_torch.graph.service.shm import shm_free_bytes
from repro_torch.infer import embed_all_nodes, export_embeddings
from repro_torch.obs import HealthConfig, Telemetry
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
    ap.add_argument("--engine-backend", default="inproc", choices=["inproc", "mp"],
                    help="'mp' serves partitions from shared-memory worker processes "
                         "(repro_torch.graph.service) instead of in-process")
    ap.add_argument("--engine-workers", type=int, default=2,
                    help="worker processes for --engine-backend=mp")
    ap.add_argument("--engine-local-threshold", type=int, default=8192,
                    help="mp backend: rounds with at most this many total nodes are "
                         "served in-process over the client's own shard views (0 = every "
                         "round goes to a worker)")
    ap.add_argument("--sampling-backend", default="host", choices=["host", "fused", "auto"],
                    help="'fused' samples walk->pair->ego on the device inside the "
                         "step when the graph fits the padded-adjacency budget "
                         "(falls back to 'host' otherwise); 'auto' lets start-of-run "
                         "calibration choose")
    ap.add_argument("--prefetch-batches", type=int, default=None,
                    help="prefetch queue depth; 0 = serial loop; unset = let the "
                         "calibrated backend plan decide")
    ap.add_argument("--attribution", action="store_true",
                    help="record per-step phase timings (sample/assemble/batch_wait/h2d/"
                         "dispatch/loss_fetch, and each step's span on the device "
                         "timeline) and print the breakdown after training")
    ap.add_argument("--trace", default=None, metavar="OUT.JSON",
                    help="enable the telemetry layer (repro_torch.obs) and write a "
                         "Perfetto-loadable Chrome trace here after training; also "
                         "prints the metrics/span text summary")
    ap.add_argument("--health", action="store_true",
                    help="enable the run-health guardrails (repro_torch.obs.health): a "
                         "watchdog thread that flight-records and fails the run on "
                         "stalls and NaN/diverging losses (dumps under flightrec/)")
    ap.add_argument("--stall-timeout", type=float, default=120.0,
                    help="--health: no completed step for this many seconds -> "
                         "flight-record dump + RunStalledError (size it above the "
                         "first step's kernel build)")
    ap.add_argument("--warm-start", default=None, metavar="NPZ",
                    help="npz of pre-trained tables (save_table)")
    ap.add_argument("--save", default=None, metavar="CKPT.npz")
    ap.add_argument("--eval-recall", default="device",
                    choices=["device", "ivf", "bruteforce"],
                    help="retrieval path for the final recall evaluation: 'device' = "
                         "the streaming top-k kernel over every held-out user, 'ivf' = "
                         "the default IVF index (ivf_list_topk kernel), "
                         "'bruteforce' = the O(U*I) numpy oracle")
    ap.add_argument("--eval-max-users", type=int, default=0,
                    help="cap evaluated users (0 = all)")
    ap.add_argument("--export-embeddings", default=None, metavar="PATH",
                    help="after training, embed every node and save the (num_nodes, "
                         "dim) matrix as a sharded npz (repro's layout)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
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
    """Train, evaluate, and (``--save``, ``--export-embeddings``, ``--trace``)
    write the checkpoint, the embeddings and the trace; returns the results,
    the attribution summary and the trace path among them.
    ``trainer_overrides`` replace fields of the ``TrainerConfig`` the flags
    build (``sparse_min_rows=0`` forces the sparse step). ``device`` (or
    ``--device``) None is CUDA."""
    device = device if device is not None else args.device
    ds = generate(SPECS[args.dataset], seed=args.seed)
    # mp: the bare graph, which the client partitions straight into shared
    # memory, with no in-process partition copies beside the workers' shards
    engine = (ds.graph if args.engine_backend == "mp"
              else DistributedGraphEngine(ds.graph, num_partitions=args.partitions))
    model_cfg, pipe_cfg = configs(ds, args)
    tcfg = TrainerConfig(num_steps=args.steps, sparse_lr=1.0, log_every=50, seed=args.seed,
                         engine_backend=args.engine_backend,
                         num_engine_workers=args.engine_workers,
                         num_engine_partitions=args.partitions,
                         engine_local_threshold=args.engine_local_threshold,
                         prefetch_batches=args.prefetch_batches,
                         sampling_backend=args.sampling_backend,
                         eval_method=args.eval_recall, eval_max_users=args.eval_max_users,
                         attribution=args.attribution,
                         telemetry=Telemetry() if args.trace else None,
                         health=(HealthConfig(stall_timeout_s=args.stall_timeout)
                                 if args.health else None))
    tcfg = dataclasses.replace(tcfg, **trainer_overrides)
    trainer = Graph4RecTrainer(ds, engine, model_cfg, pipe_cfg, tcfg, device=device)
    saved = exported = trace = None
    with trainer:  # reaps the mp engine's workers on exit and on error
        params = trainer.init_params()
        if args.warm_start:
            pre = load_table(args.warm_start)
            params = warm_start(params, {k if k.startswith("emb/") else f"emb/{k}": v
                                         for k, v in pre.items()})
        t0 = time.perf_counter()
        result = trainer.train(params)
        train_s = time.perf_counter() - t0
        if args.save:
            saved = convert.save(args.save, {k: v.detach().cpu().numpy()
                                             for k, v in result.params.items()})
        if args.export_embeddings:
            emb = embed_all_nodes(Graph4RecModel(model_cfg, result.params), trainer.engine,
                                  ds.graph, seed=args.seed, device=trainer.device)
            exported = export_embeddings(
                args.export_embeddings, emb, num_shards=4,
                meta={"dataset": np.bytes_(args.dataset), "model": np.bytes_(args.model)})
        engine_stats = engine_report(trainer.engine)
        if args.trace and tcfg.telemetry is not None:
            trace = tcfg.telemetry.write_trace(args.trace)
    return {"dataset": ds, "config": model_cfg, "trainer": trainer, "result": result,
            "train_s": train_s, "saved": saved, "exported": exported,
            "attribution": result.attribution, "telemetry": tcfg.telemetry, "trace": trace,
            "engine": engine_stats}


def engine_report(engine) -> dict:
    """The engine's request counters (the client mirrors the in-process
    engine's exactly) and, for the mp client, what its workers served, in
    how many rounds and how many in this process, their start time (spawn
    to the last ready), resident sets and whether they imported torch, the
    most slab slots in flight at once and ``/dev/shm``'s free bytes."""
    out = {"neighbor_requests": engine.stats.neighbor_requests,
           "cross_partition_requests": engine.stats.cross_partition_requests}
    if isinstance(engine, GraphClient):
        out["per_worker"] = [{k: s[k] for k in ("worker_id", "pid", "neighbor_requests",
                                                "batches", "busy_ns", "shm_replies",
                                                "pickle_replies", "rss_kb", "imports_torch")}
                             for s in engine.worker_stats()]
        out["workers"] = engine.aggregate_stats()
        out["start_s"] = engine.start_s
        out["slab_high_water"] = engine.slab_high_water
        out["shm_free_bytes"] = shm_free_bytes()  # with this run's segments mapped
    return out


def print_attribution(a: dict) -> None:
    """The per-step breakdown, as ``train_recsys.py --attribution`` prints it,
    plus the port's device span and each phase's thread CPU time."""
    print(f"attribution ({a['steps']} steps, {a['wall_us_per_step']:.0f}us/step, device "
          f"residual {a['device_residual_s'] / a['wall_s']:.0%}):")
    for phase, entry in a["phases"].items():
        print(f"  {phase:<11} {entry['per_call_us']:>10.1f}us/call x{entry['count']:<6} "
              f"frac_of_wall={entry.get('frac_of_wall', 0.0):.3f} "
              f"thread_cpu={a['thread_cpu_s'].get(phase, 0.0):.4f}s")
    if "device_span" in a:
        span = a["device_span"]["span_ms"]
        print(f"  device span {span['mean_ms']:.3f}ms/step (median {span['median_ms']:.3f}; "
              "the step's span on the device timeline, not busy time)")


def main() -> None:
    args = parser().parse_args()
    res = run(args)
    r = res["result"]
    print("plan:", r.plan["reason"])
    print(f"{len(r.losses)} steps, {r.pairs_seen} pairs in {r.wall_time_s:.2f}s "
          f"({r.pairs_seen / r.wall_time_s:.0f} pairs/s); loss {r.losses[0]:.4f} -> "
          f"{r.losses[-1]:.4f}")
    if args.warm_start:
        print(f"warm-started from {args.warm_start}")
    if res["attribution"]:
        print_attribution(res["attribution"])
    eng = res["engine"]
    print(f"engine: {eng['neighbor_requests']} neighbor requests, "
          f"{eng['cross_partition_requests']} cross-partition")
    if "workers" in eng:
        agg = eng["workers"]
        print(f"workers: {agg['num_workers']} procs served {agg['neighbor_requests']} queries "
              f"in {agg['batches']} request rounds ({agg['busy_s']:.2f}s busy, "
              f"{agg['local_neighbor_requests']} answered in-process); started in "
              f"{eng['start_s']:.2f}s")
        for w in eng["per_worker"]:
            print(f"  worker {w['worker_id']} (pid {w['pid']}): {w['batches']} rounds, "
                  f"{w['shm_replies']} shm / {w['pickle_replies']} pickled replies, RSS "
                  f"{w['rss_kb']} KiB, imports torch: {w['imports_torch']}")
    if r.eval_history:
        print("recall:", json.dumps({k: round(v, 4) for k, v in r.eval_history[-1].items()}))
    if res["telemetry"] is not None:
        print(res["telemetry"].text_summary())
        print("trace ->", res["trace"], "(open in https://ui.perfetto.dev)")
    if res["saved"]:
        print("saved", res["saved"])
    if res["exported"]:
        print(f"exported full-graph embeddings -> {res['exported']}")


if __name__ == "__main__":
    main()
