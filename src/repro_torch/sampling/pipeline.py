"""Training-sample pipeline: walk -> {pair, ego} in either order (§3.6).

Graph4Rec's "Walk, Sample, Pair: Order Matters" optimization: generating
pairs first and then sampling an ego graph per pair element costs O(wL) ego
samplings per path (repeated nodes re-sampled); sampling ego graphs per path
*position* first and letting pairs index into them costs O(L). The trade-off
is sample diversity (repeated nodes share one ego sample within a batch).
Both orders are implemented.

The pipeline emits fixed-size batches: exactly ``batch_pairs`` pairs per
batch; pairs beyond the last full batch of a round are carried into the
next round, never dropped.

A copy of the host half of ``repro.sampling.pipeline``: it draws the same
``np.random.Generator`` stream, so batches are bitwise equal to ``repro``'s
from one seed. ``make_train_sampler`` also builds the fused device sampler
(``sampling/fused.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from repro_torch.sampling.ego import EgoBatch, EgoConfig, sample_ego_batch
from repro_torch.sampling.pairs import (
    PairConfig,
    pairs_to_nodes,
    sample_random_negatives,
    window_pairs,
)
from repro_torch.walk.metapath import MetapathWalker, WalkConfig

PAD = -1

# ``batches`` raises after this many consecutive rounds with zero pairs
# instead of spinning forever on a degenerate walk/pair configuration.
_MAX_EMPTY_ROUNDS = 100


def _phase(timer, name: str):
    """Attribution scope: a ``PhaseTimer.phase`` when a timer is wired
    (train.attribution), a no-op context otherwise — zero hot-path cost
    for untimed runs."""
    return contextlib.nullcontext() if timer is None else timer.phase(name)


def _concat_egos(parts: Sequence[EgoBatch]) -> Optional[EgoBatch]:
    if not parts:
        return None
    if len(parts) == 1:
        return parts[0]
    return EgoBatch(
        parts[0].config,
        [
            np.concatenate([p.levels[k] for p in parts], axis=0)
            for k in range(len(parts[0].levels))
        ],
    )


@dataclasses.dataclass
class TrainBatch:
    """One contrastive training batch of ego-graph pairs (or bare id pairs)."""

    src_ids: np.ndarray  # (P,)
    dst_ids: np.ndarray  # (P,)
    neg_ids: Optional[np.ndarray]  # (P, M) random-negative mode, else None
    src_ego: Optional[EgoBatch]  # None for walk-only models
    dst_ego: Optional[EgoBatch]
    neg_ego: Optional[EgoBatch]  # (P*M,) flattened, random-negative mode w/ GNN


@dataclasses.dataclass
class PipelineConfig:
    walk: WalkConfig
    pair: PairConfig
    ego: Optional[EgoConfig] = None  # None -> walk-based model (skip ego stage)
    order: str = "walk_ego_pair"  # "walk_ego_pair" (fast) | "walk_pair_ego" (diverse)
    batch_pairs: int = 512
    walks_per_round: int = 64


def make_train_sampler(
    engine,
    config: "PipelineConfig",
    backend: str = "host",
    seed: int = 0,
    value_slots=(),
    bag_slots=(),
    fused_cfg=None,
    bag_counts=None,
    timer=None,
    device=None,
):
    """Sampling-backend factory for the trainer.

    ``backend="host"`` returns the streaming ``SamplePipeline`` over the
    given engine (HeteroGraph or DistributedGraphEngine), seeded by
    ``seed``; ``timer`` (anything with a ``phase(name)`` context manager)
    records its sampling cost under the "sample" phase. ``backend="fused"``
    returns a ``sampling.fused.FusedSampler`` over the engine's graph with
    its tables on ``device``: walk, pair and ego as device ops. Callers
    gate it with ``fused.fused_eligibility`` first (the trainer does, and
    falls back to "host" with a warning). ``seed`` reaches both backends:
    the host stream and the fused build-time adjacency subsample.
    """
    if backend == "host":
        return SamplePipeline(engine, config, seed=seed, timer=timer)
    if backend == "fused":
        from repro_torch.sampling.fused import FusedConfig, FusedSampler

        graph = engine.graph if hasattr(engine, "graph") else engine
        return FusedSampler(
            graph, config, value_slots=value_slots, bag_slots=bag_slots,
            fused=fused_cfg if fused_cfg is not None else FusedConfig(),
            bag_counts=bag_counts, seed=seed, device=device,
        )
    raise ValueError(f"unknown sampling backend {backend!r}")


class SamplePipeline:
    """Streams TrainBatches from a graph engine. CPU-side, feeds the device."""

    def __init__(
        self, engine, config: PipelineConfig, seed: int = 0, timer=None
    ):
        self.engine = engine
        self.config = config
        self.timer = timer  # optional train.attribution.PhaseTimer
        self.walker = MetapathWalker(engine, config.walk)
        self.rng = np.random.default_rng(seed)
        graph = engine.graph if hasattr(engine, "graph") else engine
        self._node_range = (0, graph.num_nodes)
        # stats mirrored from ego sampling for RQ5 accounting
        self.ego_sampling_ops = 0

    # ------------------------------------------------------------------ round
    def _round(self) -> Iterator[Tuple[np.ndarray, np.ndarray, Optional[EgoBatch], Optional[EgoBatch]]]:
        cfg = self.config
        paths = self.walker.generate(self.rng, cfg.walks_per_round)
        pairs = window_pairs(paths, cfg.pair.win_size)
        if len(pairs) == 0:
            return
        self.rng.shuffle(pairs)
        if cfg.ego is None:
            src, dst = pairs_to_nodes(paths, pairs)
            yield src, dst, None, None
            return

        if cfg.order == "walk_ego_pair":
            # O(L): one ego sample per (path, position); pairs reference them.
            B, L = paths.shape
            flat_nodes = paths.reshape(-1)
            valid = flat_nodes != PAD
            egos_flat = sample_ego_batch(
                self.rng, self.engine, np.where(valid, flat_nodes, 0), cfg.ego
            )
            self.ego_sampling_ops += int(valid.sum())
            src_idx = pairs[:, 0] * L + pairs[:, 1]
            dst_idx = pairs[:, 0] * L + pairs[:, 2]
            src, dst = pairs_to_nodes(paths, pairs)
            yield src, dst, egos_flat.take(src_idx), egos_flat.take(dst_idx)
        elif cfg.order == "walk_pair_ego":
            # O(wL): fresh ego sample per pair endpoint (more diversity).
            src, dst = pairs_to_nodes(paths, pairs)
            src_ego = sample_ego_batch(self.rng, self.engine, src, cfg.ego)
            dst_ego = sample_ego_batch(self.rng, self.engine, dst, cfg.ego)
            self.ego_sampling_ops += len(src) + len(dst)
            yield src, dst, src_ego, dst_ego
        else:
            raise ValueError(f"unknown order {self.config.order!r}")

    # ---------------------------------------------------------------- batches
    def batches(self, num_batches: int) -> Iterator[TrainBatch]:
        """Emit exactly ``num_batches`` fixed-size batches.

        Pairs left over after chunking a round into ``batch_pairs``-sized
        batches are carried into the next round (never dropped), so rounds
        smaller than one batch still make progress and the loop always
        terminates as long as walks keep producing pairs.
        """
        cfg = self.config
        P = cfg.batch_pairs
        buf_src: list = []
        buf_dst: list = []
        buf_se: list = []
        buf_de: list = []
        have = 0
        emitted = 0
        empty_rounds = 0
        while emitted < num_batches:
            got = 0
            with _phase(self.timer, "sample"):
                for src, dst, se, de in self._round():
                    buf_src.append(src)
                    buf_dst.append(dst)
                    if se is not None:
                        buf_se.append(se)
                        buf_de.append(de)
                    got += len(src)
            have += got
            empty_rounds = empty_rounds + 1 if got == 0 else 0
            if empty_rounds >= _MAX_EMPTY_ROUNDS:
                raise RuntimeError(
                    f"{_MAX_EMPTY_ROUNDS} consecutive sampling rounds produced no "
                    "pairs; check walk_len/win_size against the graph"
                )
            if have < P:
                continue
            with _phase(self.timer, "sample"):
                src = np.concatenate(buf_src) if len(buf_src) > 1 else buf_src[0]
                dst = np.concatenate(buf_dst) if len(buf_dst) > 1 else buf_dst[0]
                se = _concat_egos(buf_se)
                de = _concat_egos(buf_de)
            n_full = have // P
            for bi in range(n_full):
                sl = slice(bi * P, (bi + 1) * P)
                yield self._finalize(
                    src[sl], dst[sl],
                    se.take(sl) if se is not None else None,
                    de.take(sl) if de is not None else None,
                )
                emitted += 1
                if emitted >= num_batches:
                    return
            # carry the sub-batch tail into the next round
            lo = n_full * P
            have -= lo
            buf_src = [src[lo:]] if have else []
            buf_dst = [dst[lo:]] if have else []
            tail = slice(lo, None)
            buf_se = [se.take(tail)] if se is not None and have else []
            buf_de = [de.take(tail)] if de is not None and have else []

    def _finalize(
        self,
        src: np.ndarray,
        dst: np.ndarray,
        src_ego: Optional[EgoBatch],
        dst_ego: Optional[EgoBatch],
    ) -> TrainBatch:
        cfg = self.config
        neg_ids = None
        neg_ego = None
        if cfg.pair.neg_mode == "random":
            with _phase(self.timer, "sample"):
                neg_ids = sample_random_negatives(
                    self.rng, len(src), cfg.pair.num_negatives, self._node_range
                )
                if cfg.ego is not None:
                    neg_ego = sample_ego_batch(
                        self.rng, self.engine, neg_ids.reshape(-1), cfg.ego
                    )
                    self.ego_sampling_ops += neg_ids.size
        return TrainBatch(
            src_ids=src, dst_ids=dst, neg_ids=neg_ids,
            src_ego=src_ego, dst_ego=dst_ego, neg_ego=neg_ego,
        )
