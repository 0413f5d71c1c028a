"""Fused on-device walk -> pair -> ego sampling (the device-resident pipeline).

The port of ``repro.sampling.fused``. The host pipeline ships every batch
from numpy; for graphs whose padded adjacency fits in device memory the
whole sampling front end runs as device ops over resident tables instead,
inside the training step, with no host work per step:

- **walk**: ``walk.metapath.walk_multi_from_bits`` over a stacked
  (R, N, max_degree) padded adjacency, with a per-walk metapath draw
  (uniform over the configured metapaths) and per-metapath start ranges;
- **pair**: the static skip-gram window gather (the ``window_pairs`` kernel
  on the card, its plain version on the CPU), then a uniform inverse-CDF
  draw of ``batch_pairs`` valid pairs;
- **ego**: relation-wise K-hop gathers from the same padded adjacency,
  PAD-propagating exactly like ``sampling.ego.sample_ego_batch``;
- **side info**: value slots as a resident (N, max_values) padded table, bag
  slots as the (N, vocab) count matrices the host 'bag' path uses.

The batch has the fixed-shape PAD-padded layout ``core.model.loss_fn``
consumes. Distribution contract vs the host pipeline: identical walk, pair
and ego-child distributions; batches are drawn per step rather than carried
across rounds, and repeated pair endpoints get fresh ego samples.

Draws are split from the transform. ``draw(generator)`` takes every random
input of one batch (``FusedDraws``: integers in ``[0, 2**32)`` held as
int64, and the random negatives as ids) from an explicit
``torch.Generator``; ``sample_from(draws)`` is the deterministic rest, the
same function of the bits as ``repro``'s ``sample(key)`` is of the bits its
``jax.random`` calls draw. ``bits % n`` on non-negative int64 equals JAX's
uint32 modulo, so the tests feed both packages one key's bits and hold the
batches bitwise. Every step of ``sample_from`` is a device op: no host sync.

Eligibility: the tables cost ``R * N * (max_degree + 1)`` int32s plus the
slot and count tables; ``fused_eligibility`` sizes them against a budget so
the trainer can fall back to the host pipeline for graphs that do not fit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.embedding import table as emb
from repro_torch.graph.hetero_graph import HeteroGraph, Relation
from repro_torch.kernels import ops as kernel_ops
from repro_torch.sampling.pairs import window_positions
from repro_torch.sampling.pipeline import PipelineConfig
from repro_torch.walk.metapath import parse_metapath, walk_multi_from_bits

PAD = -1
BITS_HIGH = 2**32  # draws are uniform integers in [0, 2**32), JAX's uint32 range


@dataclasses.dataclass(frozen=True)
class FusedConfig:
    """Knobs of the fused device sampler (threaded from TrainerConfig).

    ``repro``'s ``use_kernel_pairs`` is not here: the device decides (the
    ``window_pairs`` kernel on the card, its plain version on the CPU)."""

    # Padded-adjacency width: rows wider than this are uniformly subsampled
    # once at build time (HeteroGraph.padded_adjacency).
    max_degree: int = 32
    # Device-table budget for the eligibility check, in MiB.
    budget_mb: float = 256.0
    # Candidate pairs generated per emitted pair (safety factor against
    # PAD-invalidated candidates). Walks per batch =
    # ceil(oversample * batch_pairs / window_positions).
    oversample: float = 2.0


@dataclasses.dataclass
class FusedDraws:
    """Every random input of one fused batch.

    Bits are int64 tensors of integers in ``[0, 2**32)``: ``path`` and
    ``start`` (W,) pick each walk's metapath and start node, ``walk``
    (max(L - 1, 1), W) its neighbor offsets, ``sel`` (P,) the pair draw.
    ``ego`` maps each ego part (``"shared"`` for the shared towers of
    ``walk_ego_pair``, else ``"src"``/``"dst"``, and ``"neg"``) to one
    (B, W_k, R, fanout_k) bits tensor per hop. ``neg`` holds the (P, M)
    random-negative node ids (``neg_mode="random"``).
    """

    path: torch.Tensor
    start: torch.Tensor
    walk: torch.Tensor
    sel: torch.Tensor
    ego: Dict[str, List[torch.Tensor]]
    neg: Optional[torch.Tensor] = None

    def to(self, device: DeviceLike) -> "FusedDraws":
        dev = torch.device(device)
        return FusedDraws(
            path=self.path.to(dev), start=self.start.to(dev), walk=self.walk.to(dev),
            sel=self.sel.to(dev),
            ego={k: [b.to(dev) for b in v] for k, v in self.ego.items()},
            neg=None if self.neg is None else self.neg.to(dev),
        )


def _union_relations(config: PipelineConfig) -> List[str]:
    rels = {r for mp in config.walk.metapaths for r in parse_metapath(mp)}
    if config.ego is not None:
        rels |= set(config.ego.relations)
    return sorted(rels)


def fused_device_bytes(
    graph: HeteroGraph,
    config: PipelineConfig,
    value_slots: Sequence[emb.SlotSpec] = (),
    bag_slots: Sequence[emb.SlotSpec] = (),
    max_degree: int = 32,
) -> int:
    """Bytes of device-resident tables the fused sampler would build."""
    N = graph.num_nodes
    R = len(_union_relations(config))
    total = R * N * (max_degree + 1) * 4  # adjacency + degrees, int32
    for spec in value_slots:
        total += N * spec.max_values * 4  # padded value table, int32
    for spec in bag_slots:
        total += N * spec.vocab_size * 4  # count matrix, float32
    return total


def fused_eligibility(
    graph: HeteroGraph,
    config: PipelineConfig,
    value_slots: Sequence[emb.SlotSpec] = (),
    bag_slots: Sequence[emb.SlotSpec] = (),
    fused: FusedConfig = FusedConfig(),
    measured_bytes: Optional[int] = None,
) -> Tuple[bool, str]:
    """(eligible?, human-readable reason) for the memory-based gate.

    Without ``measured_bytes`` the gate runs on the shape-derived estimate
    (``fused_device_bytes``); once a sampler exists, callers re-check with
    ``measured_bytes=sampler.device_table_bytes()``, the footprint of the
    tensors actually resident, as the trainer does in ``_build_fused``.
    """
    if measured_bytes is not None:
        need, kind = int(measured_bytes), "measured"
    else:
        need = fused_device_bytes(
            graph, config, value_slots, bag_slots, max_degree=fused.max_degree
        )
        kind = "estimated"
    budget = int(fused.budget_mb * (1 << 20))
    if need > budget:
        return False, (
            f"padded device tables need {need / (1 << 20):.1f} MiB "
            f"({kind}) > budget {fused.budget_mb:.1f} MiB"
        )
    return True, f"device tables fit: {need / (1 << 20):.1f} MiB ({kind})"


class FusedSampler:
    """Device-resident walk->pair->ego sampler.

    Every table lives on ``device`` from construction on. Shapes are fully
    static: every batch carries exactly ``config.batch_pairs`` pairs.
    ``sample(generator)`` is ``sample_from(draw(generator))``.
    """

    def __init__(
        self,
        graph: HeteroGraph,
        config: PipelineConfig,
        value_slots: Sequence[emb.SlotSpec] = (),
        bag_slots: Sequence[emb.SlotSpec] = (),
        fused: FusedConfig = FusedConfig(),
        bag_counts: Optional[Mapping[str, torch.Tensor]] = None,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        if config.order not in ("walk_ego_pair", "walk_pair_ego"):
            raise ValueError(f"unknown order {config.order!r}")
        self.device = resolve_device(device)
        self.graph = graph
        self.config = config
        self.fused = fused
        self.value_slots = tuple(value_slots)
        self.bag_slots = tuple(bag_slots)
        self.ego = config.ego
        # Build-time seed for the padded-adjacency hub subsample: two
        # samplers built with the same seed share bitwise-identical tables.
        self.seed = seed

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        # ---------------- relation tables: one stacked padded adjacency
        self._rel_names = _union_relations(config)
        rel_id = {r: i for i, r in enumerate(self._rel_names)}
        adjs, degs = [], []
        for r in self._rel_names:
            a, d = graph.padded_adjacency(r, fused.max_degree, pad_id=PAD, seed=seed)
            adjs.append(a.astype(np.int32))
            degs.append(d.astype(np.int32))
        self._adj = put(np.stack(adjs))  # (R, N, max_degree)
        self._deg = put(np.stack(degs))  # (R, N)

        # ---------------- walk schedule + per-metapath start ranges
        paths = [parse_metapath(mp) for mp in config.walk.metapaths]
        if not paths:
            raise ValueError("need at least one metapath")
        L = config.walk.walk_len
        sched = np.zeros((len(paths), max(L - 1, 1)), dtype=np.int32)
        start_lo = np.zeros(len(paths), dtype=np.int32)
        start_cnt = np.zeros(len(paths), dtype=np.int32)
        for pi, rels in enumerate(paths):
            for s in range(max(L - 1, 1)):
                sched[pi, s] = rel_id[rels[s % len(rels)]]
            lo, cnt = graph.node_type_ranges[Relation.parse(rels[0]).src_type]
            start_lo[pi], start_cnt[pi] = lo, cnt
        self.num_paths = len(paths)
        self._sched = put(sched)
        self._start_lo = put(start_lo)
        self._start_cnt = put(start_cnt)

        # ---------------- pair stage: static window table + walk count
        self._positions = window_positions(L, config.pair.win_size)
        npos = max(len(self._positions), 1)
        self.num_walks = max(1, int(np.ceil(fused.oversample * config.batch_pairs / npos)))
        self._pos = put(self._positions.astype(np.int32).reshape(-1, 2))  # (npos, 2)
        self._spos = self._pos[:, 0].to(torch.int64)
        self._dpos = self._pos[:, 1].to(torch.int64)

        # ---------------- ego relation ids (indices into the stacked adj)
        if self.ego is not None:
            self._ego_rel_ids = [rel_id[r] for r in self.ego.relations]

        # ---------------- side-info tables
        self._slot_pad: Dict[str, torch.Tensor] = {}
        for spec in self.value_slots:
            sf = graph.slots[spec.name]
            self._slot_pad[spec.name] = put(emb.pad_slot_values(
                sf.indptr, sf.values, np.arange(graph.num_nodes, dtype=np.int64),
                spec.max_values, pad_id=PAD,
            ).astype(np.int32))
        self._bag_counts: Dict[str, torch.Tensor] = {}
        for s in self.bag_slots:
            if bag_counts is not None:
                self._bag_counts[s.name] = bag_counts[s.name].to(self.device)
            else:
                sf = graph.slots[s.name]
                self._bag_counts[s.name] = put(emb.slot_count_matrix(
                    sf.indptr, sf.values, graph.num_nodes, s.vocab_size, s.max_values))

    def device_table_bytes(self) -> int:
        """Measured footprint of the resident tables: what
        ``fused_eligibility(measured_bytes=...)`` gates on once the sampler
        exists (the position table counts as ``repro``'s spos + dpos)."""
        tables = [
            self._adj, self._deg, self._sched, self._start_lo, self._start_cnt,
            self._pos, *self._slot_pad.values(), *self._bag_counts.values(),
        ]
        return int(sum(t.numel() * t.element_size() for t in tables))

    # -------------------------------------------------------------- draws
    def _ego_parts(self) -> Dict[str, int]:
        """Ego part name -> its number of centers, in draw order."""
        cfg = self.config
        P = cfg.batch_pairs
        parts: Dict[str, int] = {}
        if self.ego is not None:
            if cfg.order == "walk_ego_pair":
                parts["shared"] = self.num_walks * cfg.walk.walk_len
            else:
                parts["src"] = parts["dst"] = P
            if cfg.pair.neg_mode == "random":
                parts["neg"] = P * cfg.pair.num_negatives
        return parts

    def ego_bits_shapes(self, centers: int) -> List[Tuple[int, int, int, int]]:
        """Per-hop (B, W_k, R, fanout_k) shapes of an ego part's bits."""
        R = len(self._ego_rel_ids)
        shapes, width = [], 1
        for fanout in self.ego.fanouts:
            shapes.append((centers, width, R, fanout))
            width *= R * fanout
        return shapes

    def draw(self, generator: torch.Generator) -> FusedDraws:
        """Every random input of one batch, on the sampler's device, from
        ``generator`` (which must live on that device)."""
        cfg = self.config
        W, P = self.num_walks, cfg.batch_pairs

        def bits(*shape) -> torch.Tensor:
            return torch.randint(0, BITS_HIGH, shape, generator=generator,
                                 device=self.device, dtype=torch.int64)

        path, start = bits(W), bits(W)
        walk = bits(max(cfg.walk.walk_len - 1, 1), W)
        sel = bits(P)
        ego = {name: [bits(*s) for s in self.ego_bits_shapes(n)]
               for name, n in self._ego_parts().items()}
        neg = None
        if cfg.pair.neg_mode == "random":
            neg = torch.randint(0, self.graph.num_nodes, (P, cfg.pair.num_negatives),
                                generator=generator, device=self.device, dtype=torch.int64)
        return FusedDraws(path=path, start=start, walk=walk, sel=sel, ego=ego, neg=neg)

    # ------------------------------------------------------------- stages
    def _slot_values(self, ids: torch.Tensor) -> Optional[Dict[str, torch.Tensor]]:
        """Device equivalent of ``core.model._slots_for_ids``: PAD ids map
        to all-PAD value rows; shape ids.shape + (max_values,)."""
        if not self.value_slots:
            return None
        out = {}
        for spec in self.value_slots:
            vals = self._slot_pad[spec.name][ids.clamp(min=0)].to(torch.int64)
            out[spec.name] = torch.where((ids >= 0)[..., None], vals, PAD)
        return out

    def _ego_levels(self, bits: Sequence[torch.Tensor],
                    centers: torch.Tensor) -> List[torch.Tensor]:
        """Relation-wise K-hop gather from per-hop ``bits``; PAD frontier
        slots propagate PAD, level layout identical to
        ``sampling.ego.sample_ego_batch``."""
        levels = [centers.to(torch.int64)[:, None]]
        frontier = levels[0]
        for k, fanout in enumerate(self.ego.fanouts):
            B, W = frontier.shape
            safe = frontier.clamp(min=0)
            outs = []
            for ri, rid in enumerate(self._ego_rel_ids):
                deg = self._deg[rid][safe].to(torch.int64)  # (B, W)
                off = bits[k][:, :, ri] % deg.clamp(min=1)[..., None]
                child = self._adj[rid][safe[..., None], off].to(torch.int64)  # (B, W, fanout)
                ok = (frontier >= 0) & (deg > 0)
                outs.append(torch.where(ok[..., None], child, PAD))
            nxt = torch.stack(outs, dim=2)  # (B, W, R, fanout)
            levels.append(nxt.reshape(B, W * len(outs) * fanout))
            frontier = levels[-1]
        return levels

    def _part(self, bits: Optional[Sequence[torch.Tensor]], ids: torch.Tensor):
        """One batch part in the ``loss_fn`` layout: (ids, slots) for
        walk-based models, (levels, per-level slots) for GNNs."""
        if self.ego is None:
            return (ids, self._slot_values(ids))
        levels = self._ego_levels(bits, ids)
        slots = None
        if self.value_slots:
            slots = [self._slot_values(l) for l in levels]
        return (levels, slots)

    # ------------------------------------------------------------- sample
    def sample(self, generator: torch.Generator) -> Dict:
        """One fixed-shape training batch drawn from ``generator``."""
        return self.sample_from(self.draw(generator))

    def sample_from(self, draws: FusedDraws) -> Dict:
        """One fixed-shape training batch from its draws (device ops only)."""
        cfg = self.config
        L = cfg.walk.walk_len

        # walk: per-walk metapath draw, then the multi-metapath walk
        path_of = draws.path % self.num_paths
        starts = self._start_lo[path_of] + draws.start % self._start_cnt[path_of]
        paths = walk_multi_from_bits(draws.walk, self._adj, self._deg, starts,
                                     self._sched, path_of, L)

        # pair: static window gather, then draw batch_pairs valid candidates
        src_all, dst_all = kernel_ops.window_pair_ids(paths, self._pos)
        src_f, dst_f = src_all.reshape(-1), dst_all.reshape(-1)
        # Uniform draw of batch_pairs candidates from the VALID ones by
        # inverse CDF (with replacement: the host pipeline also repeats a
        # pair that appears in several walks). n_valid stays on the device.
        cum = torch.cumsum(src_f != PAD, dim=0)
        n_valid = cum[-1]
        r = draws.sel % n_valid.clamp(min=1)
        idx = torch.searchsorted(cum, r + 1).clamp(max=src_f.shape[0] - 1)
        # an all-dead round keeps the pairs PAD: they embed to zero rows
        all_dead = n_valid == 0
        src = torch.where(all_dead, PAD, src_f[idx].to(torch.int64))
        dst = torch.where(all_dead, PAD, dst_f[idx].to(torch.int64))

        out: Dict = {}
        if self.ego is not None and cfg.order == "walk_ego_pair":
            # One ego per (walk, position), and the selected pairs index the
            # shared towers, as the host ego-first pipeline does; an
            # all-dead round PADs the towers themselves.
            npos = len(self._positions)
            flat_levels = [torch.where(all_dead, PAD, l)
                           for l in self._ego_levels(draws.ego["shared"], paths.reshape(-1))]
            slots = ([self._slot_values(l) for l in flat_levels]
                     if self.value_slots else None)
            out["shared"] = (flat_levels, slots)
            row = idx // npos
            pcol = idx % npos
            out["src_sel"] = row * L + self._spos[pcol]
            out["dst_sel"] = row * L + self._dpos[pcol]
        else:
            out["src"] = self._part(draws.ego.get("src"), src)
            out["dst"] = self._part(draws.ego.get("dst"), dst)
        if cfg.pair.neg_mode == "random":
            out["neg"] = self._part(draws.ego.get("neg"), draws.neg.reshape(-1))
        if self._bag_counts:
            out["slot_counts"] = dict(self._bag_counts)
        return out
