"""Distributed graph engine (Graph4Rec §3.1, "Distributed Graph Engine").

The paper partitions nodes uniformly across machines and stores each node's
adjacency list on its owning server; samplers issue (possibly remote) neighbor
requests. On TPU pods the graph engine remains a *host-side* component — it
never runs on the accelerator in the paper either — so we reproduce it as a
sharded NumPy engine with the same ownership semantics:

- nodes are assigned to partitions by ``node_id % num_partitions``;
- each partition holds CSR rows only for the nodes it owns;
- a batched ``sample_neighbors`` routes each query to its owner and gathers
  the replies, counting *cross-partition requests* — the communication the
  paper's §3.6 order-exchange optimization reduces. These counters are what
  benchmarks/bench_order.py reports alongside wall-clock.

The engine is API-compatible with ``HeteroGraph.sample_neighbors`` so the
sampling pipeline (repro/sampling) can run against either.

Randomness contract (shared with the out-of-process engine in
``graph/service``): a ``sample_neighbors``/``sample_many`` call draws ONE
64-bit seed per query from the caller's generator and derives an independent
per-partition generator ``default_rng([seed, part_id])`` for the actual
offset draws. Results therefore depend only on (caller stream, partition
contents) — never on which process answers a partition or how concurrent
callers interleave — which is what makes the multi-process backend
(``graph/service.GraphClient``) bitwise-identical to this one.

NumPy copy of ``repro.graph.engine`` for the PyTorch port: it draws the
identical stream, so both packages sample identical ego graphs from one seed.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.graph.hetero_graph import HeteroGraph
from repro_torch.utils.ragged import ragged_row_offsets

# Exclusive upper bound for the per-query seed draw (full int64 range).
SEED_BOUND = np.iinfo(np.int64).max


def partition_rng(seed: int, part_id: int) -> np.random.Generator:
    """The per-(query, partition) generator both engine backends use."""
    return np.random.default_rng([int(seed), int(part_id)])


def sample_csr_rows(
    indptr: np.ndarray,
    indices: np.ndarray,
    prng: np.random.Generator,
    local_rows: np.ndarray,
    num_samples: int,
    pad_id: int,
) -> np.ndarray:
    """Uniform with-replacement sampling from CSR rows — the one primitive
    every partition server runs."""
    starts = indptr[local_rows]
    degs = indptr[local_rows + 1] - starts
    out = np.full((len(local_rows), num_samples), pad_id, dtype=np.int64)
    has = degs > 0
    if has.any():
        offs = prng.integers(
            0, np.maximum(degs[has][:, None], 1), size=(int(has.sum()), num_samples)
        )
        out[has] = indices[starts[has][:, None] + offs]
    return out


def engine_sample_many(engine, rng: np.random.Generator, queries: Sequence[Tuple]):
    """Batched multi-query sampling against any engine-like object.

    ``queries`` is a sequence of ``(nodes, relation, num_samples, pad_id)``.
    Engines that implement ``sample_many`` (both graph-engine backends) get
    the whole group in one call — the mp client turns it into one request
    round per worker; plain ``HeteroGraph`` falls back to a per-query loop.
    """
    fn = getattr(engine, "sample_many", None)
    if fn is not None:
        return fn(rng, queries)
    return [
        engine.sample_neighbors(rng, nodes, rel, k, pad_id=pad)
        for nodes, rel, k, pad in queries
    ]


@dataclasses.dataclass
class EngineStats:
    """Counters mirroring the paper's communication-cost discussion.

    Updates go through ``add`` under a lock: the prefetching trainer samples
    from a producer thread while mid-training evaluation samples from the
    main thread, and unguarded ``+=`` would drop increments.
    """

    neighbor_requests: int = 0  # total node->neighbors queries
    cross_partition_requests: int = 0  # queries answered by a remote partition
    batches: int = 0

    def __post_init__(self) -> None:
        self._lock = threading.Lock()

    def add(self, requests: int, cross: int) -> None:
        with self._lock:
            self.batches += 1
            self.neighbor_requests += requests
            self.cross_partition_requests += cross


def _gather_rows(
    indptr: np.ndarray, indices: np.ndarray, rows: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Gather CSR ``rows`` into a compacted sub-CSR with one vectorized slice.

    Builds a flat source-index array mapping every output position to its
    position in ``indices`` (start of its row plus offset within the row), so
    the whole copy is a single fancy-index gather — no per-node Python loop.
    """
    starts = indptr[rows]
    lengths = indptr[rows + 1] - starts
    out_indptr = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum(lengths, out=out_indptr[1:])
    row_of, offsets = ragged_row_offsets(lengths)
    out_indices = indices[starts[row_of] + offsets]
    return out_indptr, out_indices


class _Partition:
    """One graph server: adjacency of the nodes it owns, per relation."""

    def __init__(self, part_id: int, num_parts: int, graph: HeteroGraph):
        self.part_id = part_id
        self.num_parts = num_parts
        # Store only owned rows, re-indexed by local row = global // num_parts.
        self.rel_rows: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        owned = np.arange(part_id, graph.num_nodes, num_parts, dtype=np.int64)
        for name, csr in graph.relations.items():
            self.rel_rows[name] = _gather_rows(csr.indptr, csr.indices, owned)

    def sample(
        self,
        rng: np.random.Generator,
        local_rows: np.ndarray,
        relation: str,
        num_samples: int,
        pad_id: int,
    ) -> np.ndarray:
        indptr, indices = self.rel_rows[relation]
        return sample_csr_rows(indptr, indices, rng, local_rows, num_samples, pad_id)


class DistributedGraphEngine:
    """Node-partitioned graph engine with request routing + stats."""

    def __init__(
        self,
        graph: HeteroGraph,
        num_partitions: int = 4,
        client_part: int = 0,
    ):
        self.graph = graph
        self.num_partitions = int(num_partitions)
        self.client_part = int(client_part)  # partition co-located with the caller
        self.partitions = [
            _Partition(p, self.num_partitions, graph)
            for p in range(self.num_partitions)
        ]
        self.stats = EngineStats()
        self.relation_names = graph.relation_names()
        self.num_nodes = graph.num_nodes

    # drop-in for HeteroGraph.sample_neighbors
    def sample_neighbors(
        self,
        rng: np.random.Generator,
        nodes: np.ndarray,
        relation: str,
        num_samples: int,
        pad_id: int = -1,
    ) -> np.ndarray:
        nodes = np.asarray(nodes, dtype=np.int64)
        seed = int(rng.integers(0, SEED_BOUND))
        owners = nodes % self.num_partitions
        self.stats.add(len(nodes), int((owners != self.client_part).sum()))
        out = np.empty((len(nodes), num_samples), dtype=np.int64)
        for p in range(self.num_partitions):
            mask = owners == p
            if not mask.any():
                continue
            local_rows = nodes[mask] // self.num_partitions
            out[mask] = self.partitions[p].sample(
                partition_rng(seed, p), local_rows, relation, num_samples, pad_id
            )
        return out

    def sample_many(
        self, rng: np.random.Generator, queries: Sequence[Tuple]
    ) -> List[np.ndarray]:
        """Serve a group of ``(nodes, relation, num_samples, pad_id)`` queries.

        In-process this is a plain loop; the signature (and the one-seed-per-
        query randomness contract) matches ``GraphClient.sample_many``, which
        dispatches the same group as one pipelined request round per worker.
        """
        return [
            self.sample_neighbors(rng, nodes, rel, k, pad_id=pad)
            for nodes, rel, k, pad in queries
        ]
