"""CUDA wrapper: streaming inner-product top-k (``csrc/topk.cu``).

The Hopper counterpart of ``repro/kernels/topk.py:chunked_topk_pallas``:
(Q, d) queries against (I, d) items, with a (Q, E) exclude list per query
(-1 = empty slot), give the k best ((Q, k) f32 scores, (Q, k) int32 ids),
best first, lower id first on equal scores, (-inf, -1) where no surviving
item is left. The source file carries the design note.

One launch per call. A block scores ``TILE_Q`` queries against one
contiguous split of the items; the splits of a query tile are one thread-
block cluster (at most ``MAX_CLUSTER``) whose blocks merge their lists
through distributed shared memory before block 0 writes the result.
``plan_splits`` picks the split count from the clusters the card holds at
once: one wave where that gives every SM two blocks, else at least two
blocks an SM. The wrapper sorts each exclude row, for the kernel's binary
search.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build

MAX_K = 256  # the running lists live in shared memory (csrc/topk.cu:kMaxK)
TILE_Q = 8  # queries per block (csrc/topk.cu:kTQ)
CHUNK = 128  # items per staged chunk (csrc/topk.cu:kCH)
MAX_CLUSTER = 8  # blocks per cluster, the portable size (csrc/topk.cu:kMaxCluster)
EXCLUDE_CAP = 32  # exclude entries per query staged in shared memory (csrc/topk.cu:kExCap)

# Kernel launches since the last reset (chip_smoke.py reads and resets it):
# one per call.
launches = 0


def plan_splits(num_queries: int, num_items: int, num_sms: int,
                resident_clusters: Sequence[int]) -> Tuple[int, int]:
    """(splits, items per split). ``resident_clusters[s - 1]`` is how many
    clusters of s blocks the card holds at once (s = 1 .. ``MAX_CLUSTER``).
    The most splits whose clusters, one a query tile, all fit in one wave,
    raised until every SM has two blocks where one wave cannot give them;
    at most one split a chunk, each a whole number of chunks."""
    qtiles = -(-num_queries // TILE_Q)
    chunks = -(-num_items // CHUNK)
    top = max(1, min(MAX_CLUSTER, chunks))
    fits = [s for s in range(1, top + 1) if qtiles <= resident_clusters[s - 1]]
    splits = max(fits, default=1)
    while splits < top and qtiles * splits < 2 * num_sms:
        splits += 1
    split_len = -(-chunks // splits) * CHUNK
    return -(-num_items // split_len), split_len


@functools.lru_cache(maxsize=None)
def kernel_attrs(k: int, splits: int = 1) -> dict:
    """The instantiation for ``k``: registers a thread, local memory bytes
    (spills and stack), dynamic shared memory bytes, resident blocks an SM
    and resident clusters of ``splits`` blocks on the current card."""
    out = (ctypes.c_int * 5)()
    build.check(build.library().g4r_topk_attrs(k, splits, out), "topk attributes")
    return {"registers": out[0], "local_bytes": out[1], "shared_bytes": out[2],
            "blocks_per_sm": out[3], "clusters": out[4]}


def launch_plan(num_queries: int, num_items: int, k: int, device: torch.device) -> dict:
    """The launch ``streaming_topk_cuda`` makes for these sizes on ``device``."""
    with torch.cuda.device(device):
        num_sms = torch.cuda.get_device_properties(device).multi_processor_count
        resident = [kernel_attrs(k, s)["clusters"] for s in range(1, MAX_CLUSTER + 1)]
        per_sm = kernel_attrs(k)["blocks_per_sm"]
    splits, split_len = plan_splits(num_queries, num_items, num_sms, resident)
    qtiles = -(-num_queries // TILE_Q)
    return {"tile_q": TILE_Q, "splits": splits, "split_len": split_len, "cluster": splits,
            "blocks": qtiles * splits, "blocks_per_sm": per_sm, "sms": num_sms,
            "resident_clusters": resident[splits - 1],
            "waves": -(-qtiles // max(1, resident[splits - 1]))}


def _checked(queries, items, k, exclude) -> torch.Tensor:
    """The wrapper's checks; returns the exclude rows sorted, as int32."""
    if queries.dim() != 2 or items.dim() != 2 or queries.shape[1] != items.shape[1]:
        raise ValueError(f"topk wants (Q, d) queries and (I, d) items; got "
                         f"{tuple(queries.shape)} and {tuple(items.shape)}")
    Q, d = queries.shape
    I = items.shape[0]
    if not 0 < k <= I:
        raise ValueError(f"k={k} must be in [1, num_items={I}]")
    if k > MAX_K:
        raise ValueError(
            f"k={k} exceeds the CUDA topk kernel's limit of {MAX_K} (its "
            "running lists live in shared memory); split the request"
        )
    if queries.dtype != torch.float32 or items.dtype != torch.float32:
        raise TypeError(f"topk wants f32 queries and items; got {queries.dtype}, "
                        f"{items.dtype}")
    dev = queries.device
    if not (queries.is_cuda and items.device == dev):
        raise ValueError(f"topk kernel wants queries and items on one CUDA "
                         f"device; got {dev} and {items.device}")
    if not (queries.is_contiguous() and items.is_contiguous()):
        raise ValueError("topk kernel wants contiguous queries and items")
    if max(Q, I, d) >= 2**31 or Q * k >= 2**31:
        raise ValueError(f"topk kernel indexes with int32; got Q={Q}, I={I}, d={d}")
    if exclude is None:
        return torch.empty((Q, 0), dtype=torch.int32, device=dev)
    if exclude.dim() != 2 or exclude.shape[0] != Q or exclude.device != dev:
        raise ValueError(f"exclude must be (Q={Q}, E) on {dev}; got "
                         f"{tuple(exclude.shape)} on {exclude.device}")
    return torch.sort(exclude.to(torch.int32), dim=1).values.contiguous()


def _launch(queries, items, k, ex, splits, split_len):
    global launches
    Q, I, d = queries.shape[0], items.shape[0], queries.shape[1]
    dev = queries.device
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return out_s, out_i
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.g4r_topk_f32(
            queries.data_ptr(), items.data_ptr(), ex.data_ptr(), ex.shape[1],
            out_s.data_ptr(), out_i.data_ptr(), Q, I, d, k, splits, split_len, stream,
        )
    build.check(err, "topk")
    launches += 1
    return out_s, out_i


def streaming_topk_cuda(
    queries: torch.Tensor,
    items: torch.Tensor,
    k: int,
    exclude: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, d) f32, (I, d) f32, (Q, E) int on one CUDA device ->
    ((Q, k) f32 scores, (Q, k) int32 ids)."""
    ex = _checked(queries, items, k, exclude)
    plan = launch_plan(queries.shape[0], items.shape[0], k, queries.device)
    return _launch(queries, items, k, ex, plan["splits"], plan["split_len"])


def streaming_topk_planned(
    queries: torch.Tensor,
    items: torch.Tensor,
    k: int,
    exclude: Optional[torch.Tensor],
    splits: int,
    split_len: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``streaming_topk_cuda`` with the plan given: ``splits`` blocks a
    cluster (1..``MAX_CLUSTER``), each over ``split_len`` items (a multiple
    of ``CHUNK``), covering the items; splits past the items keep filler
    lists. For tests of the plans the wrapper does not pick."""
    I = items.shape[0]
    if not (1 <= splits <= MAX_CLUSTER and split_len > 0 and split_len % CHUNK == 0
            and splits * split_len >= I):
        raise ValueError(f"a topk plan of {splits} splits of {split_len} items does not "
                         f"cover {I} items in whole chunks of {CHUNK} in one cluster")
    ex = _checked(queries, items, k, exclude)
    return _launch(queries, items, k, ex, splits, split_len)
