"""CUDA wrapper: streaming inner-product top-k (``csrc/topk.cu``).

The Hopper counterpart of ``repro/kernels/topk.py:chunked_topk_pallas``:
(Q, d) queries against (I, d) items, with a (Q, E) exclude list per query
(-1 = empty slot), give the k best ((Q, k) f32 scores, (Q, k) int32 ids),
best first, lower id first on equal scores, (-inf, -1) where no surviving
item is left. The source file carries the design note.

The wrapper picks how many contiguous item splits run side by side: enough
(query tile, split) blocks to fill the card twice over, no split shorter
than ``MIN_SPLIT_ITEMS`` and at most ``MAX_SPLITS``, whose lists a second
kernel merges. It sorts each exclude row, for the kernel's binary search.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

MAX_K = 256  # the running lists live in shared memory (csrc/topk.cu:kMaxK)
TILE_Q = 32  # queries per block (csrc/topk.cu:kTQ)
CHUNK = 128  # items per staged chunk (csrc/topk.cu:kCH)
MIN_SPLIT_ITEMS = 4096
MAX_SPLITS = 32

# Kernel launches since the last reset (chip_smoke.py reads and resets it):
# one ``topk_kernel`` per call, plus one ``topk_merge_kernel`` when the items
# are split.
launches = 0


def plan_splits(num_queries: int, num_items: int, num_sms: int) -> Tuple[int, int]:
    """(splits, items per split): fill ~2 blocks per SM, then stop cutting."""
    qtiles = -(-num_queries // TILE_Q)
    want = -(-2 * num_sms // qtiles)
    splits = max(1, min(want, -(-num_items // MIN_SPLIT_ITEMS), MAX_SPLITS))
    per_split = -(-num_items // splits)
    split_len = -(-per_split // CHUNK) * CHUNK  # whole chunks per split
    return -(-num_items // split_len), split_len


def streaming_topk_cuda(
    queries: torch.Tensor,
    items: torch.Tensor,
    k: int,
    exclude: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, d) f32, (I, d) f32, (Q, E) int on one CUDA device ->
    ((Q, k) f32 scores, (Q, k) int32 ids)."""
    global launches
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
        ex = torch.empty((Q, 0), dtype=torch.int32, device=dev)
    else:
        if exclude.dim() != 2 or exclude.shape[0] != Q or exclude.device != dev:
            raise ValueError(f"exclude must be (Q={Q}, E) on {dev}; got "
                             f"{tuple(exclude.shape)} on {exclude.device}")
        ex = torch.sort(exclude.to(torch.int32), dim=1).values.contiguous()
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return out_s, out_i
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, split_len = plan_splits(Q, I, num_sms)
    part_s = part_i = None
    if splits > 1:
        part_s = torch.empty((splits, Q, k), dtype=torch.float32, device=dev)
        part_i = torch.empty((splits, Q, k), dtype=torch.int32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.g4r_topk_f32(
            queries.data_ptr(), items.data_ptr(), ex.data_ptr(), ex.shape[1],
            None if part_s is None else part_s.data_ptr(),
            None if part_i is None else part_i.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(), Q, I, d, k, splits, split_len,
            stream,
        )
    build.check(err, "topk")
    launches += 2 if splits > 1 else 1
    return out_s, out_i
