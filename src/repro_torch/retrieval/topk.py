"""Exact top-k retrieval: the numpy oracle and the streaming device path.

The port of ``repro.retrieval.topk``. Both implementations share one
tie-break contract (higher score first; on equal scores the lower item id
wins), and slots no surviving item fills come back as (-inf, -1):

- ``brute_force_topk``: the numpy oracle (copied) — materializes the
  (Q, I) score block; kept for tests and as the baseline arm;
- ``chunked_topk``: the device path. On CUDA it runs the hand-written
  ``topk`` kernel (``kernels/topk.py``), whose memory is O(Q·k), not
  O(Q·I); on the CPU its plain version.

``exclude`` is a (Q, E) padded id matrix (-1 = empty slot): per query, the
listed item ids score -inf — how a user's training history is dropped in
the search itself.
"""
from __future__ import annotations

import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops

NEG_INF = np.float32(-np.inf)

# Device copies of recently searched item tables, keyed by the host array's
# identity (+ shape, dtype, device): recall reuses one corpus across many
# query batches, and re-shipping it host->device per call was the
# "IVF loses to brute force" bug in ``repro``. Entries go when the host
# array is garbage-collected (weakref); the table is bounded FIFO.
_DEVICE_TABLE_CACHE: dict = {}
_DEVICE_TABLE_CACHE_MAX = 8


def _cached_device_table(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    key = (id(arr), arr.shape, arr.dtype.str, str(device))
    hit = _DEVICE_TABLE_CACHE.get(key)
    if hit is not None:
        return hit[1]
    dev = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    ref = weakref.ref(arr, lambda _, k=key: _DEVICE_TABLE_CACHE.pop(k, None))
    _DEVICE_TABLE_CACHE[key] = (ref, dev)
    while len(_DEVICE_TABLE_CACHE) > _DEVICE_TABLE_CACHE_MAX:
        _DEVICE_TABLE_CACHE.pop(next(iter(_DEVICE_TABLE_CACHE)))
    return dev


def pad_id_rows(rows, width: int = 0, pad: int = -1) -> np.ndarray:
    """Ragged id lists -> (len(rows), width) padded int32 matrix."""
    width = max(width, 1, *(len(r) for r in rows)) if rows else max(width, 1)
    out = np.full((len(rows), width), pad, dtype=np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def _deterministic_topk_rows(scores: np.ndarray, k: int) -> np.ndarray:
    """Row-wise top-k positions, ties broken by ascending index."""
    n = scores.shape[-1]
    k = min(k, n)
    # argsort of -score is not tie-stable; lexsort on (index, -score) is.
    idx = np.lexsort(
        (np.broadcast_to(np.arange(n), scores.shape), -scores), axis=-1
    )
    return idx[..., :k]


def brute_force_topk(
    queries: np.ndarray,
    items: np.ndarray,
    k: int,
    exclude: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy oracle: full (Q, I) scores, then deterministic row top-k.

    Returns ((Q, k) float32 scores, (Q, k) int32 ids), (-inf, -1) where k
    exceeds the non-excluded count.
    """
    q = np.asarray(queries, dtype=np.float32)
    it = np.asarray(items, dtype=np.float32)
    if not 0 < k <= it.shape[0]:
        raise ValueError(f"k={k} must be in [1, num_items={it.shape[0]}]")
    scores = q @ it.T
    if exclude is not None:
        ex = np.asarray(exclude)
        rows = np.repeat(np.arange(ex.shape[0]), ex.shape[1])
        cols = ex.reshape(-1)
        valid = cols >= 0
        scores[rows[valid], cols[valid]] = NEG_INF
    ids = _deterministic_topk_rows(scores, k)
    top = np.take_along_axis(scores, ids, axis=-1)
    return top, np.where(np.isneginf(top), -1, ids).astype(np.int32)


def chunked_topk(
    queries,
    items,
    k: int,
    exclude: Optional[np.ndarray] = None,
    query_chunk: int = 0,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Device streaming top-k, a drop-in for the oracle's ids.

    ``device=None`` is CUDA (raises without one); ``"cpu"`` runs the plain
    version. ``query_chunk`` > 0 sweeps queries in blocks of that many, so
    one call never holds more than (query_chunk, k) results plus the
    kernel's scratch. Returns host ((Q, k) f32, (Q, k) int32).
    """
    dev = resolve_device(device)
    q = np.ascontiguousarray(queries, dtype=np.float32)  # the kernel's layout
    it = np.asarray(items, dtype=np.float32)
    Q, I = q.shape[0], it.shape[0]
    if not 0 < k <= I:
        raise ValueError(f"k={k} must be in [1, num_items={I}]")
    if query_chunk < 0:
        raise ValueError(
            f"query_chunk must be >= 0 (0 disables query chunking), got {query_chunk}"
        )
    if exclude is not None:
        exclude = np.asarray(exclude, dtype=np.int32)
    dit = _cached_device_table(it, dev)  # `it` is `items` itself when f32
    step = query_chunk if query_chunk and Q > query_chunk else max(Q, 1)
    out_s = np.empty((Q, k), np.float32)
    out_i = np.empty((Q, k), np.int32)
    for lo in range(0, Q, step):
        hi = min(lo + step, Q)
        dq = torch.from_numpy(q[lo:hi]).to(dev)
        dex = None if exclude is None else torch.from_numpy(exclude[lo:hi]).to(dev)
        s, i = ops.streaming_topk(dq, dit, k, exclude=dex)
        out_s[lo:hi] = s.cpu().numpy()
        out_i[lo:hi] = i.cpu().numpy()
    return out_s, np.where(np.isneginf(out_s), -1, out_i).astype(np.int32)
