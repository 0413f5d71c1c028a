"""Pair generation from random-walk paths (Graph4Rec §3.4) and negative
sampling strategies (§3.6, RQ4). Verbatim copy of ``repro.sampling.pairs``.

Positive pairs are node pairs inside the same walk within ``win_size``
(skip-gram proximity). Negatives are either drawn uniformly from the node set
("random", requires extra engine/PS traffic for the negatives' embeddings and
side info) or taken from the other positives in the batch ("in-batch", no
extra data input — the paper's ≈4× speedup).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np

PAD = -1


@dataclasses.dataclass
class PairConfig:
    win_size: int = 2
    neg_mode: str = "inbatch"  # "inbatch" | "random"
    num_negatives: int = 5  # per positive, random mode only


def window_positions(walk_len: int, win_size: int) -> np.ndarray:
    """Static (npos, 2) table of in-window (src_col, dst_col) position pairs.

    The skip-gram window over a length-``walk_len`` path, independent of the
    path contents: src != dst, |src - dst| <= win_size. Shared by the host
    ``window_pairs`` and the fused on-device sampler (whose pair stage is a
    fixed gather of exactly these columns).
    """
    rows = []
    for d in range(1, win_size + 1):
        if d >= walk_len:
            break
        for s in range(0, walk_len - d):
            rows.append((s, s + d))
            rows.append((s + d, s))
    return np.array(rows, dtype=np.int64).reshape(-1, 2)


def window_pairs(paths: np.ndarray, win_size: int) -> np.ndarray:
    """All (src_pos, dst_pos) index pairs within the window, per path.

    Returns (P, 3) int64 rows of (path_row, src_col, dst_col) with
    src != dst, |src-dst| <= win_size, and both nodes valid (not PAD).
    Enumerating *positions* (not node ids) lets the ego-first pipeline reuse
    per-position ego graphs (§3.6 order exchange).
    """
    B, L = paths.shape
    pos = window_positions(L, win_size)  # (L-window combos, 2)
    # cross with batch rows, filter PAD
    path_idx = np.repeat(np.arange(B, dtype=np.int64), len(pos))
    sc = np.tile(pos[:, 0], B)
    dc = np.tile(pos[:, 1], B)
    ok = (paths[path_idx, sc] != PAD) & (paths[path_idx, dc] != PAD)
    return np.stack([path_idx[ok], sc[ok], dc[ok]], axis=1)


def pairs_to_nodes(paths: np.ndarray, pairs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(P,3) position pairs -> (src_ids, dst_ids)."""
    return paths[pairs[:, 0], pairs[:, 1]], paths[pairs[:, 0], pairs[:, 2]]


def sample_random_negatives(
    rng: np.random.Generator,
    num_pos: int,
    num_negatives: int,
    node_range: Tuple[int, int],
) -> np.ndarray:
    """Uniform negatives over a node-id range: (num_pos, num_negatives)."""
    lo, hi = node_range
    return rng.integers(lo, hi, size=(num_pos, num_negatives)).astype(np.int64)
