"""Shared ragged-array indexing helper.

One idiom, used by the graph engine's partition build, host-side slot
padding, and slot count-matrix construction: given per-row lengths, produce
flat (row, offset) index arrays addressing every element of the
concatenated rows, so a ragged copy becomes a single vectorized gather.

Verbatim copy of ``repro.utils.ragged`` for the PyTorch port.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def ragged_row_offsets(lengths: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(row_of, offset) flat index arrays for rows of the given lengths.

    ``row_of[i]`` is the row the i-th output element belongs to and
    ``offset[i]`` its position within that row; both have length
    ``lengths.sum()``. Source positions in a CSR-like layout are then
    ``starts[row_of] + offset``.
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    total = int(lengths.sum())
    row_of = np.repeat(np.arange(len(lengths), dtype=np.int64), lengths)
    offset = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(lengths) - lengths, lengths
    )
    return row_of, offset
