"""Embedding tables and side-info slots (device half of ``repro.embedding.table``).

The node-ID table plus one table per side-info slot (paper §3.5): a node's
representation is its ID row plus the sum of its slot-value rows. Slots
arrive either as padded value lists (``embed_nodes``) or as rows of a
per-node count matrix (``embed_nodes_bag``); ``embed_nodes_mixed`` takes
both, one representation per slot. The count-matrix products stay
``torch.matmul``, as ``repro`` leaves them to XLA.

PAD ids (-1) give zero rows. ``table[-1]`` would read the *last* row in
PyTorch, so ``lookup`` clamps and masks, as ``repro`` does.

The numpy helpers ``slot_count_matrix``, ``pad_slot_values``,
``unique_pad_ids`` and ``remap_ids`` are copies. ``gather_rows`` and
``scatter_rows`` are the device half of the sparse step's
gather→step→scatter contract. ``save_table``, ``load_table`` and
``warm_start`` carry pre-trained tables between runs (paper §3.6) in
``repro``'s npz layout.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.utils.ragged import ragged_row_offsets


@dataclasses.dataclass(frozen=True)
class SlotSpec:
    name: str
    vocab_size: int
    max_values: int  # fixed-width padding of the ragged slot


@dataclasses.dataclass(frozen=True)
class EmbeddingConfig:
    num_nodes: int
    dim: int
    slots: Tuple[SlotSpec, ...] = ()
    dtype: str = "float32"
    pad_id: int = -1


def init_params(generator: torch.Generator, cfg: EmbeddingConfig) -> Dict[str, torch.Tensor]:
    """Node-ID table plus one table per side-info slot, N(0, 1/dim).

    The shapes and scale of ``repro``'s init; the draws are torch's, so a
    conformance check starts from ``repro``'s parameters instead.
    """
    dtype = getattr(torch, cfg.dtype)
    scale = 1.0 / np.sqrt(cfg.dim)

    def normal(rows: int) -> torch.Tensor:
        t = torch.randn((rows, cfg.dim), generator=generator, dtype=dtype)
        return t * scale

    params = {"node": normal(cfg.num_nodes)}
    for slot in cfg.slots:
        params[f"slot:{slot.name}"] = normal(slot.vocab_size)
    return params


# ----------------------------------------------------------------- lookups
def lookup(table: torch.Tensor, ids: torch.Tensor, pad_id: int = -1) -> torch.Tensor:
    """Masked gather: PAD (negative) ids give zero rows.

    The gather is ``F.embedding``, whose backward on the card sums the
    gradients of repeated ids in parallel segments; the backward of
    ``table[ids]`` (an accumulating index-put) sums each id's repeats in
    one serial loop, and a batch's popular nodes repeat thousands of times.
    """
    valid = ids >= 0
    rows = F.embedding(torch.where(valid, ids, torch.zeros_like(ids)), table)
    return torch.where(valid[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                           device=rows.device))


def embed_nodes(
    params: Mapping[str, torch.Tensor],
    ids: torch.Tensor,
    slot_values: Optional[Mapping[str, torch.Tensor]] = None,
    pad_id: int = -1,
) -> torch.Tensor:
    """ID embedding + sum of side-info slot embeddings.

    ``slot_values[name]``: (..., max_values) padded value ids aligned with
    ``ids``. Multi-value slots are sum-pooled (bag-of-features).
    """
    h = lookup(params["node"], ids, pad_id)
    if slot_values:
        for name, vals in slot_values.items():
            h = h + lookup(params[f"slot:{name}"], vals, pad_id).sum(dim=-2)
    return h


def embed_nodes_bag(
    params: Mapping[str, torch.Tensor],
    ids: torch.Tensor,
    slot_counts: Mapping[str, torch.Tensor],
    pad_id: int = -1,
) -> torch.Tensor:
    """Side info via per-node value counts: ``counts[ids] @ slot_table``.

    ``slot_counts[name]``: (num_nodes, vocab) from ``slot_count_matrix``;
    exactly the padded gather-and-sum of ``embed_nodes``, as two products.
    """
    return embed_nodes_mixed(params, ids, slot_counts=slot_counts, pad_id=pad_id)


def embed_nodes_mixed(
    params: Mapping[str, torch.Tensor],
    ids: torch.Tensor,
    slot_values: Optional[Mapping[str, torch.Tensor]] = None,
    slot_counts: Optional[Mapping[str, torch.Tensor]] = None,
    pad_id: int = -1,
) -> torch.Tensor:
    """ID embedding + side info with a per-slot bag/values split.

    Small vocabs come as count-matrix products (``slot_counts``), large ones
    as padded value lists (``slot_values``); a slot is in at most one.
    """
    h = lookup(params["node"], ids, pad_id)
    if slot_counts:
        for name, cmat in slot_counts.items():
            c = lookup(cmat, ids, pad_id)  # (..., vocab); zero row for PAD ids
            h = h + torch.matmul(c, params[f"slot:{name}"])
    if slot_values:
        for name, vals in slot_values.items():
            h = h + lookup(params[f"slot:{name}"], vals, pad_id).sum(dim=-2)
    return h


# ------------------------------------------------- unique-id (sparse) path
def unique_pad_ids(
    id_arrays: Sequence[np.ndarray], bucket: int = 0, min_bucket: int = 8
) -> np.ndarray:
    """Deduplicated touched ids, PAD-padded *in front* to a stable bucket.

    Host-side prologue of the gather→step→scatter contract: the returned
    array holds ``width - n`` leading PADs (-1) followed by the ``n`` unique
    non-PAD ids in ascending order. ``width`` is ``max(min_bucket, bucket)``
    doubled until it fits, so a caller that persists the width across
    batches sees O(log n) distinct shapes. (The PADs lead for ``repro``'s
    Pallas kernel, which clamps them to row 0; the port's kernel skips
    them, kernels/csrc/row_adagrad.cu.)
    """
    arrays = [np.asarray(a).reshape(-1) for a in id_arrays]
    flat = np.concatenate(arrays) if arrays else np.empty(0, np.int64)
    real = np.unique(flat)
    real = real[real >= 0]
    width = max(int(min_bucket), int(bucket))
    while width < len(real):
        width *= 2
    out = np.full(width, -1, dtype=np.int64)
    if len(real):
        out[width - len(real):] = real
    return out


def remap_ids(uniq: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Global ids -> row indices into ``gather_rows(table, uniq)``.

    Every non-PAD id must be present in ``uniq`` (guaranteed when ``uniq``
    came from ``unique_pad_ids`` over arrays that include ``ids``); PAD stays
    PAD so downstream masking is unchanged.
    """
    ids = np.asarray(ids, dtype=np.int64)
    real = uniq[uniq >= 0]
    if len(real) == 0:
        return np.full(ids.shape, -1, dtype=np.int64)
    offset = len(uniq) - len(real)
    loc = np.searchsorted(real, np.clip(ids, real[0], real[-1]))
    return np.where(ids >= 0, loc + offset, -1)


def gather_rows(table: torch.Tensor, uniq: torch.Tensor) -> torch.Tensor:
    """Pull the touched rows: (bucket, dim), a fresh tensor. PAD slots read
    row 0; no remapped id points at them and their updates are dropped."""
    return table[torch.clamp(uniq, min=0)]


def scatter_rows(table: torch.Tensor, uniq: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Push updated rows back, in place: ``table[uniq] = rows`` with PAD
    slots dropped; returns ``table``. Selecting the real slots syncs with a
    card (``nonzero``), so the trainer's step uses the fused
    ``kernels.ops.rowwise_adagrad_scatter`` instead."""
    keep = torch.nonzero(uniq >= 0).squeeze(1)
    table[uniq[keep]] = rows[keep]
    return table


# --------------------------------------------------------------- side info
def slot_count_matrix(
    slot_indptr: np.ndarray,
    slot_values: np.ndarray,
    num_nodes: int,
    vocab_size: int,
    max_values: int,
) -> np.ndarray:
    """(num_nodes, vocab) float32 matrix of each node's slot-value counts.

    Row n counts the node's first ``max_values`` ragged values — the exact
    set ``pad_slot_values`` would emit — so ``counts[n] @ table`` equals the
    padded gather-and-sum.
    """
    counts = np.zeros((num_nodes, vocab_size), dtype=np.float32)
    starts = np.asarray(slot_indptr[:-1], dtype=np.int64)
    lens = np.minimum(slot_indptr[1:] - starts, max_values).astype(np.int64)
    if lens.sum():
        node_of, off = ragged_row_offsets(lens)
        np.add.at(counts, (node_of, slot_values[starts[node_of] + off]), 1.0)
    return counts


def pad_slot_values(
    slot_indptr: np.ndarray,
    slot_values: np.ndarray,
    ids: np.ndarray,
    max_values: int,
    pad_id: int = -1,
) -> np.ndarray:
    """Host-side: ragged slot values -> (len(ids), max_values) padded."""
    ids = np.asarray(ids).reshape(-1)
    out = np.full((len(ids), max_values), pad_id, dtype=np.int64)
    valid = np.flatnonzero(ids >= 0)
    if len(valid) == 0:
        return out
    vids = ids[valid]
    starts = np.asarray(slot_indptr[vids], dtype=np.int64)
    lens = np.minimum(slot_indptr[vids + 1] - starts, max_values).astype(np.int64)
    if lens.sum() == 0:
        return out
    row_of, col = ragged_row_offsets(lens)
    out[valid[row_of], col] = slot_values[starts[row_of] + col]
    return out


# -------------------------------------------------------------- warm start
def save_table(path: str, params: Mapping[str, object]) -> None:
    """Write tables (tensors on any device, or numpy arrays) to one npz,
    the layout ``repro.embedding.save_table`` writes and reads."""
    np.savez(path, **{k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                      else np.asarray(v) for k, v in params.items()})


def load_table(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def warm_start(params: Mapping[str, torch.Tensor],
               pretrained: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Inherit pre-trained sparse tables (paper §3.6 warm start).

    A table in ``pretrained`` whose key and shape match replaces the fresh
    one, as a copy in the fresh table's dtype and on its device; everything
    else (the dense GNN weights, tables of another shape) is untouched.
    """
    out = dict(params)
    for k, v in pretrained.items():
        if k in out and tuple(out[k].shape) == tuple(v.shape):
            out[k] = torch.tensor(np.asarray(v), dtype=out[k].dtype, device=out[k].device)
    return out
