"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each function computes what its CUDA kernel computes, in plain tensor ops.
The CPU path of ``kernels.ops`` runs them, the CPU tests hold them against
``repro``'s JAX oracles, and ``chip_smoke.py`` holds each kernel against
them on the card. On a card nothing else calls them.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


# ------------------------------------------------------------------ seg_aggr
def seg_aggr_ref(
    x: torch.Tensor,  # (N, F, D) neighbor features
    mask: torch.Tensor,  # (N, F) bool validity
    mode: str = "mean",
) -> torch.Tensor:
    """Masked segment aggregation over the neighbor axis -> (N, D).

    Mirrors ``repro/kernels/ref.py:seg_aggr_ref``: ``mean`` divides by
    max(count, 1) and ``max`` gives 0 on rows with no valid entry.
    """
    m = mask[..., None].to(x.dtype)
    if mode == "sum":
        return (x * m).sum(dim=1)
    if mode == "mean":
        s = (x * m).sum(dim=1)
        c = torch.clamp(m.sum(dim=1), min=1.0)
        return s / c
    if mode == "max":
        neg = torch.where(mask[..., None], x, torch.full_like(x, NEG_INF))
        out = neg.amax(dim=1)
        any_valid = mask.any(dim=1, keepdim=True)
        return torch.where(any_valid, out, torch.zeros_like(out))
    raise ValueError(mode)


def seg_aggr_bwd_ref(
    g: torch.Tensor,  # (N, D) gradient of the output
    mask: torch.Tensor,  # (N, F) bool validity
    mode: str = "mean",
    x: Optional[torch.Tensor] = None,  # (N, F, D) the forward's input; max only
) -> torch.Tensor:
    """The input gradient of ``seg_aggr_ref`` -> dense (N, F, D).

    ``sum``: mask * g; ``mean``: (g / max(count, 1)) * mask, in the order
    autodiff of the forward multiplies. No gradient reaches the mask.

    ``max`` needs the forward's ``x`` and gives what ``jax.grad`` takes of
    ``repro``'s ``seg_aggr_ref(mode="max")``, in its order: with ``neg =
    where(mask, x, -1e30)`` and ``out`` its maximum over F, ``cnt`` counts
    the F entries of ``neg`` equal to ``out``, masked ones included;
    ``where(any valid, g, 0) / cnt`` times (``neg == out``) is kept on the
    valid entries, 0 on the masked ones. So a valid -1e30 beside masked
    slots gets ``g / F``, a valid -inf beside them nothing, and rows with no
    valid entry nothing. NaN inputs are out of scope.
    """
    m = mask[..., None].to(g.dtype)
    if mode == "sum":
        return g[:, None, :] * m
    if mode == "mean":
        c = torch.clamp(m.sum(dim=1), min=1.0)  # (N, 1)
        return (g / c)[:, None, :] * m
    if mode == "max":
        if x is None:
            raise ValueError("seg_aggr 'max' backward needs the forward's input x")
        if x.shape[1] == 0:
            return torch.zeros_like(x)
        neg = torch.where(mask[..., None], x, torch.full_like(x, NEG_INF))
        top = (neg == neg.amax(dim=1, keepdim=True)).to(g.dtype)  # (N, F, D)
        cnt = top.sum(dim=1)  # (N, D)
        gm = torch.where(mask.any(dim=1, keepdim=True), g, torch.zeros_like(g))
        return torch.where(mask[..., None], (gm / cnt)[:, None, :] * top, torch.zeros_like(x))
    raise ValueError(mode)


# -------------------------------------------------------------- inbatch loss
def inbatch_loss_ref(
    h_src: torch.Tensor, h_dst: torch.Tensor, temperature: float = 1.0
) -> torch.Tensor:
    """In-batch softmax CE with diagonal positives -> scalar mean loss.

    Mirrors ``repro/kernels/ref.py:inbatch_loss_ref``.
    """
    return inbatch_loss_rows_ref(h_src, h_dst, temperature).mean()


def inbatch_loss_rows_ref(
    h_src: torch.Tensor, h_dst: torch.Tensor, temperature: float = 1.0
) -> torch.Tensor:
    """Per-row in-batch softmax CE with diagonal positives -> (P,).

    Mirrors ``repro/kernels/ref.py:inbatch_loss_rows_ref``.
    """
    logits = (h_src @ h_dst.T).to(torch.float32) / temperature
    labels = torch.arange(h_src.shape[0], device=h_src.device)
    return torch.logsumexp(logits, dim=-1) - logits[labels, labels]


# ------------------------------------------------------------- row adagrad
def row_adagrad_scatter_ref(
    table: torch.Tensor,  # (N, D), updated in place
    accum: torch.Tensor,  # (N, 1), updated in place
    ids: torch.Tensor,  # (B,) int; PADs (-1) allowed, real ids distinct
    grads: torch.Tensor,  # (B, D)
    lr: float = 0.1,
    eps: float = 1e-8,
) -> None:
    """Gather -> row-wise AdaGrad -> scatter, in place; PAD slots dropped.

    The rule of ``repro/kernels/ref.py:row_adagrad_scatter_ref``; ids at or
    past N are dropped too, as its ``mode="drop"`` scatter drops them.
    """
    keep = torch.nonzero((ids >= 0) & (ids < table.shape[0])).squeeze(1)
    rows, g = ids[keep], grads[keep]
    acc = accum[rows] + (g * g).mean(dim=-1, keepdim=True)
    table[rows] = table[rows] - lr * g / (torch.sqrt(acc) + eps)
    accum[rows] = acc


# -------------------------------------------------------------- window pairs
def window_pair_ids_ref(
    paths: torch.Tensor,  # (B, L) int paths, PAD = -1
    positions: torch.Tensor,  # (npos, 2) int (src_col, dst_col) table
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Skip-gram pair gather -> ((B, npos) int32 src, (B, npos) int32 dst).

    Mirrors ``repro/kernels/ref.py:window_pair_ids_ref``: both ids are PAD
    wherever either endpoint is PAD.
    """
    pos = positions.to(device=paths.device, dtype=torch.int64).reshape(-1, 2)
    paths = paths.to(torch.int32)
    src, dst = paths[:, pos[:, 0]], paths[:, pos[:, 1]]
    valid = (src != -1) & (dst != -1)
    pad = torch.full_like(src, -1)
    return torch.where(valid, src, pad), torch.where(valid, dst, pad)


def window_pair_draw_ref(
    paths: torch.Tensor,  # (B, L) int64 walk paths, PAD = -1
    positions: torch.Tensor,  # (npos, 2) int (src_col, dst_col) table
    spos: torch.Tensor,  # (npos,) int64, positions[:, 0]
    dpos: torch.Tensor,  # (npos,) int64, positions[:, 1]
    sel: torch.Tensor,  # (P,) int64 draw bits in [0, 2**32)
    walk_len: int,
) -> Tuple[torch.Tensor, ...]:
    """The fused sampler's pair stage -> (src, dst, src_sel, dst_sel, all_dead).

    The window gather (``window_pair_ids_ref``), then a uniform draw of P
    of the B * npos candidates from the valid ones by inverse CDF, with
    replacement, as ``repro/sampling/fused.py`` composes it: ``src`` and
    ``dst`` (P,) int64, PAD when no candidate is valid; ``src_sel`` and
    ``dst_sel`` (P,) int64, each draw's (walk, column) as ``row * walk_len +
    col``; ``all_dead`` a 0-d bool. ``searchsorted`` finds nothing when
    ``n_valid == 0``, so the clamp to n - 1 makes an all-dead round's
    ``src_sel`` / ``dst_sel`` those of the last candidate.
    """
    src_all, dst_all = window_pair_ids_ref(paths, positions)
    src_f, dst_f = src_all.reshape(-1), dst_all.reshape(-1)
    cum = torch.cumsum(src_f != -1, dim=0)
    n_valid = cum[-1]
    r = sel % n_valid.clamp(min=1)
    idx = torch.searchsorted(cum, r + 1).clamp(max=src_f.shape[0] - 1)
    all_dead = n_valid == 0
    src = torch.where(all_dead, -1, src_f[idx].to(torch.int64))
    dst = torch.where(all_dead, -1, dst_f[idx].to(torch.int64))
    npos = positions.shape[0]
    row = idx // npos
    pcol = idx % npos
    return src, dst, row * walk_len + spos[pcol], row * walk_len + dpos[pcol], all_dead


# ----------------------------------------------------------------- topk MIPS
def chunked_topk_ref(
    queries: torch.Tensor,  # (Q, d)
    items: torch.Tensor,  # (I, d)
    k: int,
    exclude: Optional[torch.Tensor] = None,  # (Q, E) int, -1 padded
    item_chunk: int = 8192,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming top-k MIPS -> ((Q, k) f32 scores, (Q, k) int32 ids).

    The merge rule of ``repro/retrieval/topk.py``: per item chunk, a stable
    descending sort over ``[running best | chunk]`` keeps k. Running entries
    hold smaller ids and ids ascend inside a chunk, so on equal scores the
    lower id wins (``torch.topk`` promises no order among ties). Excluded
    ids score -inf, and slots no surviving item fills are (-inf, -1).
    """
    Q, I = queries.shape[0], items.shape[0]
    if not 0 < k <= I:
        raise ValueError(f"k={k} must be in [1, num_items={I}]")
    if item_chunk <= 0:
        raise ValueError(f"item_chunk must be positive, got {item_chunk}")
    dev = queries.device
    q = queries.to(torch.float32)
    best_s = torch.full((Q, k), float("-inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((Q, k), -1, dtype=torch.int64, device=dev)
    for lo in range(0, I, item_chunk):
        hi = min(lo + item_chunk, I)
        s = q @ items[lo:hi].to(torch.float32).T  # (Q, hi - lo)
        gid = torch.arange(lo, hi, device=dev)
        if exclude is not None:
            # excluded ids this chunk owns -> -inf; the rest land in a spare
            # column that is cut off (O(Q*E), not an O(Q*E*chunk) compare)
            ex = exclude.to(torch.int64)
            col = torch.where((ex >= lo) & (ex < hi), ex - lo, hi - lo)
            hit = torch.zeros((Q, hi - lo + 1), dtype=torch.bool, device=dev)
            hit.scatter_(1, col, True)
            s = s.masked_fill(hit[:, : hi - lo], float("-inf"))
        all_s = torch.cat([best_s, s], dim=1)
        all_i = torch.cat([best_i, gid.expand(Q, -1)], dim=1)
        order = torch.sort(all_s, dim=1, descending=True, stable=True).indices[:, :k]
        best_s = torch.gather(all_s, 1, order)
        best_i = torch.gather(all_i, 1, order)
    best_i = torch.where(torch.isneginf(best_s), torch.full_like(best_i, -1), best_i)
    return best_s, best_i.to(torch.int32)


# ------------------------------------------------------------ IVF list topk
def total_order_key(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 whose signed order is the float's total order
    (-inf < ... < -0.0 < +0.0 < ... < +inf): the order ``lax.top_k`` ranks
    by, where a float ``>`` would call the two zeros equal. The CUDA
    ``ivf_list_topk`` kernel sorts on the same bits."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def desc_order(x: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k largest along the last axis, best first, in the
    total order of ``total_order_key``; on equal keys the lower position
    wins (``lax.top_k``'s first-occurrence rule: a stable sort, since
    ``torch.topk`` promises no order among ties)."""
    return torch.sort(total_order_key(x), dim=-1, descending=True, stable=True).indices[..., :k]


def ivf_list_scores(
    queries: torch.Tensor,  # (B, d) float32
    codes: torch.Tensor,  # (Ip, d) int8
    scales: torch.Tensor,  # (Ip, 1) float32
    starts: torch.Tensor,  # (B, P) int
    lengths: torch.Tensor,  # (B, P) int
    lpad: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every probed slot of a block of queries, flat in (probe, offset)
    order -> ((B, P * lpad) f32 scores, (B, P * lpad) int64 rows), (-inf,
    -1) at or past each list's length.

    A score is ``(codes . q) * scale``: the dot summed over d in order, one
    rounded product and one rounded sum a term (no fused multiply-add), the
    scale a separate multiply after it, as the CUDA kernel computes it, so
    the two agree bitwise and near-tied scores rank alike."""
    off = torch.arange(lpad, device=queries.device)
    rows = starts.to(torch.int64)[:, :, None] + off  # (B, P, lpad)
    valid = off < lengths.to(torch.int64)[:, :, None]
    safe = torch.where(valid, rows, torch.zeros_like(rows))
    c = codes[safe]  # (B, P, lpad, d) int8
    q = queries.to(torch.float32)
    s = torch.zeros(c.shape[:-1], dtype=torch.float32, device=queries.device)
    for t in range(c.shape[-1]):
        s = s + c[..., t].to(torch.float32) * q[:, None, None, t]
    s = s * scales.reshape(-1)[safe]
    s = torch.where(valid, s, torch.full_like(s, float("-inf")))
    r = torch.where(valid, rows, torch.full_like(rows, -1))
    return s.flatten(1), r.flatten(1)


def ivf_list_topk_ref(
    queries: torch.Tensor,  # (Q, d) float32
    codes: torch.Tensor,  # (Ip, d) int8 cell-sorted quantized rows
    scales: torch.Tensor,  # (Ip, 1) float32 per-row dequant scales
    starts: torch.Tensor,  # (Q, P) int packed-row offset of each probed list
    lengths: torch.Tensor,  # (Q, P) int true list lengths
    *,
    lpad: int,  # max list length: the slice width scored per probe
    shortlist: int,  # survivors kept per query (S)
    batch_size: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather-then-score over CSR inverted lists -> ((Q, S) f32 approx
    scores, (Q, S) int32 packed-row indices, -1 for empty slots).

    Mirrors ``repro/kernels/ref.py:ivf_list_topk_ref``: per block of
    ``batch_size`` queries, score every probed slot (``ivf_list_scores``),
    and keep the ``shortlist`` best in flat (probe, offset) order; on equal
    scores the lower flat index wins, and +0.0 ranks above -0.0.
    """
    Q = queries.shape[0]
    P = starts.shape[1]
    if not 0 < shortlist <= P * lpad:
        raise ValueError(f"shortlist={shortlist} must be in [1, nprobe * lpad = {P * lpad}]")
    dev = queries.device
    out_s = torch.empty((Q, shortlist), dtype=torch.float32, device=dev)
    out_r = torch.empty((Q, shortlist), dtype=torch.int32, device=dev)
    for lo in range(0, Q, batch_size):
        hi = min(lo + batch_size, Q)
        s, r = ivf_list_scores(queries[lo:hi], codes, scales, starts[lo:hi],
                               lengths[lo:hi], lpad)
        pos = desc_order(s, shortlist)
        out_s[lo:hi] = torch.gather(s, 1, pos)
        out_r[lo:hi] = torch.gather(r, 1, pos).to(torch.int32)
    return out_s, out_r


# ----------------------------------------------------------------- attention
def _band(Sq: int, Skv: int, causal: bool, window: Optional[int], q_offset: int,
          device) -> torch.Tensor:
    """(Sq, Skv) bool: key j is visible to query i (at position i + q_offset)."""
    qi = torch.arange(Sq, device=device)[:, None] + q_offset
    ki = torch.arange(Skv, device=device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        ok &= ki <= qi
    if window is not None:
        ok &= ki > qi - window
    return ok


def _attention(q, k, v, causal, window, q_offset):
    """``attention_ref``'s output (B, Sq, H, hd), its masked f32 logits
    (B, K, G, Sq, Skv) and the band (Sq, Skv)."""
    B, Sq, H, hd = q.shape
    Kh = k.shape[2]
    G = H // Kh
    qg = q.reshape(B, Sq, Kh, G, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() / math.sqrt(hd)
    ok = _band(Sq, k.shape[1], causal, window, q_offset, q.device)
    logits = logits.masked_fill(~ok, NEG_INF)
    att = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", att, v)
    return out.reshape(B, Sq, H, hd), logits, ok


def attention_fwd_ref(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, K, hd)
    v: torch.Tensor,  # (B, Skv, K, hd)
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``attention_ref``'s output and each row's log-sum-exp of its scaled,
    masked logits: ((B, Sq, H, hd), (B, H, Sq) f32), head h = k * G + g.
    The LSE is what the flash kernel's forward writes for its backward, from
    logits summed in f32 (bf16 products are exact there); the output keeps
    ``repro``'s oracle's products in the inputs' dtype."""
    out, logits, ok = _attention(q, k, v, causal, window, q_offset)
    B, Sq, H, hd = q.shape
    if q.dtype != torch.float32:
        qg = q.float().reshape(B, Sq, k.shape[2], H // k.shape[2], hd)
        logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(hd)
        logits = logits.masked_fill(~ok, NEG_INF)
    return out, torch.logsumexp(logits, dim=-1).reshape(B, H, Sq)


def attention_ref(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, K, hd)
    v: torch.Tensor,  # (B, Skv, K, hd)
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """GQA attention with causal and sliding-window masking -> (B, Sq, H, hd).

    Mirrors ``repro/kernels/ref.py:attention_ref``: query head h reads KV
    head h // G (G = H / K); query i sits at position i + ``q_offset``;
    masked logits are ``NEG_INF``; the softmax runs in f32 and its weights
    are cast to the input dtype before the PV product. The flash kernel
    (``csrc/flash_attn.cu``) rounds them at nearly the same place in bf16:
    its unnormalised weights go to bf16 before the PV product, and it
    divides by the f32 row sum last (in f32 it keeps them in f32).
    """
    return _attention(q, k, v, causal, window, q_offset)[0]


# the same attention contract under the flash kernel's name, as in ``repro``
flash_attention_ref = attention_ref


def attention_bwd_ref(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, K, hd)
    v: torch.Tensor,  # (B, Skv, K, hd)
    o: torch.Tensor,  # (B, Sq, H, hd): the forward's output
    lse: torch.Tensor,  # (B, H, Sq) f32: the forward's row log-sum-exp
    do: torch.Tensor,  # (B, Sq, H, hd): the output's gradient
    causal: bool = True,
    window: Optional[int] = None,
    block_q: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The flash backward's formulas in f32 -> (dq, dk, dv) in the inputs'
    dtype: P = exp(S scale - LSE) inside the band (0 outside), dV = P^T dO,
    dP = dO V^T, D = rowsum(dO o O), dS = P o (dP - D), dQ = dS K scale,
    dK = dS^T Q scale, dK and dV summed over the G query heads of a KV head.
    A row with no visible key has no gradient here (its forward output is
    a uniform average over masked keys; no model path makes one).
    ``block_q`` bounds the (B, H, block_q, Skv) f32 intermediates: query
    blocks in order, dK and dV summed over them in f32."""
    B, Sq, H, hd = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    scale = 1.0 / math.sqrt(hd)
    kf, vf = k.float(), v.float()
    lse_g = lse.float().reshape(B, Kh, G, Sq)
    dq = torch.empty((B, Sq, Kh, G, hd), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, Skv, Kh, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    step = Sq if block_q is None else block_q
    for i in range(0, Sq, step):
        sl = slice(i, min(i + step, Sq))
        n = sl.stop - sl.start
        qg = q[:, sl].float().reshape(B, n, Kh, G, hd)
        dog = do[:, sl].float().reshape(B, n, Kh, G, hd)
        dd = (do[:, sl].float() * o[:, sl].float()).sum(-1)  # D: (B, n, H)
        dd = dd.reshape(B, n, Kh, G).permute(0, 2, 3, 1)[..., None]
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kf) * scale
        ok = _band(n, Skv, causal, window, i, q.device)
        p = torch.where(ok, torch.exp(s - lse_g[..., sl, None]), 0.0)
        dv += torch.einsum("bkgqs,bqkgd->bskd", p, dog)
        dp = torch.einsum("bqkgd,bskd->bkgqs", dog, vf)
        ds = p * (dp - dd)
        dq[:, sl] = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
        dk += torch.einsum("bkgqs,bqkgd->bskd", ds, qg) * scale
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
