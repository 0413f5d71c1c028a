"""The port's flash attention (``kernels.ops.flash_attention``, its plain
version ``kernels.ref.attention_ref`` and the kernel ``csrc/flash_attn.cu``)
against ``repro``'s attention paths.

On the CPU (every run): the port's plain version and its dispatcher, in
f32, against all of ``repro``'s full-sequence paths on the same numpy
inputs at atol 2e-5: its oracle ``kernels.ref.attention_ref``, the Pallas
kernel (``kernels.ops.flash_attention``, interpret mode; it asserts
``Sq % block_q == 0``, so S 200 skips it), the chunked XLA scan (block 64;
S 200 skips it too) and the naive ``gqa_attention`` with
``gqa_scores_mask``. In bf16 the port (normalised weights cast to bf16
before PV, as ``repro``'s oracle) against the Pallas kernel (weights kept
f32) at atol 3e-2, ``tests/test_kernels.py``'s bound; and a plain-torch
emulation of the bf16 kernel's arithmetic (128 x 128 tiles of the block's
band in order, log2-domain online softmax, the unnormalised p rounded to
bf16 before PV, l from the f32 p) against the Pallas kernel and the plain
version at the same 3e-2; a plain-torch emulation of the f32 kernel's
arithmetic (its tiles, q scaled into the log2 domain, exp2 online softmax,
-1e30 log2 e in the mask and -inf past Skv, the final division and the
natural-log LSE) against the Pallas kernel and the plain version's output
and LSE at 1e-5, over causal and not, windows 1 to 64, G 1/3/7, hd
32/64/128, tails and tiles whose real keys are all masked. The backward:
``attention_bwd_ref`` and the dispatcher's autograd against autograd
through ``ref.attention_ref`` (f32, atol 1e-5) and against ``jax.vjp`` of
``repro``'s oracle, naive and chunked (block 64) paths (atol 2e-5), over
causal and not, windows, G 1/3/7, hd 32/64/128 and S 200; in bf16 to
3e-2 of the largest |gradient| (the gradients are rounded to bf16, so the
error scales with them) against the
f32 gradients of the same values and ``repro``'s bf16 oracle; the plain
LSE against ``torch.logsumexp``. A plain-torch emulation of the bf16
backward kernels' arithmetic (P rounded to bf16 and dS split into two bf16
parts before the products, each query head's dK and dV summed over G in
order) within
``chip_smoke.py``'s row-scaled bound (2^-6) of the plain version and 3e-2
of ``jax.vjp`` of ``repro``'s oracle, at the backward cases and smollm's
training layout at S 512; that bound failing the emulation with a
window-edge tile dropped or unmasked at starcoder2's hd 128 and 4,096
window. The wrappers' checks (TMA's 16-byte
strides and base addresses for bf16 among them) raise before any launch.

On the card (``cuda`` marker, skipped here): one tile of the bf16 kernel's
building blocks (TMA loads, the Q K^T wgmma, the PV wgmma fed P from
registers) against ``torch.matmul``; the kernel against its plain version
on the same grid (f32 at rtol 1e-5 / atol 2e-5: the same function summed
in another order), at bf16 full-width shapes with tails, at hd 32, 64 and
128, on a packed strided view and on tiles whose real keys are all masked
(atol 3e-2: the two round the weights to bf16 at nearly the same place, the
plain version after normalising, the kernel before), and against the
emulation; the f32 kernel against its emulation (1e-5, output and LSE), an
f32 view off 16 bytes copied by the wrapper (counted) to the aligned
inputs' bits; a bf16 view TMA cannot take raises; the forward's LSE against
the plain one and its output with and without the LSE bitwise; the
backward kernel against ``attention_bwd_ref`` on the same hazards (f32 to
rtol 1e-4 with a floor of 1e-4 of the largest |gradient|: one function
summed in another order; bf16 to 2^-6 of each row's largest |value|, no
row's scale below 2^-10 of the tensor's: both sum in f32 and round once, a
rounding step is at most 2^-7, and a row that cancels to 0 holds only
rounding residue), bitwise on a
re-run, one launch count a call, through the dispatcher's autograd; at the
grids' edges (G 1 on a full grid with no sum pass and on a small, split
one, G 7 and 9, Sq and Skv off the tile, windows of two keys and under one
tile) in both dtypes, the plan's launches (two where neither G nor its
splits exceed 1, else three), re-runs bitwise under deterministic
algorithms; the plan splitting only grids under half the card's block
slots; the bf16 kernel against its emulation; no backward
instantiation with local memory, HGMMA in every bf16 dK/dV-and-dQ one; f32
views off 16 bytes, which the wrapper copies, bitwise the aligned inputs'
gradients.

    python -m pytest -q -m cuda tests/test_torch_flash.py   # on the card
"""
import importlib.util
import itertools
import pathlib
import re
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models.layers import chunked_gqa_attention, gqa_attention, gqa_scores_mask
from repro_torch.kernels import ops, ref
from repro_torch.kernels import flash_attn as fa_mod
from repro_torch.kernels.flash_attn import flash_attention_cuda

pytestmark = pytest.mark.quick

ATOL = 2e-5
BF16_ATOL = 3e-2
SEQS, GROUPS, HEAD_DIMS, WINDOWS = (32, 128, 200, 256, 384), (1, 3, 7), (32, 64, 128), (None, 16, 64)


def _cross_cases():
    """Every (S, G) pair once; head_dim, window and causal cycling so that
    every (head_dim, window) pair and both causal settings occur."""
    out = []
    for i, (S, G) in enumerate(itertools.product(SEQS, GROUPS)):
        out.append((S, 2 if G == 1 else 1, G, HEAD_DIMS[i % 3], WINDOWS[(i + i // 3) % 3],
                    i % 2 == 0))
    return out


# (S, K, G, hd, window, causal): the (S, G) cross, then every (hd, window,
# causal) at S 256 with G 3
CASES = _cross_cases() + [(256, 2, 3, hd, w, c) for hd, w, c in
                          itertools.product(HEAD_DIMS, WINDOWS, (True, False))]


def _case_id(c):
    S, K, G, hd, w, causal = c
    return f"S{S}-K{K}-G{G}-hd{hd}-w{w}-{'causal' if causal else 'full'}"


def _qkv(seed, B, S, K, G, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, K * G, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    return q, k, v


def _t(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


# ------------------------------------------------------------------- CPU
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_matches_every_repro_path(case):
    S, K, G, hd, window, causal = case
    q, k, v = _qkv(S * 7 + hd + G, 1, S, K, G, hd)
    mine = ref.attention_ref(_t(q), _t(k), _t(v), causal, window).numpy()
    routed = ops.flash_attention(_t(q), _t(k), _t(v), causal, window).numpy()
    np.testing.assert_array_equal(routed, mine)  # the CPU route is the plain version
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    wants = {
        "oracle": jax_ref.attention_ref(jq, jk, jv, causal=causal, window=window),
        "naive": gqa_attention(jq, jk, jv, gqa_scores_mask(S, S, causal, window)),
    }
    if S % min(128, S) == 0:  # the Pallas kernel's tiling assert
        wants["pallas"] = jax_ops.flash_attention(jq, jk, jv, causal=causal, window=window)
    if S % 64 == 0:
        wants["chunked"] = chunked_gqa_attention(jq, jk, jv, causal, window, block_q=64)
    assert S != 200 or set(wants) == {"oracle", "naive"}
    for name, want in wants.items():
        np.testing.assert_allclose(mine, np.asarray(want), atol=ATOL, err_msg=name)


@pytest.mark.parametrize("q_offset", [0, 5, 64])
def test_plain_query_offset_matches_repro(q_offset):
    q, k, v = _qkv(3, 2, 96, 2, 3, 32)
    q = q[:, :40]
    for window in (None, 24):
        mine = ref.attention_ref(_t(q), _t(k), _t(v), True, window, q_offset)
        want = jax_ref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal=True, window=window, q_offset=q_offset)
        np.testing.assert_allclose(mine.numpy(), np.asarray(want), atol=ATOL)


BF16_CASES = [(128, 2, 1, 64, None), (256, 2, 3, 128, 64), (384, 1, 7, 32, 16)]


@pytest.mark.parametrize("S,K,G,hd,window", BF16_CASES)
def test_bf16_matches_repro_flash(S, K, G, hd, window):
    q, k, v = _qkv(11, 1, S, K, G, hd)
    bf = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    want = jax_ops.flash_attention(*bf, causal=True, window=window)
    # the same bf16 values on both sides
    mine = ops.flash_attention(*(_t(np.asarray(a, np.float32), torch.bfloat16) for a in bf),
                               True, window)
    assert mine.dtype == torch.bfloat16
    np.testing.assert_allclose(mine.float().numpy(), np.asarray(want, np.float32),
                               atol=BF16_ATOL)


def kernel_emulation(q, k, v, causal=True, window=None, block=128, fault=None):
    """The bf16 kernel's arithmetic (``csrc/flash_attn.cu``,
    ``flash_fwd_kernel_wgmma``) in plain torch on (B, S, H, hd) bf16: per
    block of ``block`` query rows, the ``block``-key tiles of the block's
    band in order; S in f32 from the bf16 products; logits times scale *
    log2 e, band-masked ones -1e30, keys past Skv -inf; m from -1e30, alpha =
    exp2(m_prev - m_new), p = exp2(x - m_new); l gathers the f32 p, the PV
    product the p rounded to bf16; out = acc / max(l, 1e-30) in bf16.

    ``fault`` breaks it where a window cuts the block's band (its lowest
    visible key is past 0), as a kernel's bug could: ``"drop_edge_tile"``
    skips the band's first tile (kt_lo one too high), ``"unmasked_edge_tile"``
    leaves the window's mask off that tile."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    qf = q.float().transpose(1, 2)  # (B, H, Sq, hd)
    kf = k.float().transpose(1, 2).repeat_interleave(H // K, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(H // K, dim=1)
    c = (1.0 / np.sqrt(hd)) * np.log2(np.e)
    out = torch.empty_like(qf)
    for q0 in range(0, Sq, block):
        rows = torch.arange(q0, min(q0 + block, Sq))
        kt_hi = (Skv - 1) // block
        if causal:
            kt_hi = min(kt_hi, int(rows[-1]) // block)
        lo = q0 - window + 1 if window is not None else 0
        kt_lo = lo // block if lo > 0 else 0
        edge = kt_lo if lo > 0 else None  # the tile the window's edge crosses
        if fault == "drop_edge_tile" and edge is not None:
            kt_lo += 1
        m = torch.full((B, H, len(rows), 1), -1e30)
        l = torch.zeros((B, H, len(rows), 1))
        acc = torch.zeros((B, H, len(rows), hd))
        for kt in range(kt_lo, kt_hi + 1):
            keys = torch.arange(kt * block, (kt + 1) * block)
            real = keys < Skv
            kk = keys.clamp(max=Skv - 1)
            x = (qf[:, :, rows] @ kf[:, :, kk].transpose(-1, -2)) * np.float32(c)
            ok = torch.ones((len(rows), block), dtype=torch.bool)
            if causal:
                ok &= keys[None, :] <= rows[:, None]
            if window is not None and not (fault == "unmasked_edge_tile" and kt == edge):
                ok &= keys[None, :] > rows[:, None] - window
            x = x.masked_fill(~ok, -1e30).masked_fill(~real, float("-inf"))
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            vt = vf[:, :, kk] * real[:, None].float()
            acc = acc * alpha + p.to(torch.bfloat16).float() @ vt
            m = m_new
        out[:, :, rows] = acc / l.clamp(min=1e-30)
    return out.transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("S,K,G,hd,window", BF16_CASES + [(256, 1, 3, 64, 10)])
def test_kernel_arithmetic_matches_repro_flash_bf16(S, K, G, hd, window):
    """The numerics the card runs, pinned on the CPU: the emulation against
    ``repro``'s Pallas kernel (interpret mode, bf16) and the plain version."""
    q, k, v = _qkv(13, 2, S, K, G, hd)
    bf = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    tq, tk, tv = (_t(np.asarray(a, np.float32), torch.bfloat16) for a in bf)
    mine = kernel_emulation(tq, tk, tv, True, window)
    assert mine.dtype == torch.bfloat16 and torch.isfinite(mine.float()).all()
    want = jax_ops.flash_attention(*bf, causal=True, window=window)
    np.testing.assert_allclose(mine.float().numpy(), np.asarray(want, np.float32),
                               atol=BF16_ATOL)
    plain = ref.attention_ref(tq, tk, tv, True, window)
    np.testing.assert_allclose(mine.float().numpy(), plain.float().numpy(), atol=BF16_ATOL)


@pytest.mark.parametrize("S,window,causal", [(200, 1, True), (300, 10, True), (200, 5, False)])
def test_kernel_arithmetic_on_masked_tiles_and_tails_bf16(S, window, causal):
    """Tails (S not a multiple of the tile) and rows whose first tile of the
    block's band holds no visible key: the emulation against the plain
    version (the Pallas kernel asserts S % 128 == 0)."""
    q, k, v = (_t(a, torch.bfloat16) for a in _qkv(17, 1, S, 2, 3, 64))
    mine = kernel_emulation(q, k, v, causal, window)
    plain = ref.attention_ref(q, k, v, causal, window)
    np.testing.assert_allclose(mine.float().numpy(), plain.float().numpy(), atol=BF16_ATOL)


def kernel_emulation_f32(q, k, v, causal=True, window=None, block_q=128, block_k=None):
    """The f32 kernel's arithmetic (``csrc/flash_attn.cu``,
    ``flash_fwd_kernel``) in plain torch on (B, S, H, hd) f32: per block of
    ``block_q`` query rows, the ``block_k``-key tiles of the block's band in
    order; q times scale * log2 e (one f32 constant) before Q K^T, so the
    logits come in the log2 domain, band-masked ones -1e30 * log2 e, keys
    past Skv -inf; m from -1e30 * log2 e, alpha =
    exp2(m_prev - m_new), p = exp2(x - m_new) kept in f32; l gathers p, acc
    the f32 PV product; out = acc / max(l, 1e-30) and the natural-log LSE
    (m + log2 max(l, 1e-30)) * ln 2. Returns (out, lse (B, H, Sq)). The
    kernel's tiles: 128 query rows, and 64 keys at hd 32 and 64, 128 at hd
    128 (``F32Fwd``)."""
    B, Sq, H, hd = q.shape
    block_k = block_k or (128 if hd == 128 else 64)
    Skv, K = k.shape[1], k.shape[2]
    log2e = np.float32(np.log2(np.e))
    c = float(np.float32(np.float32(1.0 / np.sqrt(hd)) * log2e))
    masked = float(np.float32(-1e30) * log2e)
    qf = q.float().transpose(1, 2) * c  # (B, H, Sq, hd), in the log2 domain
    kf = k.float().transpose(1, 2).repeat_interleave(H // K, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(H // K, dim=1)
    out = torch.empty_like(qf)
    lse = torch.empty((B, H, Sq))
    for q0 in range(0, Sq, block_q):
        rows = torch.arange(q0, min(q0 + block_q, Sq))
        kt_hi = (Skv - 1) // block_k
        if causal:
            kt_hi = min(kt_hi, (q0 + len(rows) - 1) // block_k)
        lo = q0 - window + 1 if window is not None else 0
        kt_lo = lo // block_k if lo > 0 else 0
        m = torch.full((B, H, len(rows), 1), masked)
        l = torch.zeros((B, H, len(rows), 1))
        acc = torch.zeros((B, H, len(rows), hd))
        for kt in range(kt_lo, kt_hi + 1):
            keys = torch.arange(kt * block_k, (kt + 1) * block_k)
            real = keys < Skv
            kk = keys.clamp(max=Skv - 1)
            x = qf[:, :, rows] @ kf[:, :, kk].transpose(-1, -2)
            ok = torch.ones((len(rows), block_k), dtype=torch.bool)
            if causal:
                ok &= keys[None, :] <= rows[:, None]
            if window is not None:
                ok &= keys[None, :] > rows[:, None] - window
            x = x.masked_fill(~ok, masked).masked_fill(~real, float("-inf"))
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p @ (vf[:, :, kk] * real[:, None].float())
            m = m_new
        den = l.clamp(min=1e-30)
        out[:, :, rows] = acc / den
        lse[:, :, rows] = ((m + torch.log2(den)) * float(np.float32(np.log(2.0))))[..., 0]
    return out.transpose(1, 2), lse


# (S, K, G, hd, window, causal): causal and not, windows 16 and 64, G 1 / 3 / 7, hd 32 /
# 64 / 128, S 200 (a tail), and windows of 1, 5 and 10 keys, under which a row's first tile
# of the block's band holds real keys that are all masked
F32_EMU_CASES = [
    (256, 2, 1, 32, None, True), (256, 1, 3, 64, None, False), (256, 2, 3, 128, 16, True),
    (128, 1, 7, 64, 64, True), (256, 2, 7, 32, 64, False), (256, 1, 1, 128, None, False),
    (200, 2, 3, 64, None, True), (200, 1, 7, 128, 64, False), (200, 2, 1, 32, 16, True),
    (200, 2, 3, 64, 1, True), (300, 1, 3, 128, 10, True), (200, 2, 3, 32, 5, False),
]


@pytest.mark.parametrize("case", F32_EMU_CASES, ids=_case_id)
def test_kernel_arithmetic_matches_repro_flash_f32(case):
    """The f32 kernel's numerics pinned on the CPU: the emulation against
    ``repro``'s Pallas kernel (interpret mode; it asserts S % 128 == 0, so
    S 200 and 300 skip it) and against the plain version's output and LSE,
    to 1e-5."""
    S, K, G, hd, window, causal = case
    q, k, v = _qkv(S * 3 + hd + G, 2, S, K, G, hd)
    mine, mine_lse = kernel_emulation_f32(_t(q), _t(k), _t(v), causal, window)
    assert torch.isfinite(mine).all() and torch.isfinite(mine_lse).all()
    want, want_lse = ref.attention_fwd_ref(_t(q), _t(k), _t(v), causal, window)
    np.testing.assert_allclose(mine.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mine_lse.numpy(), want_lse.numpy(), rtol=1e-5, atol=1e-5)
    if S % 128 == 0:
        pallas = jax_ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         causal=causal, window=window)
        np.testing.assert_allclose(mine.numpy(), np.asarray(pallas), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def window_edge_case():
    """starcoder2's hd 128 and 4,096 window on one head: rows 4,096 on see a
    full window, 32 tiles and a bit of a 33rd."""
    q, k, v = (_t(a, torch.bfloat16) for a in _qkv(19, 1, 4352, 1, 1, 128))
    return q, k, v, ref.attention_ref(q, k, v, True, 4096)


@pytest.mark.parametrize("fault", [None, "drop_edge_tile", "unmasked_edge_tile"])
def test_row_scaled_bound_catches_window_edge_faults(chip_smoke, window_edge_case, fault):
    """``chip_smoke.py`` holds the bf16 kernel to its plain version by an
    absolute bound and by a bound scaled to each output row. The emulation
    passes both; with its window-edge tile dropped or unmasked (~3 % of a
    deep row's weight, outputs of spread ~0.026) it fails the row-scaled
    one by a factor above 4 (while its largest error, under 0.03, would
    pass the absolute one)."""
    q, k, v, plain = window_edge_case
    mine = kernel_emulation(q, k, v, True, 4096, fault=fault)
    err = (mine.float() - plain.float()).abs().max().item()
    row_rel = chip_smoke._row_rel(mine, plain)
    if fault is None:
        assert err <= chip_smoke.FLASH_BF16_ATOL
        assert row_rel <= chip_smoke.FLASH_BF16_ROW_REL
    else:
        assert row_rel > 4 * chip_smoke.FLASH_BF16_ROW_REL


# (S, K, G, hd, window, causal): G 1/3/7, hd 32/64/128, tails, windows
BWD_CASES = [(128, 1, 3, 64, None, True), (128, 2, 3, 64, None, False),
             (200, 2, 1, 32, 16, True), (200, 1, 7, 64, None, True),
             (256, 1, 7, 128, None, False), (256, 2, 3, 128, 64, True),
             (192, 2, 1, 32, 64, False)]
BWD_ATOL = 1e-5  # the plain backward vs autograd through the plain forward


def _qkvd(seed, B, S, K, G, hd):
    q, k, v = _qkv(seed, B, S, K, G, hd)
    return q, k, v, np.random.default_rng(seed + 1).standard_normal(q.shape).astype(np.float32)


def _rel_err(got, want) -> float:
    """max |got - want| / max |want|, in f32."""
    got, want = (torch.as_tensor(np.asarray(t, np.float32)) if not torch.is_tensor(t)
                 else t.float() for t in (got, want))
    return ((got - want).abs().max() / want.abs().max()).item()


def _vjp(fn, q, k, v, do):
    _, pull = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in pull(jnp.asarray(do))]


@pytest.mark.parametrize("case", BWD_CASES, ids=_case_id)
def test_backward_plain_matches_autograd_and_repro(case):
    S, K, G, hd, window, causal = case
    q, k, v, do = _qkvd(S + 3 * G + hd, 2, S, K, G, hd)
    tq, tk, tv, tdo = (_t(a) for a in (q, k, v, do))
    o, lse = ref.attention_fwd_ref(tq, tk, tv, causal, window)
    mine = ref.attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal, window)
    # the dispatcher's autograd is the plain backward on the CPU
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = ops.flash_attention(*leaves, causal, window)
    for got, want in zip(torch.autograd.grad(out, leaves, tdo), mine):
        assert torch.equal(got, want)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = ref.attention_ref(*leaves, causal, window)
    for got, want in zip(mine, torch.autograd.grad(out, leaves, tdo)):
        torch.testing.assert_close(got, want, rtol=0, atol=BWD_ATOL)
    wants = {
        "oracle": _vjp(lambda a, b, c: jax_ref.attention_ref(a, b, c, causal=causal,
                                                             window=window), q, k, v, do),
        "naive": _vjp(lambda a, b, c: gqa_attention(a, b, c, gqa_scores_mask(S, S, causal,
                                                                             window)),
                      q, k, v, do),
    }
    if S % 64 == 0:
        wants["chunked"] = _vjp(lambda a, b, c: chunked_gqa_attention(a, b, c, causal, window,
                                                                      block_q=64), q, k, v, do)
    assert S % 64 == 0 or set(wants) == {"oracle", "naive"}
    for name, want in wants.items():
        for got, w, what in zip(mine, want, "qkv"):
            np.testing.assert_allclose(got.numpy(), w, atol=ATOL, err_msg=f"{name} d{what}")


def test_backward_plain_query_blocks():
    """``block_q`` only bounds the plain version's memory: dq is the same,
    dk and dv are summed over the blocks in f32."""
    q, k, v, do = (_t(a) for a in _qkvd(9, 1, 200, 2, 3, 64))
    o, lse = ref.attention_fwd_ref(q, k, v, True, 48)
    whole = ref.attention_bwd_ref(q, k, v, o, lse, do, True, 48)
    blocks = ref.attention_bwd_ref(q, k, v, o, lse, do, True, 48, block_q=64)
    assert torch.equal(whole[0], blocks[0])
    for got, want in zip(blocks[1:], whole[1:]):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("S,K,G,hd,window", BF16_CASES + [(200, 2, 1, 32, 16)])
def test_backward_bf16_matches_f32_and_repro(S, K, G, hd, window):
    q, k, v, do = _qkvd(S + G, 2, S, K, G, hd)
    bq, bk, bv, bdo = (_t(a, torch.bfloat16) for a in (q, k, v, do))
    leaves = [t.clone().requires_grad_() for t in (bq, bk, bv)]
    got = torch.autograd.grad(ops.flash_attention(*leaves, True, window), leaves, bdo)
    assert all(g.dtype == torch.bfloat16 for g in got)
    f32 = [t.float() for t in (bq, bk, bv)]
    o, lse = ref.attention_fwd_ref(*f32, True, window)
    want = ref.attention_bwd_ref(*f32, o, lse, bdo.float(), True, window)
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v, do)]
    _, pull = jax.vjp(lambda a, b, c: jax_ref.attention_ref(a, b, c, causal=True,
                                                            window=window), *jb[:3])
    for g, w, jw in zip(got, want, pull(jb[3])):
        assert _rel_err(g, w) <= BF16_ATOL
        assert _rel_err(g, jw) <= BF16_ATOL


def bwd_kernel_emulation(cs, q, k, v, o, lse, do, causal=True, window=None, fault=None):
    """``chip_smoke.bwd_kernel_emulation`` (of module ``cs``), the bf16
    backward kernel's arithmetic: P rounded to bf16 and dS split into two
    bf16 parts before the products, each query head's dK and dV summed over
    G in order.

    ``fault`` breaks the band where a window cuts a dQ block's (128 rows)
    band, as a kernel's bug could: ``"drop_edge_tile"`` loses the band's
    first 64-key tile, ``"unmasked_edge_tile"`` leaves the window's mask off
    it."""
    Sq, Skv = q.shape[1], k.shape[1]
    band = None
    if fault is not None:
        band = ref._band(Sq, Skv, causal, window, 0, q.device)
        causal_only = ref._band(Sq, Skv, causal, None, 0, q.device)
        for q0 in range(0, Sq, 128):
            lo = q0 - window + 1
            if lo <= 0:
                continue
            rows, keys = slice(q0, q0 + 128), slice(lo // 64 * 64, lo // 64 * 64 + 64)
            band[rows, keys] = False if fault == "drop_edge_tile" else causal_only[rows, keys]
    return cs.bwd_kernel_emulation(q, k, v, o, lse, do, causal, window, band=band)


# BWD_CASES with batch 2, and smollm-135m's training layout (B 4, H 9, K 3,
# hd 64, causal) at S 512
EMU_CASES = [(2,) + c for c in BWD_CASES] + [(4, 512, 3, 3, 64, None, True)]


@pytest.mark.parametrize("case", EMU_CASES, ids=lambda c: f"B{c[0]}-" + _case_id(c[1:]))
def test_backward_kernel_arithmetic_bf16(chip_smoke, case):
    """The bf16 backward's numerics, pinned on the CPU: the emulation within
    ``chip_smoke.py``'s row-scaled bound (FLASH_BWD_BF16_ROW_REL) of the
    plain version, and within 3e-2 of the largest |gradient| of ``jax.vjp``
    of ``repro``'s oracle on the same bf16 values in f32."""
    B, S, K, G, hd, window, causal = case
    q, k, v, do = _qkvd(S + 5 * G + hd, B, S, K, G, hd)
    bq, bk, bv, bdo = (_t(a, torch.bfloat16) for a in (q, k, v, do))
    o, lse = ref.attention_fwd_ref(bq, bk, bv, causal, window)
    mine = bwd_kernel_emulation(chip_smoke, bq, bk, bv, o, lse, bdo, causal, window)
    assert all(g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all() for g in mine)
    plain = ref.attention_bwd_ref(bq, bk, bv, o, lse, bdo, causal, window)
    for g, w in zip(mine, plain):
        assert chip_smoke.flash_bwd_ok(g, w), chip_smoke._row_rel(g, w, chip_smoke.FLASH_BWD_ROW_FLOOR)
    f32 = [np.asarray(t.float().numpy()) for t in (bq, bk, bv, bdo)]
    want = _vjp(lambda a, b, c: jax_ref.attention_ref(a, b, c, causal=causal, window=window), *f32)
    for g, w in zip(mine, want):
        assert _rel_err(g, w) <= BF16_ATOL


@pytest.fixture(scope="module")
def window_edge_bwd(window_edge_case):
    """``window_edge_case`` with a dO, the forward's output and LSE, and the
    plain backward."""
    q, k, v, _ = window_edge_case
    do = _t(np.random.default_rng(23).standard_normal(q.shape).astype(np.float32),
            torch.bfloat16)
    o, lse = ref.attention_fwd_ref(q, k, v, True, 4096)
    return q, k, v, o, lse, do, ref.attention_bwd_ref(q, k, v, o, lse, do, True, 4096,
                                                      block_q=1024)


@pytest.mark.parametrize("fault", [None, "drop_edge_tile", "unmasked_edge_tile"])
def test_backward_row_bound_catches_window_edge_faults(chip_smoke, window_edge_bwd, fault):
    """At starcoder2's hd 128 and 4,096 window the emulation passes
    ``chip_smoke.py``'s bf16 backward bound (every gradient's rows within
    2^-6 of their largest |value|); with its window-edge tile dropped or
    unmasked it fails it by a factor above 4 (dQ's rows, which cancel, read
    the fault most)."""
    *inputs, plain = window_edge_bwd
    mine = bwd_kernel_emulation(chip_smoke, *inputs, True, 4096, fault=fault)
    rels = [chip_smoke._row_rel(g, w, chip_smoke.FLASH_BWD_ROW_FLOOR) for g, w in zip(mine, plain)]
    if fault is None:
        assert all(chip_smoke.flash_bwd_ok(g, w) for g, w in zip(mine, plain)), rels
    else:
        assert max(rels) > 4 * chip_smoke.FLASH_BWD_BF16_ROW_REL, rels


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 24), (False, None)])
def test_plain_lse_matches_logsumexp(dtype, causal, window):
    q, k, v = (_t(a, dtype) for a in _qkv(4, 2, 96, 2, 3, 32))
    out, lse = ref.attention_fwd_ref(q, k, v, causal, window)
    assert torch.equal(out, ref.attention_ref(q, k, v, causal, window))
    assert lse.shape == (2, 6, 96) and lse.dtype == torch.float32
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float().repeat_interleave(3, dim=2))
    i, j = torch.arange(96)[:, None], torch.arange(96)[None, :]
    ok = torch.ones(96, 96, dtype=torch.bool)
    if causal:
        ok &= j <= i
    if window is not None:
        ok &= j > i - window
    want = torch.logsumexp((s / np.sqrt(32)).masked_fill(~ok, -1e30), dim=-1)
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-5)


def test_backward_wrapper_checks_before_launching():
    q, k, v, do = (_t(a) for a in _qkvd(1, 1, 32, 1, 3, 32))
    o, lse = ref.attention_fwd_ref(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        fa_mod.flash_attention_bwd_cuda(q, k, v, o, lse, do)
    with pytest.raises(ValueError, match="lse"):
        fa_mod.flash_attention_bwd_cuda(q, k, v, o, lse[:, :1], do)
    with pytest.raises(ValueError, match="lse"):
        fa_mod.flash_attention_bwd_cuda(q, k, v, o, lse.double(), do)
    with pytest.raises(ValueError, match="do"):
        fa_mod.flash_attention_bwd_cuda(q, k, v, o, lse, do.bfloat16())
    with pytest.raises(ValueError, match="head_dim"):
        fa_mod.flash_attention_bwd_cuda(q, k, v, o, lse, do[..., ::2].repeat(1, 1, 1, 2)[..., ::2])
    with pytest.raises(ValueError, match="window"):
        fa_mod.flash_attention_bwd_cuda(q, k, v, o, lse, do, window=0)
    with pytest.raises(ValueError, match="device"):
        ops.flash_attention_bwd(q.to("meta"), k, v, o, lse, do)


def test_kernel_wrapper_checks_before_launching():
    q, k, v = (_t(a) for a in _qkv(1, 1, 32, 1, 3, 32))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_cuda(*(_t(a) for a in _qkv(1, 1, 8, 1, 1, 96)))
    with pytest.raises(TypeError):
        flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        flash_attention_cuda(q, k, v[:, :16])
    with pytest.raises(ValueError, match="window"):
        flash_attention_cuda(q, k, v, window=0)
    with pytest.raises(ValueError, match="device"):
        ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    # bf16 goes through TMA: every stride and the base address in 16 bytes,
    # checked before the device (and before any launch)
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(qb, kb, vb)
    wide = torch.zeros(1, 32, 3, 36, dtype=torch.bfloat16)[..., :32]  # head stride 72 bytes
    with pytest.raises(ValueError, match="TMA"):
        flash_attention_cuda(wide, kb, vb)
    flat = torch.zeros(32 * 32 + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(1, 32, 1, 32)  # base address 2 bytes past the allocation
    with pytest.raises(ValueError, match="TMA"):
        flash_attention_cuda(qb, shifted, vb)
    with pytest.raises(ValueError, match="TMA"):
        flash_attention_cuda(qb, kb, shifted)


# ------------------------------------------------------------------- card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on(cuda, arrays, dtype=torch.float32):
    return [_t(a, dtype).to(cuda) for a in arrays]


@pytest.mark.cuda
class TestOnCard:
    @pytest.mark.parametrize("case", CASES, ids=_case_id)
    def test_kernel_matches_plain_f32(self, cuda, case):
        S, K, G, hd, window, causal = case
        q, k, v = _on(cuda, _qkv(S + hd, 2, S, K, G, hd))
        n = fa_mod.launches
        got = flash_attention_cuda(q, k, v, causal, window)
        torch.cuda.synchronize()
        assert fa_mod.launches == n + 1
        want = ref.attention_ref(q, k, v, causal, window)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=ATOL)

    @pytest.mark.parametrize("B,S,K,G,hd,window", [
        (4, 2048, 3, 3, 64, None),  # smollm-135m
        (1, 1000, 2, 7, 64, None),  # qwen2-0.5b, a tail tile
        (1, 4100, 4, 9, 128, 4096),  # starcoder2-7b's window, a tail tile
        (2, 77, 8, 7, 128, None),  # deepseek-coder-33b, one short tile
    ])
    def test_kernel_matches_plain_bf16(self, cuda, B, S, K, G, hd, window):
        q, k, v = _on(cuda, _qkv(S, B, S, K, G, hd), torch.bfloat16)
        got = flash_attention_cuda(q, k, v, True, window)
        want = torch.cat([ref.attention_ref(q[:, i:i + 512], k, v, True, window, i)
                          for i in range(0, S, 512)], dim=1)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=BF16_ATOL)

    @pytest.mark.parametrize("case", F32_EMU_CASES, ids=_case_id)
    def test_kernel_matches_its_emulation_f32(self, cuda, case):
        S, K, G, hd, window, causal = case
        q, k, v = _on(cuda, _qkv(S * 3 + hd + G, 2, S, K, G, hd))
        got, lse = flash_attention_cuda(q, k, v, causal, window, with_lse=True)
        want, want_lse = kernel_emulation_f32(q.cpu(), k.cpu(), v.cpu(), causal, window)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(lse.cpu(), want_lse, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("which", ["q", "k", "v"])
    def test_kernel_reads_views_off_16_bytes_f32(self, cuda, which):
        """An f32 view 4 bytes past a 16-byte boundary, which the wrapper
        copies (``copies``) for the kernel's 16-byte loads: output and LSE
        bitwise those of the aligned inputs."""
        q, k, v = _on(cuda, _qkv(19, 2, 200, 2, 3, 64))
        want, want_lse = flash_attention_cuda(q, k, v, True, 48, with_lse=True)
        ins = {"q": q, "k": k, "v": v}
        t = ins[which]
        ins[which] = torch.cat([torch.zeros(1, device=cuda), t.flatten()])[1:].view(t.shape)
        assert ins[which].data_ptr() % 16 == 4 and torch.equal(ins[which], t)
        n = fa_mod.copies
        got, lse = flash_attention_cuda(ins["q"], ins["k"], ins["v"], True, 48, with_lse=True)
        assert fa_mod.copies == n + 1
        assert torch.equal(got, want) and torch.equal(lse, want_lse)

    def test_kernel_reads_strided_views(self, cuda):
        """q, k, v sliced out of one packed (B, S, H + 2K, hd) tensor."""
        B, S, K, G, hd = 2, 200, 2, 3, 64
        qkv = torch.randn(B, S, K * G + 2 * K, hd, device=cuda)
        q, k, v = qkv[:, :, :K * G], qkv[:, :, K * G:K * G + K], qkv[:, :, K * G + K:]
        assert not q.is_contiguous()
        torch.testing.assert_close(flash_attention_cuda(q, k, v, True, 32),
                                   ref.attention_ref(q, k, v, True, 32), rtol=1e-5, atol=ATOL)

    def test_wgmma_tile_matches_matmul(self, cuda):
        """One tile of the bf16 kernel's building blocks: q k^T through the
        K-major wgmma and bf16(s) v through the MN-major one with P from
        registers, each against torch.matmul in f32 (bf16 products are
        exact in f32: only the summation order differs, of 64 terms up to
        about 16 for s and of 128 terms up to about 60 for o)."""
        gen = torch.Generator(device=cuda).manual_seed(0)
        q, k, v = (torch.randn(n, 64, device=cuda, generator=gen).bfloat16()
                   for n in (64, 128, 128))
        s, o = fa_mod.wgmma_probe(q, k, v)
        torch.cuda.synchronize()
        torch.testing.assert_close(s, q.float() @ k.float().T, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(o, s.bfloat16().float() @ v.float(), rtol=1e-5, atol=1e-4)

    @pytest.mark.parametrize("hd", HEAD_DIMS)
    @pytest.mark.parametrize("causal,window", [(True, None), (True, 100), (False, None)])
    def test_kernel_matches_plain_bf16_head_dims(self, cuda, hd, causal, window):
        q, k, v = _on(cuda, _qkv(hd, 2, 333, 2, 3, hd), torch.bfloat16)
        n = fa_mod.launches
        got = flash_attention_cuda(q, k, v, causal, window)
        torch.cuda.synchronize()
        assert fa_mod.launches == n + 1
        torch.testing.assert_close(got.float(), ref.attention_ref(q, k, v, causal, window).float(),
                                   rtol=0, atol=BF16_ATOL)

    def test_kernel_reads_strided_views_bf16(self, cuda):
        """q, k, v sliced out of one packed bf16 (B, S, H + 2K, hd) tensor."""
        B, S, K, G, hd = 2, 200, 2, 3, 64
        qkv = torch.randn(B, S, K * G + 2 * K, hd, device=cuda).bfloat16()
        q, k, v = qkv[:, :, :K * G], qkv[:, :, K * G:K * G + K], qkv[:, :, K * G + K:]
        assert not q.is_contiguous()
        torch.testing.assert_close(flash_attention_cuda(q, k, v, True, 32).float(),
                                   ref.attention_ref(q, k, v, True, 32).float(),
                                   rtol=0, atol=BF16_ATOL)

    @pytest.mark.parametrize("S,window,causal", [(200, 1, True), (300, 10, True),
                                                 (200, 5, False)])
    def test_kernel_bf16_masked_tiles_and_tails(self, cuda, S, window, causal):
        q, k, v = _on(cuda, _qkv(S, 1, S, 2, 3, 64), torch.bfloat16)
        got = flash_attention_cuda(q, k, v, causal, window)
        torch.testing.assert_close(got.float(), ref.attention_ref(q, k, v, causal, window).float(),
                                   rtol=0, atol=BF16_ATOL)

    @pytest.mark.parametrize("S,K,G,hd,window", [(300, 2, 3, 64, None), (256, 1, 7, 128, 100),
                                                 (130, 2, 1, 32, None)])
    def test_kernel_matches_its_emulation_bf16(self, cuda, S, K, G, hd, window):
        """The card against the CPU emulation of its arithmetic: the same
        roundings, other summation orders and exp2 implementations."""
        q, k, v = (_t(a, torch.bfloat16) for a in _qkv(S + 1, 2, S, K, G, hd))
        got = flash_attention_cuda(q.to(cuda), k.to(cuda), v.to(cuda), True, window).cpu()
        torch.testing.assert_close(got.float(), kernel_emulation(q, k, v, True, window).float(),
                                   rtol=0, atol=1e-2)

    def test_kernel_raises_on_a_view_tma_cannot_take(self, cuda):
        q, k, v = _on(cuda, _qkv(5, 1, 64, 1, 3, 32), torch.bfloat16)
        wide = torch.zeros(1, 64, 3, 36, dtype=torch.bfloat16, device=cuda)[..., :32]
        n = fa_mod.launches
        with pytest.raises(ValueError, match="TMA"):
            flash_attention_cuda(wide, k, v)
        assert fa_mod.launches == n

    def test_ops_routes_cuda_to_the_kernel(self, cuda):
        q, k, v = _on(cuda, _qkv(2, 1, 64, 1, 3, 32))
        n = fa_mod.launches
        ops.flash_attention(q, k, v, True, None)
        assert fa_mod.launches == n + 1

    # --------------------------------------------------- LSE and backward
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("case", BWD_CASES, ids=_case_id)
    def test_forward_lse_matches_plain(self, cuda, dtype, case):
        S, K, G, hd, window, causal = case
        q, k, v = _on(cuda, _qkv(S + 1, 2, S, K, G, hd), dtype)
        n = fa_mod.launches
        out, lse = flash_attention_cuda(q, k, v, causal, window, with_lse=True)
        assert fa_mod.launches == n + 1 and lse.shape == (2, K * G, S)
        # the null-lse launch (the prefill's) writes the same output
        assert torch.equal(flash_attention_cuda(q, k, v, causal, window), out)
        torch.testing.assert_close(lse, ref.attention_fwd_ref(q, k, v, causal, window)[1],
                                   rtol=1e-5, atol=1e-5)

    @staticmethod
    def _check_bwd(cs, got, want, dtype):
        """``chip_smoke.py``'s tolerances for the backward kernel."""
        for g, w in zip(got, want):
            assert g.dtype == dtype and g.shape == w.shape and g.is_contiguous()
            assert cs.flash_bwd_ok(g, w), (cs._rel(g, w),
                                           cs._row_rel(g, w, cs.FLASH_BWD_ROW_FLOOR))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("case", BWD_CASES, ids=_case_id)
    def test_backward_kernel_matches_plain(self, cuda, chip_smoke, dtype, case):
        S, K, G, hd, window, causal = case
        q, k, v, do = _on(cuda, _qkvd(S + 2, 2, S, K, G, hd), dtype)
        o, lse = flash_attention_cuda(q, k, v, causal, window, with_lse=True)
        n = fa_mod.bwd_launches
        got = fa_mod.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal, window)
        torch.cuda.synchronize()
        plan = fa_mod.bwd_plan(dtype, 2, S, S, K * G, K, hd)
        assert fa_mod.bwd_launches == n + plan["launches"]
        self._check_bwd(chip_smoke, got, ref.attention_bwd_ref(q, k, v, o, lse, do, causal, window),
                        dtype)
        again = fa_mod.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal, window)
        assert all(torch.equal(a, b) for a, b in zip(got, again))

    @pytest.mark.parametrize("B,S,K,G,hd,window", [
        (4, 2048, 3, 3, 64, None),  # smollm-135m's training call
        (1, 1000, 2, 7, 64, None),  # qwen2-0.5b, a tail tile
        (1, 4100, 4, 9, 128, 4096),  # starcoder2-7b's window, a tail tile
    ])
    def test_backward_kernel_full_width_bf16(self, cuda, chip_smoke, B, S, K, G, hd, window):
        q, k, v, do = _on(cuda, _qkvd(S, B, S, K, G, hd), torch.bfloat16)
        o, lse = flash_attention_cuda(q, k, v, True, window, with_lse=True)
        got = fa_mod.flash_attention_bwd_cuda(q, k, v, o, lse, do, True, window)
        want = ref.attention_bwd_ref(q, k, v, o, lse, do, True, window, block_q=512)
        self._check_bwd(chip_smoke, got, want, torch.bfloat16)
        again = fa_mod.flash_attention_bwd_cuda(q, k, v, o, lse, do, True, window)
        assert all(torch.equal(a, b) for a, b in zip(got, again))

    # (B, S, K, G, hd, window, causal): the edges of the backward's grids
    @pytest.mark.parametrize("B,S,K,G,hd,window,causal", [
        (4, 1024, 4, 1, 64, None, True),  # G 1 on a full grid: no partials, no sum pass
        (2, 200, 2, 1, 64, None, True),  # G 1 on a small grid: split, dQ partials summed
        (1, 333, 2, 7, 64, None, True),  # G 7 (qwen2), Sq and Skv off the tile
        (2, 256, 1, 9, 128, None, False),  # G 9 (starcoder2's heads)
        (1, 333, 3, 3, 32, 100, True),  # off the tile, under a window
        (2, 300, 2, 3, 64, 16, True),  # a window shorter than one tile
        (1, 130, 2, 3, 128, 2, True),  # a window of two keys
    ])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_backward_grid_edges(self, cuda, chip_smoke, dtype, B, S, K, G, hd, window, causal):
        q, k, v, do = _on(cuda, _qkvd(S + G, B, S, K, G, hd), dtype)
        o, lse = flash_attention_cuda(q, k, v, causal, window, with_lse=True)
        n = fa_mod.bwd_launches
        got = fa_mod.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal, window)
        torch.cuda.synchronize()
        launches = fa_mod.bwd_launches - n
        plan = fa_mod.bwd_plan(dtype, B, S, S, K * G, K, hd)
        assert launches == plan["launches"] == (3 if G * plan["splits"] > 1 else 2)
        self._check_bwd(chip_smoke, got, ref.attention_bwd_ref(q, k, v, o, lse, do, causal, window),
                        dtype)
        torch.use_deterministic_algorithms(True)
        try:
            again = fa_mod.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal, window)
        finally:
            torch.use_deterministic_algorithms(False)
        assert all(torch.equal(a, b) for a, b in zip(got, again))

    def test_backward_plan_splits_only_small_grids(self, cuda):
        """``bwd_plan`` gives a tile more blocks only where its grid fills
        under half the card's block slots: one at the LM training call (B
        4, S 2,048, H 9, K 3, hd 64) in both dtypes and at G 1 on a full
        grid (no partials, two launches); more at B 2, S 200, H 4 (f32: 8
        tiles a head, two blocks an SM), with the scratch for the lse and D
        rows and every partial."""
        for dtype in (torch.float32, torch.bfloat16):
            assert fa_mod.bwd_plan(dtype, 4, 2048, 2048, 9, 3, 64)["splits"] == 1
        assert fa_mod.bwd_plan(torch.float32, 4, 1024, 1024, 4, 4, 64) == {
            "splits": 1, "scratch_floats": 2 * 4 * 4 * 1024, "launches": 2}
        small = fa_mod.bwd_plan(torch.float32, 2, 200, 200, 4, 2, 64)
        s, blocks = small["splits"], (4 + 4) * 4 * 2
        slots = 2 * torch.cuda.get_device_properties(cuda).multi_processor_count
        assert s > 1 and blocks * s <= slots and (2 * blocks * s > slots or 2 * s > 4)
        assert small["launches"] == 3
        assert small["scratch_floats"] == (2 * 2 * 4 * 256 + 2 * (2 * s) * 2 * 200 * 2 * 64
                                           + s * 2 * 200 * 4 * 64)

    @pytest.mark.parametrize("B,S,K,G,hd,window", [(2, 300, 2, 3, 64, None), (1, 256, 1, 7, 128, 100),
                                                   (2, 130, 2, 1, 32, None)])
    def test_backward_kernel_matches_its_emulation_bf16(self, cuda, chip_smoke, B, S, K, G, hd,
                                                        window):
        """The card against the CPU emulation of its arithmetic (P rounded
        to bf16, dS split into two bf16 parts): the same roundings, other
        summation orders and exp2 implementations."""
        q, k, v, do = (_t(a, torch.bfloat16) for a in _qkvd(S + 7, B, S, K, G, hd))
        o, lse = flash_attention_cuda(q.to(cuda), k.to(cuda), v.to(cuda), True, window,
                                      with_lse=True)
        got = fa_mod.flash_attention_bwd_cuda(q.to(cuda), k.to(cuda), v.to(cuda), o, lse,
                                              do.to(cuda), True, window)
        want = bwd_kernel_emulation(chip_smoke, q, k, v, o.cpu(), lse.cpu(), do, True, window)
        for g, w in zip(got, want):
            assert chip_smoke.flash_bwd_ok(g.cpu(), w)

    def test_backward_builds_on_the_tensor_cores_without_local_memory(self, cuda):
        """No instantiation of the backward uses local memory (spills or a
        stack), and the SASS of every bf16 instantiation of the dK/dV and dQ
        kernel holds HGMMA (``cuobjdump -sass`` on the built library)."""
        for dtype in (torch.float32, torch.bfloat16):
            for hd in HEAD_DIMS:
                for name, attrs in fa_mod.bwd_kernel_attrs(dtype, hd).items():
                    assert attrs["local_bytes"] == 0, (dtype, hd, name, attrs)
        cuobjdump = pathlib.Path(fa_mod.build.find_nvcc()).parent / "cuobjdump"
        sass = subprocess.run([str(cuobjdump), "-sass", str(fa_mod.build.build())],
                              capture_output=True, text=True, check=True).stdout
        bodies = re.split(r"^\s*Function : ", sass, flags=re.M)[1:]
        for hd in HEAD_DIMS:
            body = [b for b in bodies if b.startswith("_Z") and
                    f"flash_bwd_tiles_wgmmaILi{hd}E" in b.split(None, 1)[0]]
            assert len(body) == 1 and "HGMMA" in body[0], (hd, len(body))

    def test_backward_reads_strided_views(self, cuda, chip_smoke):
        """q, k, v from one packed tensor and a dO whose rows are strided."""
        B, S, K, G, hd = 2, 200, 2, 3, 64
        qkv = torch.randn(B, S, K * G + 2 * K, hd, device=cuda)
        q, k, v = qkv[:, :, :K * G], qkv[:, :, K * G:K * G + K], qkv[:, :, K * G + K:]
        do = torch.randn(B, S, K * G + 1, hd, device=cuda)[:, :, 1:]
        o, lse = flash_attention_cuda(q, k, v, True, 32, with_lse=True)
        got = fa_mod.flash_attention_bwd_cuda(q, k, v, o, lse, do, True, 32)
        self._check_bwd(chip_smoke, got, ref.attention_bwd_ref(q, k, v, o, lse, do, True, 32),
                        torch.float32)

    @pytest.mark.parametrize("which", ["q", "k", "do"])
    def test_backward_reads_views_off_16_bytes(self, cuda, which):
        """An f32 view 4 bytes past a 16-byte boundary, which the wrapper
        copies for the tile kernel's 16-byte loads: the gradients are
        bitwise those of the aligned inputs."""
        q, k, v, do = _on(cuda, _qkvd(11, 2, 200, 2, 3, 64))
        o, lse = flash_attention_cuda(q, k, v, True, 48, with_lse=True)
        want = fa_mod.flash_attention_bwd_cuda(q, k, v, o, lse, do, True, 48)
        ins = {"q": q, "k": k, "do": do}
        t = ins[which]
        ins[which] = torch.cat([torch.zeros(1, device=cuda), t.flatten()])[1:].view(t.shape)
        assert ins[which].data_ptr() % 16 == 4 and torch.equal(ins[which], t)
        got = fa_mod.flash_attention_bwd_cuda(ins["q"], ins["k"], v, o, lse, ins["do"], True, 48)
        assert all(torch.equal(a, b) for a, b in zip(got, want))

    def test_ops_routes_the_backward_to_the_kernel(self, cuda, chip_smoke):
        q, k, v, do = _on(cuda, _qkvd(3, 1, 96, 1, 3, 32))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        n, nb = fa_mod.launches, fa_mod.bwd_launches
        got = torch.autograd.grad(ops.flash_attention(*leaves, True, None), leaves, do)
        assert (fa_mod.launches, fa_mod.bwd_launches) == (n + 1, nb + len(fa_mod.BWD_KERNELS))
        plan = fa_mod.bwd_plan(torch.float32, 1, 96, 96, 3, 1, 32)
        assert plan["launches"] == len(fa_mod.BWD_KERNELS)
        o, lse = ref.attention_fwd_ref(q, k, v)
        self._check_bwd(chip_smoke, got, ref.attention_bwd_ref(q, k, v, o, lse, do),
                        torch.float32)


    def test_forward_stores_the_lse_only_for_a_backward(self, cuda, monkeypatch):
        """The prefill (no input needing a gradient) passes a null LSE."""
        q, k, v = _on(cuda, _qkv(5, 1, 64, 1, 3, 32))
        lib, seen = fa_mod.build.library(), []

        class Spy:
            def __getattr__(self, name):
                return getattr(lib, name)

            @staticmethod
            def g4r_flash_attn_fwd(*args):
                seen.append(args[4])  # the lse pointer
                return lib.g4r_flash_attn_fwd(*args)

        monkeypatch.setattr(fa_mod.build, "library", Spy)
        with torch.no_grad():
            ops.flash_attention(q, k, v, True, None)
        ops.flash_attention(q.requires_grad_(), k, v, True, None)
        assert seen[0] is None and seen[1] is not None
