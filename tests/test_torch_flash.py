"""The port's flash attention (``kernels.ops.flash_attention``, its plain
version ``kernels.ref.attention_ref`` and the kernel ``csrc/flash_attn.cu``)
against ``repro``'s attention paths.

On the CPU (every run): the port's plain version and its dispatcher, in
f32, against all of ``repro``'s full-sequence paths on the same numpy
inputs at atol 2e-5: its oracle ``kernels.ref.attention_ref``, the Pallas
kernel (``kernels.ops.flash_attention``, interpret mode; it asserts
``Sq % block_q == 0``, so S 200 skips it), the chunked XLA scan (block 64;
S 200 skips it too) and the naive ``gqa_attention`` with
``gqa_scores_mask``. In bf16 the port (weights cast to bf16 before PV, as
``repro``'s oracle) against the Pallas kernel (weights kept f32) at atol
3e-2, ``tests/test_kernels.py``'s bound. The backward raises.

On the card (``cuda`` marker, skipped here): the kernel against its plain
version on the same grid (f32 at rtol 1e-5 / atol 2e-5: the same function
summed in another order) and at bf16 full-width shapes with tails (atol
3e-2: the plain version rounds the weights to bf16, the kernel does not).

    python -m pytest -q -m cuda tests/test_torch_flash.py   # on the card
"""
import itertools

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


@pytest.mark.parametrize("S,K,G,hd,window", [(128, 2, 1, 64, None), (256, 2, 3, 128, 64),
                                             (384, 1, 7, 32, 16)])
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


def test_backward_raises():
    q, k, v = (_t(a).requires_grad_() for a in _qkv(1, 1, 32, 1, 3, 32))
    out = ops.flash_attention(q, k, v, True, None)
    assert out.grad_fn is not None
    with pytest.raises(NotImplementedError, match="item 8a"):
        out.sum().backward()


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

    def test_kernel_reads_strided_views(self, cuda):
        """q, k, v sliced out of one packed (B, S, H + 2K, hd) tensor."""
        B, S, K, G, hd = 2, 200, 2, 3, 64
        qkv = torch.randn(B, S, K * G + 2 * K, hd, device=cuda)
        q, k, v = qkv[:, :, :K * G], qkv[:, :, K * G:K * G + K], qkv[:, :, K * G + K:]
        assert not q.is_contiguous()
        torch.testing.assert_close(flash_attention_cuda(q, k, v, True, 32),
                                   ref.attention_ref(q, k, v, True, 32), rtol=1e-5, atol=ATOL)

    def test_ops_routes_cuda_to_the_kernel(self, cuda):
        q, k, v = _on(cuda, _qkv(2, 1, 64, 1, 3, 32))
        n = fa_mod.launches
        ops.flash_attention(q, k, v, True, None)
        assert fa_mod.launches == n + 1
