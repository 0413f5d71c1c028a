"""The port's kernels against ``repro``'s: plain versions on the CPU, CUDA
kernels against their plain versions on the card.

On the CPU, ``repro_torch.kernels.ref`` is held against ``repro``'s jnp
oracles and its Pallas kernels (interpret mode), on inputs made with numpy
from a fixed seed. Tolerances: f32 values to rtol 1e-5 / atol 1e-6 (XLA and
torch sum in different orders); top-k ids exactly.

``TestOnCard`` runs only where there is a CUDA card. ``repro`` is imported
by a fixture that skips unless JAX is present and on the CPU, so on the
card's machine the card tests run without it:
    python -m pytest -q -m cuda tests/test_torch_kernels.py
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.seg_aggr import seg_aggr_cuda
from repro_torch.kernels.topk import CHUNK, MAX_K, MAX_SPLITS, plan_splits, streaming_topk_cuda
from repro_torch.retrieval import chunked_topk

pytestmark = pytest.mark.quick

RTOL, ATOL = 1e-5, 1e-6
MODES = ("sum", "mean", "max")


def _seg_data(seed, N, F, D, p=0.6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, F, D)).astype(np.float32)
    mask = rng.random((N, F)) < p
    mask[::5] = False  # all-masked rows
    return x, mask


def _topk_data(seed=0, Q=29, I=501, d=16, E=6, int_valued=False):
    rng = np.random.default_rng(seed)
    if int_valued:  # exact in f32 whatever the summation order -> real ties
        q = rng.integers(-3, 4, size=(Q, d)).astype(np.float32)
        it = rng.integers(-3, 4, size=(I, d)).astype(np.float32)
    else:
        q = rng.normal(size=(Q, d)).astype(np.float32)
        it = rng.normal(size=(I, d)).astype(np.float32)
    ex = np.full((Q, E), -1, np.int32)  # the last two slots stay empty
    ex[:, : max(E - 2, 0)] = rng.integers(0, I, size=(Q, max(E - 2, 0)))
    return q, it, ex


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def jx():
    """``repro``'s kernels and retrieval, the reference (needs JAX on the CPU;
    on a GPU backend XLA's default f32 matmul precision reorders scores)."""
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("repro is the reference on the CPU; run with JAX_PLATFORMS=cpu")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.retrieval import brute_force_topk, chunked_topk as j_chunked_topk

    return types.SimpleNamespace(jnp=jnp, ops=jops, ref=jref, brute=brute_force_topk,
                                 chunked=j_chunked_topk)


# ------------------------------------------------------------------ seg_aggr
class TestSegAggrRef:
    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("shape", [(13, 4, 24), (8, 3, 300), (1, 1, 5), (37, 6, 130)])
    def test_matches_repro_oracle_and_pallas(self, jx, mode, shape):
        x, mask = _seg_data(0, *shape)
        got = ops.seg_aggr(_t(x), _t(mask), mode).numpy()
        jxx, jm = jx.jnp.asarray(x), jx.jnp.asarray(mask)
        want = np.asarray(jx.ref.seg_aggr_ref(jxx, jm, mode))
        pallas = np.asarray(jx.ops.seg_aggr(jxx, jm, mode=mode))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)

    def test_all_masked_rows_are_zero(self):
        x, _ = _seg_data(1, 8, 4, 32)
        mask = np.zeros((8, 4), bool)
        for mode in MODES:
            assert not ops.seg_aggr(_t(x), _t(mask), mode).any()

    def test_strided_ego_view_matches_contiguous(self):
        # child[:, :, r] of the (B, W, R, F, d) ego layout: a row-strided view
        rng = np.random.default_rng(2)
        full = _t(rng.normal(size=(3, 4, 2, 3, 8)).astype(np.float32))
        m = _t(rng.random((3, 4, 2, 3)) < 0.5)
        x, mk = full[:, :, 1].reshape(12, 3, 8), m[:, :, 1].reshape(12, 3)
        assert not x.is_contiguous()
        for mode in MODES:
            torch.testing.assert_close(ops.seg_aggr(x, mk, mode),
                                       ops.seg_aggr(x.contiguous(), mk.contiguous(), mode))

    def test_unknown_mode_raises(self):
        x, mask = _seg_data(3, 4, 2, 3)
        with pytest.raises(ValueError):
            ops.seg_aggr(_t(x), _t(mask), "median")

    def test_cuda_wrapper_refuses_cpu_tensors(self):
        # no silent fallback: the kernel wrapper never runs the plain version
        x, mask = _seg_data(4, 4, 2, 3)
        with pytest.raises(ValueError, match="CUDA"):
            seg_aggr_cuda(_t(x), _t(mask), "mean")


# ---------------------------------------------------------------------- topk
class TestTopkRef:
    @pytest.mark.parametrize("chunk", [7, 32, 100, 501, 4096])
    def test_matches_repro_across_chunk_boundaries(self, jx, chunk):
        q, it, ex = _topk_data()
        s0, i0 = jx.brute(q, it, 25, exclude=ex)
        s1, i1 = ref.chunked_topk_ref(_t(q), _t(it), 25, _t(ex), item_chunk=chunk)
        s2, i2 = jx.chunked(q, it, 25, exclude=ex, item_chunk=max(chunk, 25))
        np.testing.assert_array_equal(i1.numpy(), i0)
        np.testing.assert_array_equal(i1.numpy(), i2)
        np.testing.assert_allclose(s1.numpy(), s0, rtol=RTOL, atol=ATOL)

    def test_matches_repro_pallas(self, jx):
        q, it, ex = _topk_data(Q=40, I=700)
        s0, i0 = jx.chunked(q, it, 33, exclude=ex, item_chunk=128, backend="pallas")
        s1, i1 = ref.chunked_topk_ref(_t(q), _t(it), 33, _t(ex), item_chunk=128)
        np.testing.assert_array_equal(i1.numpy(), i0)
        np.testing.assert_allclose(s1.numpy(), s0, rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("chunk", [16, 64, 300])
    def test_tie_break_lower_id_wins(self, jx, chunk):
        q, it, _ = _topk_data(int_valued=True, d=6, I=300)
        s0, i0 = jx.brute(q, it, 40)
        s1, i1 = ref.chunked_topk_ref(_t(q), _t(it), 40, item_chunk=chunk)
        np.testing.assert_array_equal(i1.numpy(), i0)
        np.testing.assert_array_equal(s1.numpy(), s0)  # int-valued: exact

    def test_k_equals_num_items(self, jx):
        q, it, ex = _topk_data(I=50)
        s0, i0 = jx.brute(q, it, 50, exclude=ex)
        s1, i1 = ref.chunked_topk_ref(_t(q), _t(it), 50, _t(ex), item_chunk=16)
        np.testing.assert_array_equal(i1.numpy(), i0)
        np.testing.assert_allclose(s1.numpy(), s0, rtol=RTOL, atol=ATOL)

    def test_filler_when_k_exceeds_survivors(self, jx):
        q, it, _ = _topk_data(Q=5, I=8)
        ex = np.tile(np.arange(6, dtype=np.int32), (5, 1))  # 2 survivors
        s0, i0 = jx.brute(q, it, 5, exclude=ex)
        s1, i1 = ref.chunked_topk_ref(_t(q), _t(it), 5, _t(ex), item_chunk=3)
        np.testing.assert_array_equal(i1.numpy(), i0)
        assert (i1[:, 2:] == -1).all() and torch.isneginf(s1[:, 2:]).all()
        np.testing.assert_allclose(s1[:, :2].numpy(), s0[:, :2], rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("k", [0, 9])
    def test_bad_k_raises(self, k):
        q, it, _ = _topk_data(I=8)
        with pytest.raises(ValueError):
            ref.chunked_topk_ref(_t(q), _t(it), k)

    def test_retrieval_wrapper_matches_repro(self, jx):
        q, it, ex = _topk_data(Q=53)
        s0, i0 = jx.brute(q, it, 7, exclude=ex)
        for qc in (0, 16):
            s1, i1 = chunked_topk(q, it, 7, exclude=ex, query_chunk=qc, device="cpu")
            np.testing.assert_array_equal(i1, i0)
            np.testing.assert_allclose(s1, s0, rtol=RTOL, atol=ATOL)


class TestTopkWrapper:
    @pytest.mark.parametrize("Q,I,sms", [(1024, 20000, 132), (1024, 10**6, 132),
                                         (7, 300, 132), (100000, 5000, 132), (64, 65536, 8)])
    def test_split_plan_covers_items(self, Q, I, sms):
        splits, split_len = plan_splits(Q, I, sms)
        assert 1 <= splits <= MAX_SPLITS and split_len % CHUNK == 0
        assert (splits - 1) * split_len < I <= splits * split_len

    def test_k_above_kernel_limit_raises_value_error(self):
        q, it, _ = _topk_data(I=MAX_K + 10)
        with pytest.raises(ValueError, match="limit"):
            streaming_topk_cuda(_t(q), _t(it), MAX_K + 1)

    def test_cuda_wrapper_refuses_cpu_tensors(self):
        q, it, _ = _topk_data()
        with pytest.raises(ValueError, match="CUDA"):
            streaming_topk_cuda(_t(q), _t(it), 5)


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _ids_match_up_to_near_ties(s_ref, i_ref, s_got, i_got, tol=1e-5):
    """Ids equal except where the reference has a near-tie within ``tol``."""
    s_ref, s_got = s_ref.cpu().numpy(), s_got.cpu().numpy()
    i_ref, i_got = i_ref.cpu().numpy(), i_got.cpu().numpy()
    np.testing.assert_allclose(s_got, s_ref, rtol=tol, atol=tol)
    for r, c in zip(*np.nonzero(i_ref != i_got)):
        near = np.abs(s_ref[r] - s_ref[r, c]) <= tol * max(1.0, abs(s_ref[r, c]))
        assert near.sum() > 1, (r, c, s_ref[r, c])


@pytest.mark.cuda
class TestOnCard:
    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("shape", [(8192, 3, 64), (1024, 4, 64), (37, 6, 130), (1, 1, 5)])
    def test_seg_aggr_matches_plain(self, cuda, mode, shape):
        x, mask = _seg_data(5, *shape)
        x, mask = _t(x).to(cuda), _t(mask).to(cuda)
        got = seg_aggr_cuda(x, mask, mode)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref.seg_aggr_ref(x, mask, mode), rtol=RTOL, atol=ATOL)

    def test_seg_aggr_reads_strided_view(self, cuda):
        full = torch.randn(64, 8, 2, 3, 16, device=cuda)
        m = torch.rand(64, 8, 2, 3, device=cuda) < 0.6
        x, mk = full[:, :, 1].reshape(512, 3, 16), m[:, :, 1].reshape(512, 3)
        for mode in MODES:
            torch.testing.assert_close(seg_aggr_cuda(x, mk, mode),
                                       ref.seg_aggr_ref(x, mk, mode), rtol=RTOL, atol=ATOL)

    def test_seg_aggr_refuses_non_dense_inner_axes(self, cuda):
        x = torch.randn(4, 8, 3, device=cuda).transpose(1, 2)
        with pytest.raises(ValueError, match="stride"):
            seg_aggr_cuda(x, torch.ones(4, 3, dtype=torch.bool, device=cuda))

    @pytest.mark.parametrize("Q,I,d,k,E", [
        (29, 501, 16, 25, 6), (1024, 20000, 64, 100, 12), (33, 70000, 20, 21, 3),
        (64, 300, 16, MAX_K, 6), (5, 40, 8, 40, 4), (300, 9000, 64, 1, 1),
    ])
    def test_topk_matches_plain(self, cuda, Q, I, d, k, E):
        q, it, ex = (_t(a).to(cuda) for a in _topk_data(7, Q, I, d, E))
        s, i = streaming_topk_cuda(q, it, k, ex)
        torch.cuda.synchronize()
        s0, i0 = ref.chunked_topk_ref(q, it, k, ex)
        _ids_match_up_to_near_ties(s0, i0, s, i)

    @pytest.mark.parametrize("Q,I", [(128, 65536), (40, 300)])
    def test_topk_int_ties_exact(self, cuda, Q, I):
        q, it, ex = (_t(a).to(cuda) for a in _topk_data(8, Q, I, 16, int_valued=True))
        s, i = streaming_topk_cuda(q, it, 100, ex)
        s0, i0 = ref.chunked_topk_ref(q, it, 100, ex)
        assert torch.equal(i, i0) and torch.equal(s, s0)

    def test_topk_filler_when_k_exceeds_survivors(self, cuda):
        q, it, _ = (_t(a).to(cuda) for a in _topk_data(9, 5, 8))
        ex = torch.arange(6, dtype=torch.int32, device=cuda).repeat(5, 1)
        s, i = streaming_topk_cuda(q, it, 5, ex)
        s0, i0 = ref.chunked_topk_ref(q, it, 5, ex)
        assert torch.equal(i, i0) and (i[:, 2:] == -1).all()
        assert torch.isneginf(s[:, 2:]).all()
