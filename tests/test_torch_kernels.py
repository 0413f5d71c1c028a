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
from repro_torch.kernels.seg_aggr import seg_aggr_bwd_cuda, seg_aggr_cuda
from repro_torch.kernels.topk import (CHUNK, EXCLUDE_CAP, MAX_CLUSTER, MAX_K, TILE_Q, plan_splits,
                                      streaming_topk_cuda, streaming_topk_planned)
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


def _max_bwd_data(seed, N, F, D, ties=False):
    """x (N, F, D), mask (N, F) and g (N, D) for the max backward. With
    ``ties`` x takes 4 integer values, so 2- to F-way ties are common.
    Planted at F >= 2 (N >= 8): every fifth row all-masked, a valid -1e30
    beside masked slots (row 1), a valid -inf beside them (row 2), a row of
    valid -infs (row 3), and two valid -1e30s beside masked slots (row 4)."""
    rng = np.random.default_rng(seed)
    if ties:
        x = rng.integers(-2, 2, size=(N, F, D)).astype(np.float32)
    else:
        x = rng.normal(size=(N, F, D)).astype(np.float32)
    mask = rng.random((N, F)) < 0.7
    g = rng.normal(size=(N, D)).astype(np.float32)
    if F >= 2 and N >= 8:
        mask[::5] = False
        mask[1:3], mask[3:5] = False, True
        mask[1:3, 0] = True
        mask[4, 2:] = False
        x[1, 0], x[2, 0], x[3], x[4, :2] = -1e30, -np.inf, -np.inf, -1e30
        g[0] = 0.0  # a zero gradient row
    return x, mask, g


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


class TestSegAggrMaxBackward:
    """The ``max`` backward against ``jax.vjp`` of ``repro``'s oracle, bitwise
    (signed zeros included): the same rule in the same order, one IEEE
    division a column."""

    CASES = [(13, 4, 24, False), (37, 3, 64, True), (40, 4, 8, True), (8, 1, 5, False),
             (64, 6, 130, True), (9, 2, 3, False)]

    @staticmethod
    def _jax_vjp(jx, x, mask, g):
        import jax

        _, vjp = jax.vjp(lambda v: jx.ref.seg_aggr_ref(v, jx.jnp.asarray(mask), "max"),
                         jx.jnp.asarray(x))
        return np.asarray(vjp(jx.jnp.asarray(g))[0])

    @staticmethod
    def _bitwise(got, want):
        assert got.shape == want.shape and got.dtype == want.dtype == np.float32
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))

    @pytest.mark.parametrize("N,F,D,ties", CASES)
    def test_plain_version_matches_jax_vjp(self, jx, N, F, D, ties):
        x, mask, g = _max_bwd_data(N * F + D, N, F, D, ties)
        got = ref.seg_aggr_bwd_ref(_t(g), _t(mask), "max", x=_t(x)).numpy()
        self._bitwise(got, self._jax_vjp(jx, x, mask, g))

    @pytest.mark.parametrize("N,F,D,ties", CASES)
    def test_autograd_matches_jax_vjp(self, jx, N, F, D, ties):
        x, mask, g = _max_bwd_data(N * F + D, N, F, D, ties)
        tx = _t(x).requires_grad_(True)
        ops.seg_aggr(tx, _t(mask), "max").backward(_t(g))
        self._bitwise(tx.grad.numpy(), self._jax_vjp(jx, x, mask, g))

    def test_planted_rows(self):
        """The quirks of JAX's rule: a valid -1e30 beside masked slots shares
        its gradient with them (g / F), a valid -inf beside them gets none,
        a row of valid -infs splits g over F, an all-masked row gets 0."""
        x, mask, g = _max_bwd_data(7, 10, 3, 4)
        dx = ref.seg_aggr_bwd_ref(_t(g), _t(mask), "max", x=_t(x)).numpy()
        third = g / np.float32(3)
        np.testing.assert_array_equal(dx[1, 0], third[1])
        assert not dx[1, 1:].any() and not dx[2].any() and not dx[5].any()
        np.testing.assert_array_equal(dx[3], np.broadcast_to(third[3], (3, 4)))
        np.testing.assert_array_equal(dx[4, :2], np.broadcast_to(third[4], (2, 4)))
        assert not dx[4, 2].any()

    def test_strided_ego_view_gradient_lands_in_the_base(self, jx):
        rng = np.random.default_rng(11)
        full = rng.integers(-2, 2, size=(24, 2, 3, 8)).astype(np.float32)
        m = rng.random((24, 2, 3)) < 0.6
        g = rng.normal(size=(24, 8)).astype(np.float32)
        base = _t(full).requires_grad_(True)
        ops.seg_aggr(base[:, 1], _t(m)[:, 1], "max").backward(_t(g))
        want = self._jax_vjp(jx, full[:, 1], m[:, 1], g)
        self._bitwise(base.grad[:, 1].numpy(), want)
        assert not base.grad[:, 0].any()

    def test_needs_the_forward_input(self):
        x, mask, g = _max_bwd_data(3, 8, 3, 4)
        with pytest.raises(ValueError, match="x"):
            ref.seg_aggr_bwd_ref(_t(g), _t(mask), "max")
        with pytest.raises(ValueError, match="x"):
            seg_aggr_bwd_cuda(_t(g), _t(mask), "max")
        with pytest.raises(ValueError, match="x"):
            seg_aggr_bwd_cuda(_t(g), _t(mask), "sum", x=_t(x))

    def test_cuda_wrapper_refuses_cpu_tensors(self):
        x, mask, g = _max_bwd_data(4, 8, 3, 4)
        with pytest.raises(ValueError, match="CUDA"):
            seg_aggr_bwd_cuda(_t(g), _t(mask), "max", x=_t(x))


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


def _resident(sms, per_sm):
    """Clusters of 1..8 blocks an idealised card holds at once, two short of
    the slots, as clusters lose some to the GPCs' edges."""
    return [max(1, sms * per_sm // s - 2) for s in range(1, MAX_CLUSTER + 1)]


class TestTopkWrapper:
    @pytest.mark.parametrize("Q,I,sms", [(1024, 20000, 132), (1024, 10**6, 132),
                                         (7, 300, 132), (100000, 5000, 132), (64, 65536, 8)])
    def test_split_plan_covers_items_in_one_cluster(self, Q, I, sms):
        """Whole chunks, no empty split, every item, one cluster (<= 8) per
        query tile, for any number of resident blocks an SM."""
        for per_sm in (1, 2, 3, 4, 8):
            splits, split_len = plan_splits(Q, I, sms, _resident(sms, per_sm))
            assert 1 <= splits <= MAX_CLUSTER and split_len % CHUNK == 0
            assert (splits - 1) * split_len < I <= splits * split_len

    @pytest.mark.parametrize("Q,I", [(512, 20000), (512, 8000), (512, 10**6), (1024, 20000)],
                             ids=["u2i-icf", "ucf", "1m-arm", "synthetic"])
    @pytest.mark.parametrize("per_sm", [2, 3, 4])
    def test_split_plan_fills_the_card(self, Q, I, per_sm):
        """The main-path shapes give every one of the H100's 132 SMs two
        blocks or more, in clusters of at most 8."""
        resident = _resident(132, per_sm)
        splits, _ = plan_splits(Q, I, 132, resident)
        assert splits <= MAX_CLUSTER
        assert -(-Q // TILE_Q) * splits >= 2 * 132

    def test_split_plan_keeps_one_wave(self):
        """Eight splits of 64 query tiles need 64 resident 8-block clusters;
        an H100 at four blocks an SM holds 62 (cudaOccupancyMaxActiveClusters),
        so the U2I call takes seven splits, all in one wave."""
        resident = [132, 132, 132, 132, 104, 88, 74, 62]
        assert plan_splits(512, 20000, 132, resident) == (7, 2944)

    def test_planned_launch_checks_its_plan(self):
        """A plan that does not cover the items in whole chunks, or takes
        more than a cluster, raises before the device is looked at."""
        q, it, _ = _topk_data(I=300)
        for splits, split_len in ((0, 384), (MAX_CLUSTER + 1, 128), (2, 100), (2, 128)):
            with pytest.raises(ValueError, match="plan"):
                streaming_topk_planned(_t(q), _t(it), 5, None, splits, split_len)
        with pytest.raises(ValueError, match="CUDA"):  # a good plan reaches the device check
            streaming_topk_planned(_t(q), _t(it), 5, None, 3, 128)

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


def _seg_in_order(x, mask, mode):
    """The forward with its sum over F added in order, j = 0 .. F-1, from 0,
    as the kernel adds it (``max`` as the plain version)."""
    if mode == "max":
        return ref.seg_aggr_ref(x, mask, mode)
    m = mask[..., None].to(x.dtype)
    xm = x * m
    s = xm.new_zeros((xm.shape[0], xm.shape[2]))
    for j in range(xm.shape[1]):
        s = s + xm[:, j]
    return s if mode == "sum" else s / torch.clamp(m.sum(dim=1), min=1.0)


def _check_seg(got, x, mask, mode):
    """The kernel's forward: bitwise the in-order sum; bitwise its plain
    version where PyTorch's sum over F adds in that order on the card (F <=
    4 with D > 1, every main-path shape), else within RTOL / ATOL of it
    (PyTorch keeps four partial sums past F 4 and reduces across threads at
    D 1)."""
    want = ref.seg_aggr_ref(x, mask, mode)
    assert torch.equal(got, _seg_in_order(x, mask, mode))
    if mode == "max" or (x.shape[1] <= 4 and x.shape[2] > 1):
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
class TestOnCard:
    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("shape", [(8192, 3, 64), (1024, 4, 64), (37, 6, 130), (1, 1, 5),
                                       (200_003, 3, 64)])  # rows past one wave of the grid
    def test_seg_aggr_matches_plain(self, cuda, mode, shape):
        x, mask = _seg_data(5, *shape)
        x, mask = _t(x).to(cuda), _t(mask).to(cuda)
        got = seg_aggr_cuda(x, mask, mode)
        torch.cuda.synchronize()
        _check_seg(got, x, mask, mode)

    @pytest.mark.parametrize("F", range(1, 9))
    @pytest.mark.parametrize("D", [1, 3, 64, 130])
    def test_seg_aggr_bitwise_over_widths(self, cuda, F, D):
        # N 37 is no multiple of a block's rows; every fifth row all-masked
        x, mask = (_t(a).to(cuda) for a in _seg_data(F * 1000 + D, 37, F, D))
        for mode in MODES:
            _check_seg(seg_aggr_cuda(x, mask, mode), x, mask, mode)

    def test_seg_aggr_max_all_masked_rows_are_zero(self, cuda):
        x = torch.randn(64, 4, 64, device=cuda) - 5.0
        mask = torch.rand(64, 4, device=cuda) < 0.5
        mask[::3] = False
        got = seg_aggr_cuda(x, mask, "max")
        assert torch.equal(got, ref.seg_aggr_ref(x, mask, "max"))
        assert not got[::3].any()

    def test_seg_aggr_reads_strided_view(self, cuda):
        full = torch.randn(64, 8, 2, 3, 16, device=cuda)
        m = torch.rand(64, 8, 2, 3, device=cuda) < 0.6
        x, mk = full[:, :, 1].reshape(512, 3, 16), m[:, :, 1].reshape(512, 3)
        assert not x.is_contiguous()
        for mode in MODES:
            _check_seg(seg_aggr_cuda(x, mk, mode), x, mk, mode)

    @pytest.mark.parametrize("where", ["base", "stride"])
    def test_seg_aggr_misaligned_rows_take_4_byte_loads(self, cuda, where):
        # a base 4 bytes past 16-byte alignment, or a row stride of 4k + 1
        # floats: the 4-byte path, bitwise as the 16-byte one
        if where == "base":
            buf = torch.randn(300 * 3 * 64 + 1, device=cuda)
            x = buf[1:].view(300, 3, 64)
        else:
            x = torch.randn(300, 3 * 64 + 1, device=cuda)[:, : 3 * 64].view(300, 3, 64)
        assert x.data_ptr() % 16 or x.stride(0) % 4
        mask = torch.rand(300, 3, device=cuda) < 0.6
        for mode in MODES:
            _check_seg(seg_aggr_cuda(x, mask, mode), x, mask, mode)

    @pytest.mark.parametrize("N,F,D,ties", [(8192, 3, 64, True), (1024, 4, 64, True),
                                            (37, 6, 130, True), (40, 2, 3, False),
                                            (1, 1, 5, False), (200_003, 3, 64, True)])
    def test_seg_aggr_max_bwd_bitwise_plain(self, cuda, N, F, D, ties):
        x, mask, g = (_t(a).to(cuda) for a in _max_bwd_data(N + F + D, N, F, D, ties))
        got = seg_aggr_bwd_cuda(g, mask, "max", x=x)
        want = ref.seg_aggr_bwd_ref(g, mask, "max", x=x)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert torch.equal(seg_aggr_bwd_cuda(g, mask, "max", x=x), got)  # re-run

    @pytest.mark.parametrize("where", ["base", "stride", "view"])
    def test_seg_aggr_max_bwd_strided_and_misaligned_x(self, cuda, where):
        # x 4 bytes past 16-byte alignment, a row stride of 4k + 1 floats
        # (the 4-byte path), or the per-relation view of the ego layout
        x0, mask, g = (_t(a).to(cuda) for a in _max_bwd_data(3, 300, 3, 64, True))
        if where == "base":
            x = torch.empty(300 * 3 * 64 + 1, device=cuda)[1:].view(300, 3, 64)
        elif where == "stride":
            x = torch.empty(300, 3 * 64 + 1, device=cuda)[:, : 3 * 64].view(300, 3, 64)
        else:
            x = torch.empty(300, 2, 3, 64, device=cuda)[:, 1]
        x.copy_(x0)
        got = seg_aggr_bwd_cuda(g, mask, "max", x=x)
        want = ref.seg_aggr_bwd_ref(g, mask, "max", x=x0)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))

    def test_seg_aggr_max_bwd_through_autograd(self, cuda):
        from repro_torch.kernels import seg_aggr as seg_mod

        x, mask, g = (_t(a).to(cuda) for a in _max_bwd_data(9, 4096, 3, 64, True))
        x.requires_grad_(True)
        before = seg_mod.bwd_launches
        ops.seg_aggr(x, mask, "max").backward(g)
        assert seg_mod.bwd_launches == before + 1
        want = ref.seg_aggr_bwd_ref(g, mask, "max", x=x.detach())
        assert torch.equal(x.grad.view(torch.int32), want.view(torch.int32))

    def test_seg_aggr_refuses_non_dense_inner_axes(self, cuda):
        x = torch.randn(4, 8, 3, device=cuda).transpose(1, 2)
        with pytest.raises(ValueError, match="stride"):
            seg_aggr_cuda(x, torch.ones(4, 3, dtype=torch.bool, device=cuda))

    @pytest.mark.parametrize("Q,I,d,k,E", [
        (29, 501, 16, 25, 6), (1024, 20000, 64, 100, 12), (33, 70000, 20, 21, 3),
        (64, 300, 16, MAX_K, 6), (5, 40, 8, 40, 4), (300, 9000, 64, 1, 1),
        (13, 5000, 64, 100, 19),  # Q not a multiple of the query tile
        (16, 100, 64, 50, 3),  # I smaller than one chunk
        (512, 20000, 64, MAX_K, 19), (512, 20000, 64, 1, 19),  # k 256 and k 1, U2I's size
        (40, 3000, 37, 10, 4), (24, 2000, 70, 30, 5), (9, 700, 6, 7, 2),  # 4-byte copies, d tails
        (64, 4000, 32, 40, EXCLUDE_CAP + 1), (37, 9000, 64, 100, 150),  # rows past the shared cap
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

    @pytest.mark.parametrize("k", [20, 100])
    def test_topk_on_unit_vectors(self, cuda, k):
        """Unit-norm embeddings, as recall normalises them: scores in [-1, 1]."""
        q, it, ex = _topk_data(16, 512, 20000, 64, 19)
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
        it = it / np.linalg.norm(it, axis=1, keepdims=True)
        q, it, ex = (_t(a).to(cuda) for a in (q, it, ex))
        s, i = streaming_topk_cuda(q, it, k, ex)
        s0, i0 = ref.chunked_topk_ref(q, it, k, ex)
        _ids_match_up_to_near_ties(s0, i0, s, i)

    def test_topk_reads_misaligned_rows(self, cuda):
        """A contiguous view whose rows do not start on 16 bytes takes the
        4-byte copies."""
        q, it, ex = _topk_data(11, 20, 3000, 8, 4)
        base = torch.zeros(it.size + 1, dtype=torch.float32, device=cuda)
        items = base[1:].view(it.shape)
        items.copy_(_t(it))
        q, ex = _t(q).to(cuda), _t(ex).to(cuda)
        s, i = streaming_topk_cuda(q, items, 30, ex)
        s0, i0 = ref.chunked_topk_ref(q, items, 30, ex)
        _ids_match_up_to_near_ties(s0, i0, s, i)

    @pytest.mark.parametrize("E", [3, EXCLUDE_CAP, EXCLUDE_CAP + 1, 200])
    def test_topk_exclusions_beyond_the_shared_cap_agree(self, cuda, E):
        """Rows read from device memory give what staged rows give: every
        excluded id is absent, and the result equals the plain version's on
        integer-valued data (exact scores and ties)."""
        q, it, ex = (_t(a).to(cuda) for a in _topk_data(12, 50, 6000, 16, E, int_valued=True))
        s, i = streaming_topk_cuda(q, it, 100, ex)
        s0, i0 = ref.chunked_topk_ref(q, it, 100, ex)
        assert torch.equal(i, i0) and torch.equal(s, s0)
        hit = (i[:, :, None] == ex[:, None, :]) & (ex[:, None, :] >= 0)
        assert not hit.any()

    @pytest.mark.parametrize("splits,split_len,I", [
        (8, 128, 300),  # 3 splits with items, 5 with filler lists
        (3, 128, 384),  # a cluster of 3
        (8, 128, 1024),  # every split shorter than k: each list ends in fillers
        (1, 20096, 20000),  # one block per query tile, no cluster merge
    ])
    def test_topk_planned_splits_match_plain(self, cuda, splits, split_len, I):
        q, it, ex = (_t(a).to(cuda) for a in _topk_data(13, 21, I, 64, 9))
        k = min(200, I)
        s, i = streaming_topk_planned(q, it, k, ex, splits, split_len)
        s0, i0 = ref.chunked_topk_ref(q, it, k, ex)
        _ids_match_up_to_near_ties(s0, i0, s, i)
        assert torch.equal(i < 0, i0 < 0)

    def test_topk_bitwise_rerun(self, cuda):
        q, it, ex = (_t(a).to(cuda) for a in _topk_data(14, 512, 20000, 64, 19))
        s1, i1 = streaming_topk_cuda(q, it, 100, ex)
        s2, i2 = streaming_topk_cuda(q, it, 100, ex)
        assert torch.equal(s1, s2) and torch.equal(i1, i2)

    def test_topk_launches_once_per_call(self, cuda):
        from repro_torch.kernels import topk as topk_mod
        q, it, ex = (_t(a).to(cuda) for a in _topk_data(15, 512, 20000, 64, 19))
        before = topk_mod.launches
        streaming_topk_cuda(q, it, 100, ex)
        assert topk_mod.launches == before + 1
