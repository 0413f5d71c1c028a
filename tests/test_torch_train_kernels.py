"""The training kernels of the port against ``repro``'s: ``seg_aggr``'s
backward, ``inbatch_loss`` and ``row_adagrad``.

On the CPU the port's autograd Functions and plain versions are held against
``repro``'s jnp oracles, ``jax.grad`` of its plain functions and its Pallas
kernels in interpret mode, on inputs made with numpy from a fixed seed.
Tolerances: f32 values to rtol 1e-5 / atol 1e-6 (XLA and torch sum in other
orders); the row-wise AdaGrad rows the batch does not touch exactly.

The ``seg_aggr`` gradient fault: on a card ``kernels.ops.seg_aggr`` used to
return the kernel's output with no ``grad_fn``, so a backward through the
encoder dropped the neighbour gradient. ``TestOnCard`` shows the repair
there; the CPU route always had autograd, so on the CPU the tests check that
the same Function (its plain forward and backward) carries the gradient.
``TestOnCard`` runs only where there is a CUDA card:
    python -m pytest -q -m cuda tests/test_torch_train_kernels.py
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.core import gnn
from repro_torch.kernels import ops, ref, row_adagrad, seg_aggr
from repro_torch.kernels.inbatch_loss import (COL_TILE, MAX_CLUSTER, ROW_TILE,
                                              inbatch_loss_rows_cuda, plan_columns)
from repro_torch.kernels.row_adagrad import row_adagrad_scatter_cuda
from repro_torch.kernels.seg_aggr import seg_aggr_bwd_cuda

pytestmark = pytest.mark.quick

RTOL, ATOL = 1e-5, 1e-6
# the training paths' recorded seg_aggr backward calls (N, F, D): host
# training's two hops, then the fused path's
RECORDED_BWD_SHAPES = [(4096, 3, 64), (512, 4, 64), (2736, 3, 64), (342, 4, 64)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nbr_data(seed, B=5, W=4, F=3, d=8):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, W, F, d)).astype(np.float32)
    mask = rng.random((B, W, F)) < 0.6
    mask[0] = False  # rows with no valid neighbour
    mask[-1, :, 0] = True
    cot = rng.normal(size=(B, W, d)).astype(np.float32)
    return h, mask, cot


def _bwd_data(N, F, D, seed=None):
    """(N, F, D) inputs, an (N, F) mask with all-masked and all-valid rows,
    and an (N, D) output gradient with zero rows and negative zeros, as the
    training paths' gradients carry (the kernel's mean skips the division
    for zeros)."""
    rng = np.random.default_rng(N * 31 + F * 7 + D if seed is None else seed)
    x = rng.normal(size=(N, F, D)).astype(np.float32)
    mask = rng.random((N, F)) < 0.6
    mask[::7] = False
    mask[3::11] = True
    cot = rng.normal(size=(N, D)).astype(np.float32)
    cot[1::5] = 0.0
    cot[2::13, : (D + 1) // 2] = -0.0
    return x, mask, cot


def _pair_data(seed, P, d=16, scale=0.5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(P, d)).astype(np.float32) * scale,
            rng.normal(size=(P, d)).astype(np.float32) * scale)


def _adagrad_data(seed, N=40, D=8, n_real=20, n_pad=12, with_row0=True):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(N, D)).astype(np.float32)
    accum = np.full((N, 1), 0.1, np.float32) + rng.random((N, 1)).astype(np.float32)
    real = np.sort(rng.choice(np.arange(1, N), size=n_real, replace=False))
    if with_row0:
        real[0] = 0  # row 0 a real id: the row Pallas clamps PADs onto
    ids = np.concatenate([np.full(n_pad, -1), np.sort(real)]).astype(np.int64)
    grads = rng.normal(size=(len(ids), D)).astype(np.float32)
    grads[:n_pad] = 0.0  # PAD slots carry zero grads by construction
    return table, accum, ids, grads


@pytest.fixture(scope="module")
def jx():
    """``repro``'s kernels, oracles and plain functions (JAX on the CPU)."""
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("repro is the reference on the CPU; run with JAX_PLATFORMS=cpu")
    import jax.numpy as jnp
    from repro.core import gnn as jgnn
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    return types.SimpleNamespace(jax=jax, jnp=jnp, gnn=jgnn, ops=jops, ref=jref)


# ------------------------------------------------------- seg_aggr backward
class TestSegAggrBackward:
    @pytest.mark.parametrize("mode", ["mean", "sum"])
    @pytest.mark.parametrize("shape", [(5, 4, 3, 8), (2, 3, 4, 16), (2, 1, 1, 5)])
    def test_grad_matches_jax_grad(self, jx, mode, shape):
        h, mask, cot = _nbr_data(0, *shape)
        jfn = jx.gnn.masked_mean if mode == "mean" else jx.gnn.masked_sum
        want = np.asarray(jx.jax.grad(
            lambda x: (jfn(x, jx.jnp.asarray(mask)) * cot).sum())(jx.jnp.asarray(h)))
        tfn = gnn.masked_mean if mode == "mean" else gnn.masked_sum
        x = _t(h).requires_grad_(True)
        out = tfn(x, _t(mask))
        (out * _t(cot)).sum().backward()
        np.testing.assert_allclose(x.grad.numpy(), want, rtol=RTOL, atol=ATOL)
        assert not x.grad[0].any()  # no valid neighbour: no gradient

    def test_grad_through_strided_ego_view(self, jx):
        # child[:, :, r] of the (B, W, R, F, d) ego layout, as hetero_forward
        # hands it over: the dense gradient lands in the view's base
        rng = np.random.default_rng(1)
        full = rng.normal(size=(3, 4, 2, 3, 8)).astype(np.float32)
        m = rng.random((3, 4, 2, 3)) < 0.5
        cot = rng.normal(size=(3, 4, 8)).astype(np.float32)
        base = _t(full).requires_grad_(True)
        out = gnn.masked_mean(base[:, :, 1], _t(m)[:, :, 1])
        (out * _t(cot)).sum().backward()
        want = np.asarray(jx.jax.grad(lambda b: (jx.gnn.masked_mean(
            b[:, :, 1], jx.jnp.asarray(m)[:, :, 1]) * cot).sum())(jx.jnp.asarray(full)))
        np.testing.assert_allclose(base.grad.numpy(), want, rtol=RTOL, atol=ATOL)
        assert not base.grad[:, :, 0].any()

    @pytest.mark.parametrize("mode", ["mean", "sum"])
    def test_cpu_route_is_the_function_with_its_plain_backward(self, mode):
        # the fault's CPU side: the very Function the card runs, with its
        # plain forward and backward, carries the gradient
        h, mask, cot = _nbr_data(2)
        x = _t(h.reshape(-1, 3, 8)).requires_grad_(True)
        mk = _t(mask.reshape(-1, 3))
        out = ops.seg_aggr(x, mk, mode)
        assert out.grad_fn is not None and "_SegAggr" in type(out.grad_fn).__name__
        g = _t(cot.reshape(-1, 8))
        (out * g).sum().backward()
        torch.testing.assert_close(x.grad, ref.seg_aggr_bwd_ref(g, mk, mode))
        x2 = x.detach().clone().requires_grad_(True)
        (ref.seg_aggr_ref(x2, mk, mode) * g).sum().backward()
        torch.testing.assert_close(x.grad, x2.grad, rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("mode", ["mean", "sum"])
    @pytest.mark.parametrize("N,F,D", RECORDED_BWD_SHAPES)
    def test_plain_and_cpu_route_match_jax_grad_at_recorded_shapes(self, jx, mode, N, F, D):
        """The training paths' recorded backward shapes: the plain version
        and the ``_SegAggr`` CPU route against ``jax.grad`` of ``repro``'s
        masked aggregation."""
        x, mask, cot = _bwd_data(N, F, D)
        want = self._jax_grad(jx, mode, x, mask, cot)
        g, mk = _t(cot), _t(mask)
        np.testing.assert_allclose(ref.seg_aggr_bwd_ref(g, mk, mode).numpy(), want,
                                   rtol=RTOL, atol=ATOL)
        tx = _t(x).requires_grad_(True)
        (ops.seg_aggr(tx, mk, mode) * g).sum().backward()
        np.testing.assert_allclose(tx.grad.numpy(), want, rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("mode", ["mean", "sum"])
    def test_strided_relation_mask_at_a_recorded_shape(self, jx, mode):
        """[2736, 3, 64] read as relation 1 of a (N, R 2, F, D) ego block:
        the mask is a row-strided view, and the gradient lands in the base."""
        rng = np.random.default_rng(5)
        full = rng.normal(size=(2736, 2, 3, 64)).astype(np.float32)
        m = rng.random((2736, 2, 3)) < 0.6
        m[::9, 1] = False
        cot = rng.normal(size=(2736, 64)).astype(np.float32)
        base, mk = _t(full).requires_grad_(True), _t(m)
        assert mk[:, 1].stride() == (6, 1)
        (ops.seg_aggr(base[:, 1], mk[:, 1], mode) * _t(cot)).sum().backward()
        jfn = jx.gnn.masked_mean if mode == "mean" else jx.gnn.masked_sum
        want = np.asarray(jx.jax.grad(lambda b: (jfn(b[:, 1], jx.jnp.asarray(m)[:, 1])
                                                 * cot).sum())(jx.jnp.asarray(full)))
        np.testing.assert_allclose(base.grad.numpy(), want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(ref.seg_aggr_bwd_ref(_t(cot), mk[:, 1], mode).numpy(),
                                   want[:, 1], rtol=RTOL, atol=ATOL)

    @staticmethod
    def _jax_grad(jx, mode, x, mask, cot):
        jfn = jx.gnn.masked_mean if mode == "mean" else jx.gnn.masked_sum
        return np.asarray(jx.jax.grad(
            lambda v: (jfn(v, jx.jnp.asarray(mask)) * cot).sum())(jx.jnp.asarray(x)))

    def test_max_backward_raises(self):
        h, mask, _ = _nbr_data(3)
        x = _t(h.reshape(-1, 3, 8)).requires_grad_(True)
        out = ops.seg_aggr(x, _t(mask.reshape(-1, 3)), "max")  # forward only is fine
        with pytest.raises(NotImplementedError, match="B1 max backward"):
            out.sum().backward()

    def test_cuda_wrapper_refuses_cpu_tensors(self):
        with pytest.raises(ValueError, match="CUDA"):
            seg_aggr_bwd_cuda(torch.ones(4, 8), torch.ones(4, 3, dtype=torch.bool))


# ------------------------------------------------------------- inbatch loss
class TestInbatchLoss:
    @pytest.mark.parametrize("P", [1, 37, 128, 512])
    def test_rows_loss_and_grads_match_repro(self, jx, P):
        """Rows vs the jnp oracle; loss and gradients vs ``jax.grad`` of the
        plain loss and vs the Pallas kernel (interpret mode) with its VJP."""
        s, d = _pair_data(P, P)
        ts, td = _t(s).requires_grad_(True), _t(d).requires_grad_(True)
        rows = ops.inbatch_loss_rows(ts.detach(), td.detach(), 0.7).numpy()
        js, jd = jx.jnp.asarray(s), jx.jnp.asarray(d)
        np.testing.assert_allclose(
            rows, np.asarray(jx.ref.inbatch_loss_rows_ref(js, jd, 0.7)), rtol=RTOL, atol=ATOL)
        loss = ops.inbatch_loss(ts, td, 0.7)
        loss.backward()
        plain = jx.jax.value_and_grad(
            lambda a, b: jx.ref.inbatch_loss_ref(a, b, 0.7), (0, 1))(js, jd)
        kern = jx.jax.value_and_grad(
            lambda a, b: jx.ops.inbatch_loss(a, b, 0.7), (0, 1))(js, jd)
        for want_loss, (want_src, want_dst) in (plain, kern):
            np.testing.assert_allclose(loss.item(), float(want_loss), rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(ts.grad.numpy(), np.asarray(want_src),
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(td.grad.numpy(), np.asarray(want_dst),
                                       rtol=RTOL, atol=ATOL)

    def test_cuda_wrapper_refuses_cpu_tensors(self):
        s, d = _pair_data(0, 8)
        with pytest.raises(ValueError, match="CUDA"):
            inbatch_loss_rows_cuda(_t(s), _t(d))

    @pytest.mark.parametrize("P", [1, 40, 64, 65, 100, 512, 513, 1000, 2048, 8192, 100000])
    def test_column_plan_covers_columns_in_one_cluster(self, P):
        """Whole column tiles, no empty split, every column, at most 8 splits
        (one cluster a row tile); 128 blocks at the training path's P."""
        splits, split_cols = plan_columns(P)
        assert 1 <= splits <= MAX_CLUSTER and split_cols % COL_TILE == 0
        assert (splits - 1) * split_cols < P <= splits * split_cols
        if P == 512:
            assert -(-P // ROW_TILE) * splits >= 128


# ------------------------------------------------------------- row adagrad
class TestRowAdagrad:
    @pytest.mark.parametrize("n_pad,with_row0", [(12, True), (0, True), (5, False)],
                             ids=["leading-pads-row0-real", "no-pads", "pads-row0-untouched"])
    def test_matches_repro_oracle_and_pallas(self, jx, n_pad, with_row0):
        table, accum, ids, grads = _adagrad_data(n_pad, n_pad=n_pad, with_row0=with_row0)
        t, a = _t(table.copy()), _t(accum.copy())
        out = ops.rowwise_adagrad_scatter(t, a, _t(ids), _t(grads), lr=0.5, eps=1e-8)
        assert out[0] is t and out[1] is a  # in place
        args = [jx.jnp.asarray(v) for v in (table, accum, ids, grads)]
        for jt, ja in (jx.ref.row_adagrad_scatter_ref(*args, lr=0.5, eps=1e-8),
                       jx.ops.rowwise_adagrad_scatter(*args, lr=0.5, eps=1e-8)):
            np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=RTOL, atol=ATOL)
        untouched = np.setdiff1d(np.arange(len(table)), ids[ids >= 0])
        np.testing.assert_array_equal(t.numpy()[untouched], table[untouched])
        np.testing.assert_array_equal(a.numpy()[untouched], accum[untouched])
        assert with_row0 == (not np.array_equal(t.numpy()[0], table[0]))

    @pytest.mark.parametrize("with_row0", [True, False], ids=["row0-real", "row0-absent"])
    def test_recorded_shape_matches_repro_oracle_and_pallas(self, jx, with_row0):
        """The host path's recorded call: N 28,000, D 64, bucket 2,048 with
        leading PADs, against ``repro``'s oracle and its Pallas kernel
        (interpret mode)."""
        table, accum, ids, grads = _adagrad_data(
            11 + with_row0, N=28000, D=64, n_real=2000, n_pad=48, with_row0=with_row0)
        assert len(ids) == 2048 and (ids[:48] == -1).all()
        t, a = _t(table.copy()), _t(accum.copy())
        ref.row_adagrad_scatter_ref(t, a, _t(ids), _t(grads), lr=0.05, eps=1e-8)
        args = [jx.jnp.asarray(v) for v in (table, accum, ids, grads)]
        for jt, ja in (jx.ref.row_adagrad_scatter_ref(*args, lr=0.05, eps=1e-8),
                       jx.ops.rowwise_adagrad_scatter(*args, lr=0.05, eps=1e-8)):
            np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=RTOL, atol=ATOL)
        untouched = np.setdiff1d(np.arange(len(table)), ids[ids >= 0])
        np.testing.assert_array_equal(t.numpy()[untouched], table[untouched])
        np.testing.assert_array_equal(a.numpy()[untouched], accum[untouched])
        assert with_row0 == (not np.array_equal(t.numpy()[0], table[0]))

    def test_embedding_optimizer_scatter_form(self, jx):
        from repro.embedding import optimizer as jopt
        from repro_torch.embedding import optimizer as topt

        table, accum, ids, grads = _adagrad_data(7)
        state = topt.RowAdagradState(accum={"node": _t(accum.copy())})
        params = {"node": _t(table.copy())}
        new_p, new_s = topt.rowwise_adagrad_scatter_update(
            params, {"node": _t(grads)}, {"node": _t(ids)}, state, lr=0.3)
        jp, js = jopt.rowwise_adagrad_scatter_update(
            {"node": jx.jnp.asarray(table)}, {"node": jx.jnp.asarray(grads)},
            {"node": jx.jnp.asarray(ids)},
            jopt.RowAdagradState(accum={"node": jx.jnp.asarray(accum)}), lr=0.3)
        np.testing.assert_allclose(new_p["node"].numpy(), np.asarray(jp["node"]),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(new_s.accum["node"].numpy(), np.asarray(js.accum["node"]),
                                   rtol=RTOL, atol=ATOL)

    def test_cuda_wrapper_refuses_cpu_tensors(self):
        table, accum, ids, grads = _adagrad_data(0)
        with pytest.raises(ValueError, match="CUDA"):
            row_adagrad_scatter_cuda(_t(table), _t(accum), _t(ids), _t(grads))


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
class TestOnCard:
    @pytest.mark.parametrize("mode", ["mean", "sum"])
    def test_gradient_flows_through_masked_aggregation(self, cuda, mode):
        """The fault: the kernel's output had no grad_fn on the card."""
        h, mask, cot = _nbr_data(4, B=16, W=8, F=3, d=64)
        fn = gnn.masked_mean if mode == "mean" else gnn.masked_sum
        x = _t(h).to(cuda).requires_grad_(True)
        out = fn(x, _t(mask).to(cuda))
        assert out.grad_fn is not None
        (out * _t(cot).to(cuda)).sum().backward()
        x0 = _t(h).requires_grad_(True)  # the plain version's gradient
        (fn(x0, _t(mask)) * _t(cot)).sum().backward()
        torch.testing.assert_close(x.grad.cpu(), x0.grad, rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("mode", ["mean", "sum"])
    @pytest.mark.parametrize("N,F,D", [(8192, 3, 64), (1024, 4, 64), (37, 6, 130), (1, 1, 5)])
    def test_seg_aggr_bwd_matches_plain(self, cuda, mode, N, F, D):
        rng = np.random.default_rng(N)
        g = _t(rng.normal(size=(N, D)).astype(np.float32)).to(cuda)
        mask = _t(rng.random((N, F)) < 0.6).to(cuda)
        got = seg_aggr_bwd_cuda(g, mask, mode)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref.seg_aggr_bwd_ref(g, mask, mode), rtol=0, atol=0)

    @pytest.mark.parametrize("P,d", [(1, 8), (37, 16), (128, 64), (512, 64), (513, 256), (65, 768)])
    def test_inbatch_rows_match_plain(self, cuda, P, d):
        s, t = (_t(a).to(cuda) for a in _pair_data(P, P, d))
        got = inbatch_loss_rows_cuda(s, t, 0.7)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref.inbatch_loss_rows_ref(s, t, 0.7),
                                   rtol=RTOL, atol=1e-5)

    @pytest.mark.parametrize("P,d", [
        (40, 1), (100, 63),  # P below one cluster's columns: 1 and 2 splits
        (1000, 64), (777, 256),  # P not a multiple of the tiles
        (300, 768), (2048, 64), (8192, 64), (8192, 256),
    ])
    def test_inbatch_rows_match_plain_in_clusters(self, cuda, P, d):
        s, t = (_t(a).to(cuda) for a in _pair_data(P + d, P, d))
        got = inbatch_loss_rows_cuda(s, t, 0.7)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref.inbatch_loss_rows_ref(s, t, 0.7),
                                   rtol=RTOL, atol=1e-5)

    def test_inbatch_rows_read_misaligned_rows(self, cuda):
        """Rows that do not start on 16 bytes take the 4-byte copies."""
        s, t = (_t(a) for a in _pair_data(3, 300, 64))
        base = torch.zeros(2, s.numel() + 1, device=cuda)
        src, dst = base[0, 1:].view(s.shape), base[1, 1:].view(t.shape)
        src.copy_(s)
        dst.copy_(t)
        torch.testing.assert_close(inbatch_loss_rows_cuda(src, dst, 0.7),
                                   ref.inbatch_loss_rows_ref(src, dst, 0.7), rtol=RTOL, atol=1e-5)

    @pytest.mark.parametrize("P,d", [(512, 64), (8192, 64)])
    def test_inbatch_rows_bitwise_rerun(self, cuda, P, d):
        s, t = (_t(a).to(cuda) for a in _pair_data(P, P, d))
        assert torch.equal(inbatch_loss_rows_cuda(s, t, 0.7), inbatch_loss_rows_cuda(s, t, 0.7))

    @pytest.mark.parametrize("n_pad,with_row0", [(12, True), (0, True), (5, False)])
    def test_row_adagrad_matches_plain(self, cuda, n_pad, with_row0):
        table, accum, ids, grads = (_t(a).to(cuda) for a in _adagrad_data(
            n_pad, N=5000, D=64, n_real=900, n_pad=n_pad, with_row0=with_row0))
        t1, a1, t2, a2 = table.clone(), accum.clone(), table.clone(), accum.clone()
        row_adagrad_scatter_cuda(t1, a1, ids, grads, lr=0.5)
        ref.row_adagrad_scatter_ref(t2, a2, ids, grads, lr=0.5)
        torch.cuda.synchronize()
        torch.testing.assert_close(t1, t2, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(a1, a2, rtol=RTOL, atol=ATOL)
        touched = torch.zeros(len(table), dtype=torch.bool, device=cuda)
        touched[ids[ids >= 0]] = True
        assert torch.equal(t1[~touched], table[~touched])
        assert torch.equal(a1[~touched], accum[~touched])

    # ---- the seg_aggr backward, bitwise against its plain version
    @pytest.mark.parametrize("mode", ["mean", "sum"])
    @pytest.mark.parametrize("N,F,D", RECORDED_BWD_SHAPES)
    def test_seg_aggr_bwd_bitwise_at_recorded_shapes(self, cuda, mode, N, F, D):
        _, mask, cot = _bwd_data(N, F, D)
        g, mk = _t(cot).to(cuda), _t(mask).to(cuda)
        want = ref.seg_aggr_bwd_ref(g, mk, mode)
        assert torch.equal(seg_aggr_bwd_cuda(g, mk, mode), want)

    @pytest.mark.parametrize("mode", ["mean", "sum"])
    @pytest.mark.parametrize("F", [1, 2, 3, 4, 5, 6, 7, 8, 11])
    @pytest.mark.parametrize("D", [1, 3, 64, 130])
    def test_seg_aggr_bwd_bitwise_over_f_and_d(self, cuda, mode, F, D):
        """F past the 4 mask bytes a thread keeps in registers; D 1, 3 and
        130 take the 4-byte path, 64 the 16-byte one."""
        _, mask, cot = _bwd_data(77, F, D)
        g, mk = _t(cot).to(cuda), _t(mask).to(cuda)
        want = ref.seg_aggr_bwd_ref(g, mk, mode)
        assert torch.equal(seg_aggr_bwd_cuda(g, mk, mode), want)

    @pytest.mark.parametrize("mode", ["mean", "sum"])
    def test_seg_aggr_bwd_bitwise_past_one_wave(self, cuda, mode):
        """200,003 rows: more rows than one wave of blocks takes, so every
        lane strides."""
        _, mask, cot = _bwd_data(200_003, 3, 64, seed=3)
        g, mk = _t(cot).to(cuda), _t(mask).to(cuda)
        attrs = seg_aggr.kernel_attrs(True, backward=True)
        assert 200_003 * 16 > attrs["grid_cap"] * 256
        want = ref.seg_aggr_bwd_ref(g, mk, mode)
        assert torch.equal(seg_aggr_bwd_cuda(g, mk, mode), want)

    @pytest.mark.parametrize("mode", ["mean", "sum"])
    def test_seg_aggr_bwd_misaligned_g_and_strided_mask(self, cuda, mode):
        """g one float past a 16-byte boundary takes the 4-byte path; the mask
        is relation 1 of an (N, 2, F) block, row stride 2F."""
        _, mask, cot = _bwd_data(4096, 3, 64, seed=4)
        base = torch.zeros(cot.size + 1, device=cuda)
        g = base[1:].view(cot.shape)
        g.copy_(_t(cot))
        assert g.data_ptr() % 16 != 0 and g.is_contiguous()
        full = torch.zeros(4096, 2, 3, dtype=torch.bool, device=cuda)
        full[:, 1] = _t(mask).to(cuda)
        mk = full[:, 1]
        assert mk.stride() == (6, 1)
        want = ref.seg_aggr_bwd_ref(g, mk, mode)
        assert torch.equal(seg_aggr_bwd_cuda(g, mk, mode), want)

    @pytest.mark.parametrize("mode", ["mean", "sum"])
    def test_seg_aggr_bwd_all_masked_rows_and_inf_nan(self, cuda, mode):
        """All-masked rows give zeros (-0 where g < 0, as 0 * g does, and NaN
        where g is inf); inf and NaN in g go through the multiply as in the
        plain version: the bits are compared, NaNs included."""
        _, mask, cot = _bwd_data(512, 4, 64, seed=6)
        mask[:40] = False
        cot[5, 3], cot[6, 7], cot[50, 0], cot[51, 9], cot[52, 2] = (
            np.inf, -np.inf, np.nan, np.inf, -np.nan)
        mask[50:53] = True
        mask[51, 1] = False
        g, mk = _t(cot).to(cuda), _t(mask).to(cuda)
        want = ref.seg_aggr_bwd_ref(g, mk, mode)
        assert want[5].isnan().any() and want[50:53].isnan().any()
        assert torch.cat([want[:5], want[7:40]]).eq(0).all()
        got = seg_aggr_bwd_cuda(g, mk, mode)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))

    def test_seg_aggr_bwd_build_attrs(self, cuda):
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        for vec in (True, False):
            a = seg_aggr.kernel_attrs(vec, backward=True)
            assert a["local_bytes"] == 0 and a["shared_bytes"] == 0
            assert a["blocks_per_sm"] >= 1 and a["grid_cap"] == a["blocks_per_sm"] * sms

    # ---- row_adagrad
    @staticmethod
    def _adagrad_check(cuda, table, accum, ids, grads, lr=0.5):
        table, accum, ids, grads = (_t(a).to(cuda) for a in (table, accum, ids, grads))
        t1, a1, t2, a2, t3, a3 = (x.clone() for x in (table, accum) * 3)
        row_adagrad_scatter_cuda(t1, a1, ids, grads, lr=lr)
        row_adagrad_scatter_cuda(t3, a3, ids, grads, lr=lr)
        ref.row_adagrad_scatter_ref(t2, a2, ids, grads, lr=lr)
        torch.cuda.synchronize()
        torch.testing.assert_close(t1, t2, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(a1, a2, rtol=RTOL, atol=ATOL)
        assert torch.equal(t1, t3) and torch.equal(a1, a3)  # a re-run, bitwise
        touched = torch.zeros(len(table), dtype=torch.bool, device=cuda)
        live = ids[(ids >= 0) & (ids < len(table))]
        touched[live] = True
        assert torch.equal(t1[~touched], table[~touched])
        assert torch.equal(a1[~touched], accum[~touched])
        return t1, a1

    @pytest.mark.parametrize("D", [1, 3, 64, 130, 256])
    @pytest.mark.parametrize("bucket", [2048, 40_000])
    def test_row_adagrad_over_d_and_buckets(self, cuda, D, bucket):
        """D 1, 3 and 130 take the 4-byte path (130 past the registers'
        two vectors a lane), 64 and 256 the 16-byte one; a bucket of 40,000
        slots is more than one wave of blocks takes."""
        if bucket > 2048:
            per_pass = row_adagrad.kernel_attrs(D % 4 == 0)["grid_cap"] * 256 // (
                16 if D % 4 == 0 else 32)
            assert bucket > per_pass
        n_pad = bucket // 40
        self._adagrad_check(cuda, *_adagrad_data(D + bucket, N=bucket + 500, D=D,
                                                 n_real=bucket - n_pad, n_pad=n_pad))

    def test_row_adagrad_all_pad_bucket(self, cuda):
        table, accum, ids, grads = _adagrad_data(8, N=300, D=64, n_real=1, n_pad=63)
        ids[:] = -1
        t1, a1 = self._adagrad_check(cuda, table, accum, ids, grads)
        assert torch.equal(t1.cpu(), _t(table)) and torch.equal(a1.cpu(), _t(accum))

    @pytest.mark.parametrize("D", [64, 3])
    def test_row_adagrad_drops_ids_at_and_past_n(self, cuda, D):
        table, accum, ids, grads = _adagrad_data(9, N=1000, D=D, n_real=500, n_pad=20)
        ids[-3:] = [1000, 1001, 5000]  # at and past N: dropped, as the scatter drops them
        self._adagrad_check(cuda, table, accum, ids, grads)

    def test_row_adagrad_misaligned_table_takes_4_byte_path(self, cuda):
        table, accum, ids, grads = (_t(a) for a in _adagrad_data(10, N=3000, D=64,
                                                                 n_real=1500, n_pad=12))
        base = torch.zeros(table.numel() + 1, device=cuda)
        t1 = base[1:].view(table.shape)
        t1.copy_(table)
        assert t1.data_ptr() % 16 != 0
        a1, t2, a2 = (x.to(cuda).clone() for x in (accum, table, accum))
        ids_c, grads_c = ids.to(cuda), grads.to(cuda)
        row_adagrad_scatter_cuda(t1, a1, ids_c, grads_c, lr=0.5)
        ref.row_adagrad_scatter_ref(t2, a2, ids_c, grads_c, lr=0.5)
        torch.testing.assert_close(t1, t2, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(a1, a2, rtol=RTOL, atol=ATOL)

    def test_row_adagrad_build_attrs(self, cuda):
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        for vec in (True, False):
            a = row_adagrad.kernel_attrs(vec)
            assert a["local_bytes"] == 0 and a["shared_bytes"] == 0
            assert a["blocks_per_sm"] >= 1 and a["grid_cap"] == a["blocks_per_sm"] * sms
