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
from repro_torch.kernels import ops, ref
from repro_torch.kernels.inbatch_loss import (COL_TILE, MAX_CLUSTER, ROW_TILE,
                                              inbatch_loss_rows_cuda, plan_columns)
from repro_torch.kernels.row_adagrad import row_adagrad_scatter_cuda
from repro_torch.kernels.seg_aggr import seg_aggr_bwd_cuda

pytestmark = pytest.mark.quick

RTOL, ATOL = 1e-5, 1e-6


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
