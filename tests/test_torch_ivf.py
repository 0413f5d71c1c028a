"""IVF retrieval of the port against ``repro``'s: the shortlist kernel's
plain version, the index build, search and recall evaluation.

On the CPU, inputs are made with numpy from fixed seeds and go through both
packages:

- ``kernels.ref.ivf_list_topk_ref`` vs ``repro``'s jnp oracle and its
  Pallas kernel in interpret mode: rows exactly; scores to rtol 2e-5 /
  atol 1e-4 (the reference's own tolerance: the dots sum in other
  orders), exactly on the all-ties, int-valued and signed-zero cases.
- ``IVFIndex.build``: every field bitwise equal to ``repro``'s (same numpy
  code, same generator stream) for exact and hierarchical assignment, a
  k-means training subsample and a hot-cell spill.
- ``IVFIndex.search`` on ``repro``'s very index (``convert``): ids and
  scores exactly equal on int-valued data at partial and full probing;
  at full probing ids equal to ``brute_force_topk`` on float data.
- ``evaluate_recall(method="ivf")`` metrics equal to ``repro``'s on TOY,
  and through the trainer and ``examples/recall_torch.py``.

- ``kernels.ivf.plan_launch``: every probe of every query in exactly one
  block, clusters of at most 8 that the card holds, and the regime that
  PERF.md names at each recorded main-path shape, under a model of the
  H100's residency.

``TestOnCard`` runs only where there is a CUDA card (the kernel against
its plain version on the hazard cases, both sides of one block's shared
memory, every forced plan, bitwise re-runs, card search vs CPU search, a
dispatch that does not sync):
    python -m pytest -q -m cuda tests/test_torch_ivf.py
"""
import dataclasses
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core.recall import STRATEGIES, evaluate_recall
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ivf as kivf
from repro_torch.kernels.ivf import ivf_list_topk_cuda, ivf_list_topk_planned
from repro_torch.retrieval import IVFConfig, IVFIndex, brute_force_topk
from repro_torch.retrieval import ivf as tivf

pytestmark = pytest.mark.quick

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-5, 1e-4  # repro's kernel-vs-oracle tolerance (tests/test_kernels.py)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _lists(seed, Q, P, d, lpad, rows, kind="random"):
    """(q, codes, scales, starts, lens) numpy inputs of one shortlist case.

    ``random``: ragged lists at random (overlapping) starts, lengths 0..lpad;
    ``ties``: every score equal; ``int``: int-valued queries, power-of-two
    scales, so every f32 score is exact; ``zeros``: all-zero codes against
    positive queries and scales of both signs, so the scores are +0.0 and
    -0.0 only."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(-127, 128, size=(rows + lpad, d)).astype(np.int8)
    scales = rng.uniform(0.5, 2.0, size=(rows + lpad, 1)).astype(np.float32)
    q = rng.normal(size=(Q, d)).astype(np.float32)
    starts = rng.integers(0, rows, size=(Q, P)).astype(np.int32)
    lens = rng.integers(0, lpad + 1, size=(Q, P)).astype(np.int32)
    if kind == "ties":
        codes[:], scales[:], q[:] = 1, 1.0, 1.0
        lens = np.maximum(lens, 1)
    elif kind == "int":
        q = rng.integers(-3, 4, size=(Q, d)).astype(np.float32)
        scales = (2.0 ** rng.integers(-3, 4, size=(rows + lpad, 1))).astype(np.float32)
    elif kind == "zeros":
        codes[:] = 0
        q = np.abs(q) + 0.5
        scales = np.where(rng.random((rows + lpad, 1)) < 0.5, -1.0, 1.0).astype(np.float32)
    return q, codes, scales, starts, lens


def _data(seed=0, Q=29, I=501, d=16, int_valued=False):
    """tests/test_retrieval.py's corpus: queries, items, (Q, 6) exclusions."""
    rng = np.random.default_rng(seed)
    if int_valued:
        q = rng.integers(-3, 4, size=(Q, d)).astype(np.float32)
        it = rng.integers(-3, 4, size=(I, d)).astype(np.float32)
    else:
        q = rng.normal(size=(Q, d)).astype(np.float32)
        it = rng.normal(size=(I, d)).astype(np.float32)
    ex = np.full((Q, 6), -1, np.int32)
    ex[:, :4] = rng.integers(0, I, size=(Q, 4))
    return q, it, ex


@pytest.fixture(scope="module")
def jx():
    """``repro``'s kernels, retrieval and recall, the reference (needs JAX
    on the CPU)."""
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("repro is the reference on the CPU; run with JAX_PLATFORMS=cpu")
    from repro.core.recall import evaluate_recall as j_evaluate_recall
    from repro.kernels import ref as jref
    from repro.kernels.ivf import ivf_list_topk_pallas
    from repro.retrieval import IVFConfig as JIVFConfig
    from repro.retrieval import IVFIndex as JIVFIndex

    return types.SimpleNamespace(jax=jax, ref=jref, pallas=ivf_list_topk_pallas,
                                 Config=JIVFConfig, Index=JIVFIndex,
                                 evaluate_recall=j_evaluate_recall)


# --------------------------------------------------------- the plain version
class TestListTopkRef:
    CASES = [  # (seed, Q, P, d, lpad, rows, shortlist, kind)
        (47, 7, 3, 16, 24, 300, 16, "random"),  # tests/test_kernels.py's cases
        (56, 16, 5, 16, 40, 300, 64, "random"),
        (9, 4, 3, 8, 10, 60, 12, "ties"),
        (77, 3, 2, 8, 6, 50, 10, "filler"),
        (5, 9, 4, 6, 13, 80, 30, "int"),
        (11, 6, 3, 8, 12, 40, 30, "zeros"),
        (12, 1, 6, 20, 37, 90, 222, "random"),  # Q = 1, lpad not a multiple of 32
    ]

    @pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[-1]}-Q{c[1]}-lpad{c[4]}")
    def test_matches_repro_oracle_and_pallas(self, jx, case):
        seed, Q, P, d, lpad, rows, S, kind = case
        q, codes, scales, starts, lens = _lists(seed, Q, P, d, lpad, rows,
                                                "random" if kind == "filler" else kind)
        if kind == "filler":  # 4 candidates < shortlist 10
            lens = np.full((Q, P), 2, np.int32)
        got_s, got_r = ops.ivf_list_topk(*map(_t, (q, codes, scales, starts, lens)),
                                         lpad=lpad, shortlist=S)
        got_s, got_r = got_s.numpy(), got_r.numpy()
        args = tuple(jx.jax.device_put(a) for a in (q, codes, scales, starts, lens))
        for want_s, want_r in (
            jx.ref.ivf_list_topk_ref(*args, lpad=lpad, shortlist=S),
            jx.pallas(*args, lpad=lpad, shortlist=S, interpret=True),
        ):
            want_s, want_r = np.asarray(want_s), np.asarray(want_r)
            np.testing.assert_array_equal(got_r, want_r)
            if kind in ("ties", "int", "zeros"):  # exact f32 scores, signs included
                np.testing.assert_array_equal(got_s.view(np.int32), want_s.view(np.int32))
            else:
                np.testing.assert_allclose(got_s, want_s, rtol=RTOL, atol=ATOL)
        if kind == "filler":
            assert np.isneginf(got_s[:, 4:]).all() and (got_r[:, 4:] == -1).all()
        if kind == "zeros":  # +0.0 ranks above -0.0, as lax.top_k ranks them
            sign = np.signbit(got_s[got_r >= 0]).reshape(-1)
            assert sign.any() and (~sign).any()

    def test_total_order_key_ranks_signed_zero(self):
        x = torch.tensor([-0.0, 0.0, -0.0, 0.0, -1.0, float("-inf"), 2.0])
        assert ref.desc_order(x, 7).tolist() == [6, 1, 3, 0, 2, 4, 5]

    def test_shortlist_out_of_range_raises(self):
        q, codes, scales, starts, lens = _lists(0, 2, 2, 4, 5, 20)
        with pytest.raises(ValueError, match="shortlist"):
            ops.ivf_list_topk(*map(_t, (q, codes, scales, starts, lens)), lpad=5,
                              shortlist=11)

    def test_cuda_wrapper_refuses_cpu_tensors(self):
        # no silent fallback: the kernel wrapper never runs the plain version
        q, codes, scales, starts, lens = _lists(1, 2, 2, 4, 5, 20)
        with pytest.raises(ValueError, match="CUDA"):
            ivf_list_topk_cuda(*map(_t, (q, codes, scales, starts, lens)), 5, 4)

    def test_unknown_device_raises(self):
        q = torch.zeros((1, 4), device="meta")
        with pytest.raises(ValueError, match="device"):
            ops.ivf_list_topk(q, q, q, q, q, lpad=1, shortlist=1)


# ------------------------------------------------------------------- build
def _hot():
    rng = np.random.default_rng(4)
    return (np.ones((600, 8)) * 3 + rng.normal(size=(600, 8))).astype(np.float32)


BUILDS = {  # name -> (items, config kwargs)
    "exact": (lambda: _data(I=500)[1], dict(nlist=16, nprobe=4, assign_mode="exact")),
    "hier": (lambda: _data(I=500)[1], dict(nlist=16, nprobe=16, assign_mode="hier")),
    "train_size": (lambda: _data(I=600)[1], dict(nlist=8, nprobe=8, train_size=100)),
    # tests/test_retrieval.py's pathological input (one hot direction) at its
    # balance 2.0, and at 1.1, where k-means leaves cells over the cap
    "spill": (lambda: _hot(), dict(nlist=12, nprobe=12, balance_factor=2.0)),
    "spill_tight": (lambda: _hot(), dict(nlist=12, nprobe=12, balance_factor=1.1)),
}
FIELDS = ("centroids", "order", "offsets", "codes", "scales", "items")


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_build_is_bitwise_repros(jx, name):
    items_fn, kw = BUILDS[name]
    items = items_fn()
    got = IVFIndex.build(items, IVFConfig(seed=0, **kw), device="cpu")
    want = jx.Index.build(items, jx.Config(seed=0, **kw))
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert (got.lpad, got.spilled_items) == (want.lpad, want.spilled_items)
    assert dataclasses.asdict(got.config) == dataclasses.asdict(want.config)
    np.testing.assert_array_equal(got.lists, want.lists)
    assert got.candidates_per_query == want.candidates_per_query
    if name.startswith("spill"):
        cap = int(np.ceil(kw["balance_factor"] * 600 / 12))
        assert got.lpad <= cap and sorted(got.order.tolist()) == list(range(600))
    if name == "spill_tight":
        assert got.spilled_items > 0


def test_convert_carries_repros_index(jx):
    items = _data(I=300)[1]
    want = jx.Index.build(items, jx.Config(nlist=8, nprobe=3, seed=0, rerank=40))
    got = convert.ivf_index_from_numpy(want, device="cpu")
    assert got.device.type == "cpu" and got.config.rerank == 40
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for name, t in got._dev.items():  # uploaded once, at construction
        np.testing.assert_array_equal(t.numpy(), getattr(want, name))


# ------------------------------------------------------------------ search
class TestSearch:
    @pytest.mark.parametrize("nprobe", [3, 7])
    def test_int_valued_equals_repro_on_the_same_index(self, jx, nprobe):
        # int-valued embeddings: exact f32 dots, many real ties; the two
        # packages search one index, so ids AND scores must be equal
        q, it, ex = _data(int_valued=True, d=6, I=300)
        jidx = jx.Index.build(it, jx.Config(nlist=7, nprobe=nprobe, seed=0))
        tidx = convert.ivf_index_from_numpy(jidx, device="cpu")
        for exclude in (None, ex):
            s0, i0 = jidx.search(q, 40, exclude=exclude)
            s1, i1 = tidx.search(q, 40, exclude=exclude)
            np.testing.assert_array_equal(i1, i0)
            np.testing.assert_array_equal(s1, s0)
            assert tidx.last_cells_probed == jidx.last_cells_probed
            assert tidx.last_candidates_scored == jidx.last_candidates_scored

    def test_full_probe_equals_oracle(self, jx):
        q, it, ex = _data(I=420)
        tidx = convert.ivf_index_from_numpy(
            jx.Index.build(it, jx.Config(nlist=11, nprobe=11, seed=0)), device="cpu")
        s0, i0 = brute_force_topk(q, it, 17, exclude=ex)
        s1, i1 = tidx.search(q, 17, exclude=ex)
        np.testing.assert_array_equal(i1, i0)
        np.testing.assert_allclose(s1, s0, rtol=1e-5)

    def test_full_probe_int_valued_equals_oracle(self):
        q, it, _ = _data(int_valued=True, d=6, I=300)
        idx = IVFIndex.build(it, IVFConfig(nlist=7, nprobe=7, seed=0), device="cpu")
        s0, i0 = brute_force_topk(q, it, 40)
        s1, i1 = idx.search(q, 40)
        np.testing.assert_array_equal(i1, i0)
        np.testing.assert_array_equal(s1, s0)

    def test_host_and_device_rerank_agree(self):
        q, it, ex = _data(I=350)
        dev = IVFIndex.build(it, IVFConfig(nlist=9, nprobe=4, seed=0), device="cpu")
        host = IVFIndex.build(it, IVFConfig(nlist=9, nprobe=4, seed=0,
                                            keep_exact_device=False), device="cpu")
        assert "items" not in host._dev
        sd, idd = dev.search(q, 13, exclude=ex)
        sh, ih = host.search(q, 13, exclude=ex)
        np.testing.assert_array_equal(idd, ih)
        np.testing.assert_allclose(sd, sh, rtol=1e-6)

    def test_exclusion_respected(self):
        q, it, ex = _data(I=300)
        idx = IVFIndex.build(it, IVFConfig(nlist=8, nprobe=3, seed=0), device="cpu")
        _, ids = idx.search(q, 15, exclude=ex)
        for row, exr in zip(ids, ex):
            assert not set(row.tolist()) & set(exr[exr >= 0].tolist())
        _, ids = idx.search(q, 15, exclude=np.zeros((len(q), 0), np.int32))
        np.testing.assert_array_equal(ids, idx.search(q, 15)[1])

    def test_rerank_budget_and_padding_past_the_shortlist(self, jx):
        q, it, _ = _data(I=400)
        jidx = jx.Index.build(it, jx.Config(nlist=10, nprobe=2, rerank=32, seed=0))
        tidx = convert.ivf_index_from_numpy(jidx, device="cpu")
        plan = tidx.plan(20, len(q), 1)
        assert plan["shortlist"] == min(32 + 1, 2 * tidx.lpad)
        s, i = tidx.search(q, 20)
        assert s.shape == i.shape == (len(q), 20)
        ok = i >= 0
        assert np.isfinite(s[ok]).all() and np.isneginf(s[~ok]).all()
        # k past the probe budget (the largest shortlist): the tail is
        # (-inf, -1), as repro pads it
        budget = 2 * tidx.lpad
        s, i = tidx.search(q, budget + 7)
        s0, i0 = jidx.search(q, budget + 7)
        np.testing.assert_array_equal(i, i0)
        assert tidx.plan(budget + 7, len(q), 1)["shortlist"] == budget
        assert (i[:, budget:] == -1).all() and np.isneginf(s[:, budget:]).all()

    def test_blocked_search_equals_one_block(self, monkeypatch):
        q, it, ex = _data(I=500)
        idx = IVFIndex.build(it, IVFConfig(nlist=8, nprobe=8, seed=0), device="cpu")
        whole = idx.search(q, 11, exclude=ex)
        n_whole = idx.last_candidates_scored
        per_query = idx.plan(11, 1, ex.shape[1])["shortlist"] * (64 + 8 * 16)
        monkeypatch.setattr(tivf, "SEARCH_BUDGET_BYTES", 4 * per_query)
        assert idx.plan(11, len(q), ex.shape[1])["block"] == 4
        blocked = idx.search(q, 11, exclude=ex)
        np.testing.assert_array_equal(blocked[1], whole[1])
        np.testing.assert_array_equal(blocked[0], whole[0])
        assert idx.last_candidates_scored == n_whole

    def test_validation(self):
        it = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
        for kw, match in ((dict(rerank=-1), "rerank"), (dict(assign_mode="fast"), "assign_mode"),
                          (dict(backend="cuda"), "backend"), (dict(nlist=0), "nlist"),
                          (dict(nprobe=0), "nprobe"), (dict(assign_chunk=0), "assign_chunk")):
            with pytest.raises(ValueError, match=match):
                IVFIndex.build(it, IVFConfig(**{"nlist": 4, **kw}), device="cpu")
        idx = IVFIndex.build(it, IVFConfig(nlist=4), device="cpu")
        with pytest.raises(ValueError, match="k="):
            idx.search(it[:2], 65)
        with pytest.raises(ValueError, match="nprobe"):
            idx.search(it[:2], 3, nprobe=0)

    def test_search_uploads_only_query_sized_arrays(self, monkeypatch):
        q, it, ex = _data(I=1200)
        uploads = []
        real = tivf.to_device

        def spy(a, device):
            uploads.append(np.asarray(a).nbytes)
            return real(a, device)

        monkeypatch.setattr(tivf, "to_device", spy)
        idx = IVFIndex.build(it, IVFConfig(nlist=16, nprobe=4, seed=0), device="cpu")
        assert max(uploads) >= it.nbytes  # the table, once, at construction
        warm = idx.search(q, 9, exclude=ex)
        uploads.clear()
        again = idx.search(q, 9, exclude=ex)
        assert uploads and max(uploads) <= max(q.nbytes, ex.nbytes)
        np.testing.assert_array_equal(again[1], warm[1])

    def test_device_none_means_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present: device=None runs there")
        it = _data(I=64, d=8)[1]
        with pytest.raises(RuntimeError, match="CUDA"):
            IVFIndex.build(it, IVFConfig(nlist=4))


# ------------------------------------------------------------------ recall
@pytest.fixture(scope="module")
def toy_emb():
    """TOY LightGCN embeddings from the port's own random weights."""
    sys.path.insert(0, str(REPO / "examples"))
    import recall_torch
    from repro_torch.graph import TOY, DistributedGraphEngine, generate
    from repro_torch.infer import embed_all_nodes

    ds = generate(TOY, seed=0)
    cfg = recall_torch.model_config(ds.graph, "lightgcn", 16)
    model = convert.init_params(cfg, seed=0, device="cpu")
    emb = embed_all_nodes(model, DistributedGraphEngine(ds.graph, 2), ds.graph,
                          batch_size=128, seed=1, device="cpu")
    ue, ie = emb[: ds.num_users], emb[ds.num_users : ds.num_users + ds.num_items]
    return ds, ue, ie, recall_torch.train_pairs(ds)


@pytest.mark.parametrize("nprobe", [8, 64])
def test_evaluate_recall_ivf_matches_repro(jx, toy_emb, nprobe):
    ds, ue, ie, train = toy_emb
    kw = dict(top_k=50, top_n=10, method="ivf")
    want = jx.evaluate_recall(ue, ie, train, ds.test_pairs,
                              ivf=jx.Config(nlist=64, nprobe=nprobe, seed=0), **kw)
    got = evaluate_recall(ue, ie, train, ds.test_pairs, device="cpu",
                          ivf=IVFConfig(nlist=64, nprobe=nprobe, seed=0), **kw)
    assert set(STRATEGIES) <= got.keys() and got.keys() == want.keys()
    assert got == want


def test_evaluate_recall_ivf_full_probe_equals_bruteforce(toy_emb):
    ds, ue, ie, train = toy_emb
    kw = dict(top_k=50, max_users=40, seed=3)
    bf = evaluate_recall(ue, ie, train, ds.test_pairs, method="bruteforce", **kw)
    ivf = evaluate_recall(ue, ie, train, ds.test_pairs, method="ivf", device="cpu",
                          ivf=IVFConfig(nlist=16, nprobe=16, seed=0), **kw)
    assert ivf == bf


def test_recall_example_method_ivf(toy_emb):
    import recall_torch

    ds, _, _, train = toy_emb
    args = recall_torch.parser().parse_args(
        ["--dim", "16", "--method", "ivf", "--ivf-nlist", "32", "--ivf-nprobe", "4",
         "--device", "cpu", "--top-k", "50"])
    res = recall_torch.run(args)
    assert res["ivf"] == IVFConfig(nlist=32, nprobe=4, seed=0)
    emb = res["embeddings"]
    ue, ie = emb[: ds.num_users], emb[ds.num_users : ds.num_users + ds.num_items]
    want = evaluate_recall(ue, ie, train, ds.test_pairs, top_k=50, method="ivf",
                           device="cpu", ivf=IVFConfig(nlist=32, nprobe=4, seed=0))
    assert res["recall"] == want


def test_trainer_eval_method_ivf():
    sys.path.insert(0, str(REPO / "examples"))
    import train_torch
    from repro_torch.core.model import Graph4RecModel
    from repro_torch.infer import embed_all_nodes

    args = train_torch.parser().parse_args(["--steps", "3", "--eval-recall", "ivf",
                                            "--prefetch-batches", "0"])
    res = train_torch.run(args, device="cpu")
    trainer, r, ds = res["trainer"], res["result"], res["dataset"]
    assert trainer.cfg.eval_method == "ivf" and len(r.eval_history) == 1
    emb = embed_all_nodes(Graph4RecModel(res["config"], r.params), trainer.engine,
                          ds.graph, batch_size=trainer.cfg.eval_batch_size,
                          seed=trainer.cfg.seed + 7, device="cpu")
    ue, ie = emb[: ds.num_users], emb[ds.num_users : ds.num_users + ds.num_items]
    want = evaluate_recall(ue, ie, trainer._train_pairs, ds.val_pairs, method="ivf",
                           device="cpu")
    assert r.eval_history[-1] == want
    with pytest.raises(ValueError, match="eval_method"):
        train_torch.run(args, device="cpu", eval_method="exact")


# ----------------------------------------------------------------- the plan
H100_SMS, H100_SMEM_PER_SM, H100_THREADS_PER_SM = 132, 233_472, 2048


def h100_residency(P, lpad, d, S):
    """A model of the card's residency for ``plan_launch``: blocks an SM
    from threads (256 a block) and shared memory (1 KB reserved a block),
    clusters as if any SMs could host a cluster's blocks."""
    def residency(c):
        smem = kivf.shared_bytes(-(-P // c), lpad, d, c, S)
        per_sm = min(H100_THREADS_PER_SM // 256, H100_SMEM_PER_SM // (smem + 1024))
        return per_sm, H100_SMS * per_sm // c
    return residency


def plan_wave(residency, c):
    """Blocks of clusters of c one wave of the card holds."""
    per_sm, clusters = residency(c)
    return min(H100_SMS * per_sm, clusters * c)


def _plan(Q, P, lpad, d, S):
    return kivf.plan_launch(Q, P, lpad, d, S, H100_SMS, h100_residency(P, lpad, d, S))


# the main paths' recorded calls (Q, P, lpad, d, S) and the regime each takes
RECORDED_PLANS = {
    "ub items S 419": ((8000, 8, 519, 64, 419), ("shared", 1)),
    "ub items Q 14,998 S 129": ((14998, 8, 519, 64, 129), ("shared", 1)),
    "ub users S 129": ((8000, 8, 227, 64, 129), ("shared", 1)),
    "ub exhaustive S 33,216": ((112, 64, 519, 64, 33216), ("shared", 2)),
    "1M arm S 416": ((512, 12, 611, 32, 416), ("shared", 1)),
}


class TestPlan:
    @pytest.mark.parametrize("name", sorted(RECORDED_PLANS))
    def test_recorded_shapes_take_the_named_regime(self, name):
        (Q, P, lpad, d, S), (regime, cluster) = RECORDED_PLANS[name]
        plan = _plan(Q, P, lpad, d, S)
        assert (plan["regime"], plan["cluster"]) == (regime, cluster)
        assert plan["shared_bytes"] <= kivf.SHARED_CAP

    @pytest.mark.parametrize("Q,P,lpad,d,S", [
        (1, 1, 5, 16, 3), (7, 3, 24, 16, 16), (112, 64, 519, 64, 33216), (9, 9, 40, 32, 100),
        (20, 64, 100, 64, 500), (5000, 5, 37, 20, 40), (3, 2, 14000, 32, 10),
        (64, 12, 611, 32, 416), (2, 64, 4000, 64, 5000), (1, 1, 30000, 32, 7),
    ])
    def test_every_probe_in_one_block_and_clusters_fit(self, Q, P, lpad, d, S):
        plan = _plan(Q, P, lpad, d, S)
        c = plan["cluster"]
        if plan["regime"] == "global":  # even 8 blocks cannot hold a query's keys
            assert c == 0
            top = min(kivf.MAX_CLUSTER, P)
            assert all(kivf.shared_bytes(-(-P // c), lpad, d, c, S) > kivf.SHARED_CAP
                       for c in range(1, top + 1))
            return
        assert 1 <= c <= min(kivf.MAX_CLUSTER, P)
        ppb = plan["probes_per_block"]
        owned = [list(kivf.block_probes(P, c, r)) for r in range(c)]
        assert sorted(p for o in owned for p in o) == list(range(P))  # each probe once
        assert max(len(o) for o in owned) == ppb  # the block's keys fit its shared memory
        per_sm, clusters = h100_residency(P, lpad, d, S)(c)
        assert per_sm >= 1 and 1 <= plan["resident_clusters"] == clusters
        assert plan["shared_bytes"] == kivf.shared_bytes(ppb, lpad, d, c, S) <= kivf.SHARED_CAP
        assert plan["blocks"] == Q * c

    @pytest.mark.parametrize("Q,P,lpad,d,S", [
        (112, 64, 519, 64, 33216), (512, 12, 611, 32, 416), (20, 64, 100, 64, 500),
        (4, 64, 1250, 64, 80000), (1, 1, 5, 16, 3), (300, 8, 519, 64, 419),
        (8000, 8, 227, 64, 129),
    ])
    def test_cluster_raised_only_to_fill_one_wave(self, Q, P, lpad, d, S):
        # the smallest cluster that fits, or a larger one only where every
        # smaller one that fits leaves the card's first wave short
        plan = _plan(Q, P, lpad, d, S)
        res = h100_residency(P, lpad, d, S)
        fits = [c for c in range(1, min(kivf.MAX_CLUSTER, P) + 1)
                if kivf.shared_bytes(-(-P // c), lpad, d, c, S) <= kivf.SHARED_CAP]
        c = plan["cluster"]
        assert c == next(f for f in fits if Q * f >= plan_wave(res, f) or f == fits[-1])
        assert all(Q * f < plan_wave(res, f) for f in fits if f < c)
        assert plan["wave"] == plan_wave(res, c)

    def test_capacity_boundary(self):
        # the largest lpad one block holds for P probes, and one more row
        d, P = 32, 2
        lpad = max(n for n in range(1, 20000) if kivf.shared_bytes(P, n, d) <= kivf.SHARED_CAP)
        assert kivf.shared_bytes(1, lpad + 1, d, 2, 10) <= kivf.SHARED_CAP  # 2 blocks hold it
        # with queries enough to fill the card, one block a query where it fits
        assert _plan(100_000, P, lpad, d, 10)["cluster"] == 1
        assert _plan(100_000, P, lpad + 1, d, 10)["cluster"] == 2
        assert _plan(1, 1, 2 * lpad + 8, d, 10)["regime"] == "global"


# ---------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _boundary_lpad(P, d):
    """The largest lpad whose P probes one shared-path block holds."""
    return max(n for n in range(1, 40000) if kivf.shared_bytes(P, n, d) <= kivf.SHARED_CAP)


HAZARDS = [  # (seed, Q, P, d, lpad, rows, shortlist, kind): what each one tests
    (20, 64, 8, 32, 611, 20000, 416, "random"),  # the 1M arm's widths
    (21, 4, 64, 64, 1250, 20000, 64 * 1250, "random"),  # S = P * lpad, 8-block clusters
    (22, 1, 5, 20, 37, 300, 40, "random"),  # Q = 1, lpad % 32 != 0, d % 16 != 0: byte loads
    (23, 8, 6, 32, 50, 400, 300, "empty"),  # lists of length 0
    (24, 5, 3, 16, 40, 300, 120, "filler"),  # S above the candidates
    (25, 6, 4, 16, 30, 200, 90, "ties"),  # all-equal scores: flat order
    (26, 6, 4, 16, 30, 200, 90, "zeros"),  # +0.0 and -0.0
    (27, 9, 5, 6, 13, 80, 50, "int"),  # exact scores, real ties
    # candidates just below and just above one block's shared memory
    (28, 3, 2, 32, _boundary_lpad(2, 32), 30000, 500, "full"),
    (29, 3, 2, 32, _boundary_lpad(2, 32) + 1, 30000, 500, "full"),
    (30, 20, 64, 64, 100, 9000, 500, "random"),  # Q below the SM count, P 64: clusters
    (31, 9, 16, 64, 60, 2000, 16 * 60, "random"),  # S = P * lpad, more slots than candidates
    (32, 3, 64, 64, 4000, 20000, 5000, "full"),  # past a cluster's capacity: the global path
    (33, 7, 6, 32, 80, 500, 200, "overlap"),  # every probe at one start: rows repeat
    (34, 7, 6, 32, 80, 500, 200, "oob"),  # rows outside [0, rows): dropped
    (35, 5, 8, 16, 64, 400, 150, "fewvals"),  # keys tied at the selected threshold
    (36, 40, 12, 128, 70, 3000, 300, "random"),  # d 128, past the prefetch widths: byte loads
]


def _hazard(case, cuda):
    """The device inputs of a hazard case."""
    seed, Q, P, d, lpad, rows, S, kind = case
    base = "random" if kind in ("empty", "filler", "full", "overlap", "oob") else kind
    q, codes, scales, starts, lens = _lists(seed, Q, P, d, lpad, rows,
                                            "int" if kind == "fewvals" else base)
    rng = np.random.default_rng(seed + 1000)
    if kind == "empty":
        lens[:, ::2] = 0
        lens[0] = 0  # a query with nothing to score
    if kind == "filler":
        lens[:] = 7
    if kind == "full":  # every list at lpad: the most keys a query can have
        lens[:] = lpad
        starts = rng.integers(0, rows - lpad, size=(Q, P)).astype(np.int32)
    if kind == "overlap":
        starts[:] = starts[:, :1]
    if kind == "oob":  # some lists start before row 0 or run past the last row
        starts[:, 0] = -rng.integers(1, lpad, size=Q)
        starts[:, 1] = codes.shape[0] - rng.integers(1, lpad, size=Q)
        lens[:, :2] = lpad
    if kind == "fewvals":  # scores in {-2 .. 2}: wide ties at every threshold
        codes = rng.integers(-1, 2, size=codes.shape).astype(np.int8)
        q = np.ones_like(q)
        scales[:] = 1.0
        codes[:, 2:] = 0
    return [_t(a).to(cuda) for a in (q, codes, scales, starts, lens)], lpad, S, kind


def _plain_dropping(q, codes, scales, starts, lens, lpad, S):
    """The plain version on a table padded with zero rows on both sides, with
    every candidate whose row lies outside the real table dropped, as the
    kernel drops it."""
    n = codes.shape[0]
    pad = lpad + int(max(0, -int(starts.min().item())))
    z = torch.zeros((pad, codes.shape[1]), dtype=codes.dtype, device=codes.device)
    zs = torch.zeros((pad, 1), dtype=scales.dtype, device=scales.device)
    s, r = ref.ivf_list_scores(q, torch.cat([z, codes, z]), torch.cat([zs, scales, zs]),
                               starts + pad, lens, lpad)
    real = r - pad
    drop = (r < 0) | (real < 0) | (real >= n)
    s = torch.where(drop, torch.full_like(s, float("-inf")), s)
    r = torch.where(drop, torch.full_like(real, -1), real)
    pos = ref.desc_order(s, S)
    return torch.gather(s, 1, pos), torch.gather(r, 1, pos).to(torch.int32)


def _check(s, r, s0, r0, kind):
    assert torch.equal(r, r0)
    if kind in ("ties", "zeros", "int", "fewvals"):
        assert torch.equal(s.view(torch.int32), s0.view(torch.int32))
    else:
        torch.testing.assert_close(s, s0, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
class TestOnCard:
    @pytest.mark.parametrize("case", HAZARDS, ids=lambda c: f"{c[-1]}-Q{c[1]}-P{c[2]}-lpad{c[4]}")
    def test_kernel_matches_plain(self, cuda, case):
        args, lpad, S, kind = _hazard(case, cuda)
        s, r = ivf_list_topk_cuda(*args, lpad, S)
        torch.cuda.synchronize()
        if kind == "oob":
            s0, r0 = _plain_dropping(*args, lpad, S)
        else:
            s0, r0 = ref.ivf_list_topk_ref(*args, lpad=lpad, shortlist=S)
        _check(s, r, s0, r0, kind)
        if kind == "empty":
            assert (r[0] == -1).all() and torch.isneginf(s[0]).all()
        if kind == "filler":
            assert (r[:, 3 * 7:] == -1).all()
        s2, r2 = ivf_list_topk_cuda(*args, lpad, S)  # re-runs are bitwise equal
        assert torch.equal(s2.view(torch.int32), s.view(torch.int32)) and torch.equal(r2, r)

    def test_plans_of_the_hazards(self, cuda):
        # the regimes the capacity cases and the cluster cases exist for
        regimes = {}
        for case in HAZARDS:
            args, lpad, S, _ = _hazard(case, cuda)
            plan = kivf.launch_plan(args[0], args[1], args[3].shape[1], lpad, S)
            regimes[case[0]] = (plan["regime"], plan["cluster"], plan["load"])
        assert regimes[29][:2] == ("shared", 2)
        assert regimes[30][0] == "shared" and regimes[30][1] > 1
        assert regimes[32][:2] == ("global", 0)
        assert regimes[22][2] == "bytes" and regimes[36][2] == "bytes"
        assert regimes[20][2] == "prefetch2" and regimes[30][2] == "prefetch4"

    @pytest.mark.parametrize("seed", [40, 41])
    def test_every_forced_plan_matches_plain(self, cuda, seed):
        case = (seed, 11, 8, 32 if seed == 40 else 20, 90, 3000, 300, "random")
        args, lpad, S, kind = _hazard(case, cuda)
        s0, r0 = ref.ivf_list_topk_ref(*args, lpad=lpad, shortlist=S)
        for cluster in range(0, 9):  # 0: the global path
            s, r = ivf_list_topk_planned(*args, lpad, S, cluster)
            torch.cuda.synchronize()
            _check(s, r, s0, r0, kind)
        with pytest.raises(ValueError, match="plan"):
            ivf_list_topk_planned(*args, lpad, S, 9)

    def test_both_sides_of_one_blocks_capacity(self, cuda):
        # just below: one block a query holds every key; just above: it cannot
        below, above = (_hazard(c, cuda) for c in HAZARDS[8:10])
        args, lpad, S, kind = below
        s, r = ivf_list_topk_planned(*args, lpad, S, 1)
        _check(s, r, *ref.ivf_list_topk_ref(*args, lpad=lpad, shortlist=S), kind)
        args, lpad, S, _ = above
        with pytest.raises(ValueError, match="plan"):
            ivf_list_topk_planned(*args, lpad, S, 1)

    def test_one_launch_a_call(self, cuda):
        args, lpad, S, _ = _hazard(HAZARDS[1], cuda)
        kivf.launches = 0
        ivf_list_topk_cuda(*args, lpad, S)
        assert kivf.launches == 1

    def test_attrs_match_the_layout(self, cuda):
        for load, d in (("prefetch4", 64), ("prefetch2", 32), ("bytes", 128), ("bytes", 20)):
            for c, S in ((1, 400), (2, 400), (2, 5000)):
                a = kivf.kernel_attrs(load, c, 4, 519, d, S)
                assert a["shared_bytes"] == kivf.shared_bytes(4, 519, d, c, S)
                assert a["local_bytes"] == 0 and a["blocks_per_sm"] >= 1 and a["clusters"] >= 1

    @pytest.mark.parametrize("nprobe", [3, 9])
    def test_search_on_card_equals_cpu(self, cuda, nprobe):
        q, it, ex = _data(Q=300, I=5000, d=32)
        cpu = IVFIndex.build(it, IVFConfig(nlist=9, nprobe=nprobe, seed=0), device="cpu")
        card = convert.ivf_index_from_numpy(cpu, device=cuda)
        s0, i0 = cpu.search(q, 50, exclude=ex)
        s1, i1 = card.search(q, 50, exclude=ex)
        np.testing.assert_allclose(s1, s0, rtol=1e-5, atol=1e-6)
        for r, c in zip(*np.nonzero(i1 != i0)):  # only inside exact-score near-ties
            assert np.sum(np.abs(s0[r] - s0[r, c]) <= 1e-5 * max(1.0, abs(s0[r, c]))) > 1
        assert card.last_candidates_scored == cpu.last_candidates_scored
        qi, iti, _ = _data(Q=64, I=3000, d=6, int_valued=True)
        cpu = IVFIndex.build(iti, IVFConfig(nlist=9, nprobe=nprobe, seed=0), device="cpu")
        card = convert.ivf_index_from_numpy(cpu, device=cuda)
        for a, b in zip(card.search(qi, 40), cpu.search(qi, 40)):
            np.testing.assert_array_equal(a, b)

    def test_dispatch_does_not_sync(self, cuda):
        q, it, ex = _data(Q=200, I=4000, d=32)
        idx = IVFIndex.build(it, IVFConfig(nlist=16, nprobe=4, seed=0), device=cuda)
        want = idx.search(q, 20, exclude=ex)  # builds and loads the kernel
        plan = idx.plan(20, len(q), ex.shape[1])
        dq, dex = tivf.to_device(q, cuda), tivf.to_device(ex, cuda)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            s, i, _ = idx.dispatch(dq, dex, plan)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        np.testing.assert_array_equal(i.cpu().numpy(), want[1])
        np.testing.assert_array_equal(s.cpu().numpy(), want[0])
