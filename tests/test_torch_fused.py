"""The port's fused device sampler against ``repro``'s, from the same bits.

``repro``'s ``FusedSampler.sample(key)`` is a function of the bits its
``jax.random`` calls draw; the port splits that into ``draw`` and
``sample_from``. ``draws_from_jax_key`` rebuilds the port's draws from a
JAX key exactly as ``repro`` splits and draws it, so the padded adjacency,
the walks, the window pairs and whole batches are held BITWISE (ids are
ids), and one fused training step to rtol 1e-5 / atol 1e-6 (the two
frameworks sum in other orders). The port's own ``sample(generator)`` is
held against the port's host pipeline the way ``tests/test_fused_sampling.py``
holds ``repro``'s: support sets, a chi-square bound on the pair
distribution, per-center ego children, PAD propagation, and the trainer's
fused, fallback and auto plans. The ``window_pairs`` kernel itself runs on
the card only (``cuda`` marker).
"""
import ctypes
import dataclasses
import logging
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.model as jmodel
from repro.graph import TOY as JTOY
from repro.graph import generate as jgenerate
from repro.graph.hetero_graph import HeteroGraph as JGraph
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.sampling import fused as jfused
from repro.sampling.pairs import window_positions as jwindow_positions
from repro.train import Graph4RecTrainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro.walk.metapath import jax_walk, jax_walk_multi
from repro_torch import convert
from repro_torch.core import model as tmodel
from repro_torch.embedding import SlotSpec as TSlot
from repro_torch.graph import TOY as TTOY
from repro_torch.graph import generate as tgenerate
from repro_torch.graph.hetero_graph import HeteroGraph as TGraph
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.sampling import SamplePipeline as TPipeline
from repro_torch.sampling import make_train_sampler, sample_ego_batch
from repro_torch.sampling import fused as tfused
from repro_torch.sampling.pairs import window_pairs as twindow_pairs
from repro_torch.sampling.pairs import window_positions as twindow_positions
from repro_torch.train import Graph4RecTrainer as TTrainer
from repro_torch.train import TrainerConfig as TTrainerConfig
from repro_torch.walk import walk_from_bits, walk_multi_from_bits
from repro.embedding import SlotSpec as JSlot
from test_fused_sampling import chi2_two_sample
from test_torch_model import _cfgs
from test_torch_sampling import METAPATHS, RELS, _pipes

pytestmark = pytest.mark.quick

PAD = -1
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def both():
    return jgenerate(JTOY, seed=0), tgenerate(TTOY, seed=0)


@pytest.fixture(autouse=True)
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def dense_bipartite(Graph, n_u=6, n_i=5, drop=()):
    """Small dense u<->i graph in one package; ``drop`` users have no edges."""
    src = [u for u in range(n_u) if u not in drop for _ in range(n_i)]
    dst = [i for u in range(n_u) if u not in drop for i in range(n_i)]
    return Graph.from_edges({"u": n_u, "i": n_i},
                            {"u2click2i": (np.array(src, np.int64), np.array(dst, np.int64))},
                            symmetry=True)


def _bits(key, shape) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jax.random.bits(key, shape, jnp.uint32)).astype(np.int64))


def draws_from_jax_key(tfs: tfused.FusedSampler, key) -> tfused.FusedDraws:
    """The port's draws holding the very bits ``repro``'s ``sample(key)``
    draws: ``split(key, 8)`` in ``repro``'s order, walk bits (max(L-1,1), W),
    ego bits per hop from ``fold_in(part key, hop)``, and the ``randint``
    negatives as ids (``repro/sampling/fused.py:320-374``)."""
    cfg = tfs.config
    P, W = cfg.batch_pairs, tfs.num_walks
    k_path, k_start, k_walk, k_sel, k_neg, k_se, k_de, k_ne = jax.random.split(key, 8)
    part_key = {"shared": k_se, "src": k_se, "dst": k_de, "neg": k_ne}
    ego = {name: [_bits(jax.random.fold_in(part_key[name], hop), shape)
                  for hop, shape in enumerate(tfs.ego_bits_shapes(n))]
           for name, n in tfs._ego_parts().items()}
    neg = None
    if cfg.pair.neg_mode == "random":
        neg = torch.from_numpy(np.asarray(jax.random.randint(
            k_neg, (P, cfg.pair.num_negatives), 0, tfs.graph.num_nodes,
            dtype=jnp.int32)).astype(np.int64))
    return tfused.FusedDraws(
        path=_bits(k_path, (W,)), start=_bits(k_start, (W,)),
        walk=_bits(k_walk, (max(cfg.walk.walk_len - 1, 1), W)), sel=_bits(k_sel, (P,)),
        ego=ego, neg=neg)


def _assert_same_ids(a, b, path="batch"):
    """Equal values in two pytrees (jax arrays vs torch tensors); ids may be
    int32 on one side and int64 on the other, floats must match bitwise."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (path, a.keys(), b.keys())
        for k in a:
            _assert_same_ids(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_ids(x, y, f"{path}[{i}]")
    elif a is None:
        assert b is None, path
    else:
        x, y = np.asarray(a), b.numpy()
        assert x.shape == y.shape and x.dtype.kind == y.dtype.kind, (path, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=path)


# --------------------------------------------------------- padded adjacency
@pytest.mark.parametrize("seed", [0, 1])
def test_padded_adjacency_bitwise(both, seed):
    jg, tg = both[0].graph, both[1].graph
    assert tg.relation_names() == jg.relation_names()
    for rel in jg.relation_names():
        assert (np.asarray(jg.degrees(rel)) > 3).any(), rel  # the subsample runs
        ja, jd = jg.padded_adjacency(rel, 3, seed=seed)
        ta, td = tg.padded_adjacency(rel, 3, seed=seed)
        assert ta.dtype == ja.dtype and td.dtype == jd.dtype
        np.testing.assert_array_equal(ta, ja, err_msg=rel)
        np.testing.assert_array_equal(td, jd, err_msg=rel)


# ------------------------------------------------------------- window pairs
@pytest.mark.parametrize("B,L,win", [(1, 4, 2), (7, 6, 2), (33, 5, 4), (300, 6, 2), (65, 8, 3)])
def test_window_pair_ids_ref_matches_repro(B, L, win):
    rng = np.random.default_rng(B * L + win)
    paths = rng.integers(0, 50, size=(B, L)).astype(np.int32)
    for b in range(B):  # random PAD suffixes, all-PAD rows among them
        paths[b, rng.integers(0, L + 1):] = PAD
    paths[0] = PAD
    pos = twindow_positions(L, win)
    np.testing.assert_array_equal(pos, jwindow_positions(L, win))
    got = tops.window_pair_ids(torch.from_numpy(paths), torch.from_numpy(pos.astype(np.int32)))
    got_ref = tref.window_pair_ids_ref(torch.from_numpy(paths), torch.from_numpy(pos))
    want_ref = jref.window_pair_ids_ref(jnp.asarray(paths), pos)
    want_pallas = jops.window_pair_ids(jnp.asarray(paths), pos)  # interpret mode
    for g, gr, wr, wp in zip(got, got_ref, want_ref, want_pallas):
        assert g.dtype == torch.int32 and g.shape == (B, len(pos))
        np.testing.assert_array_equal(g.numpy(), np.asarray(wr))
        np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
        np.testing.assert_array_equal(g.numpy(), np.asarray(wp))


def test_window_pair_ids_support_matches_host_pairs():
    """Every non-PAD (row, src_col, dst_col) of the gather is a host window
    pair and vice versa, interior PADs included."""
    rng = np.random.default_rng(0)
    paths = rng.integers(0, 9, size=(12, 6))
    paths[paths % 4 == 0] = PAD
    pos = twindow_positions(6, 2)
    s, _ = tops.window_pair_ids(torch.from_numpy(paths), torch.from_numpy(pos))
    s = s.numpy()
    got = {(r, int(pos[p, 0]), int(pos[p, 1]))
           for r in range(12) for p in range(len(pos)) if s[r, p] != PAD}
    assert got == {tuple(map(int, row)) for row in twindow_pairs(paths, 2)}


# ------------------------------------------------------------------ walker
def _walk_tables(Graph, max_degree=3):
    g = dense_bipartite(Graph, n_u=7, n_i=5, drop=(2, 5))
    rels = sorted(g.relation_names())
    adj, deg = zip(*(g.padded_adjacency(r, max_degree, seed=1) for r in rels))
    return g, rels, np.stack(adj).astype(np.int32), np.stack(deg).astype(np.int32)


@pytest.mark.parametrize("walk_len", [2, 3, 5, 8])
def test_walk_multi_from_bits_matches_jax_walk_multi(walk_len):
    g, rels, adj, deg = _walk_tables(JGraph)
    B = 40
    rng = np.random.default_rng(walk_len)
    starts = rng.integers(0, g.num_nodes, size=B).astype(np.int32)
    starts[:4] = PAD
    starts[4:8] = [2, 5, 2, 5]  # degree-0 users
    # two metapaths: u->i->u... and i->u->i...
    sched = np.array([[rels.index("u2click2i"), rels.index("i2click2u")] * 4,
                      [rels.index("i2click2u"), rels.index("u2click2i")] * 4],
                     np.int32)[:, : max(walk_len - 1, 1)]
    path_of = rng.integers(0, 2, size=B).astype(np.int32)
    key = jax.random.PRNGKey(walk_len)
    want = jax_walk_multi(key, jnp.asarray(adj), jnp.asarray(deg), jnp.asarray(starts),
                          jnp.asarray(sched), jnp.asarray(path_of), walk_len)
    got = walk_multi_from_bits(_bits(key, (max(walk_len - 1, 1), B)), torch.from_numpy(adj),
                               torch.from_numpy(deg), torch.from_numpy(starts),
                               torch.from_numpy(sched), torch.from_numpy(path_of), walk_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    out = got.numpy()
    assert (out[:4] == PAD).all()
    if walk_len > 1:
        assert (out[4:8, 1:] == PAD).all()
    for row in out:  # PAD is suffix-only
        pads = np.flatnonzero(row == PAD)
        assert (pads.size == 0) or (row[pads[0]:] == PAD).all()


def test_walk_from_bits_matches_jax_walk():
    g, rels, adj, deg = _walk_tables(JGraph)
    r = rels.index("u2click2i")
    key = jax.random.PRNGKey(9)
    starts = np.arange(-1, g.num_nodes, dtype=np.int32)
    want = jax_walk(key, jnp.asarray(adj[r]), jnp.asarray(deg[r]), jnp.asarray(starts), 4)
    got = walk_from_bits(_bits(key, (3, len(starts))), torch.from_numpy(adj[r]),
                         torch.from_numpy(deg[r]), torch.from_numpy(starts), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ whole batches
def _slots(Slot, mode):
    if mode is None:
        return (), ()
    specs = (Slot("slot0", 64, 3), Slot("slot1", 64, 3))
    return (specs, ()) if mode == "values" else ((), specs)


SAMPLE_CASES = {
    "walk_ego_pair-values": dict(order="walk_ego_pair", slots="values"),
    "walk_ego_pair-bag-random": dict(order="walk_ego_pair", slots="bag", neg_mode="random"),
    "walk_pair_ego-bag": dict(order="walk_pair_ego", slots="bag"),
    "walk_pair_ego-values-random": dict(order="walk_pair_ego", slots="values",
                                        neg_mode="random"),
    "walk-values": dict(gnn=False, slots="values"),
    "walk-random": dict(gnn=False, slots=None, neg_mode="random"),
}


def _samplers(jg, tg, order="walk_ego_pair", slots=None, neg_mode="inbatch", gnn=True,
              max_degree=4, seed=3, metapaths=METAPATHS):
    jpc, tpc = (dataclasses.replace(pc, walk=dataclasses.replace(pc.walk,
                                                                 metapaths=list(metapaths)))
                for pc in _pipes(order=order, neg_mode=neg_mode, gnn=gnn))
    jv, jb = _slots(JSlot, slots)
    tv, tb = _slots(TSlot, slots)
    jfs = jfused.FusedSampler(jg, jpc, value_slots=jv, bag_slots=jb,
                              fused=jfused.FusedConfig(max_degree=max_degree), seed=seed)
    tfs = tfused.FusedSampler(tg, tpc, value_slots=tv, bag_slots=tb,
                              fused=tfused.FusedConfig(max_degree=max_degree), seed=seed,
                              device="cpu")
    return jfs, tfs


@pytest.mark.parametrize("case", list(SAMPLE_CASES))
def test_sample_from_bitwise_matches_repro(both, case):
    jfs, tfs = _samplers(both[0].graph, both[1].graph, **SAMPLE_CASES[case])
    assert tfs.num_walks == jfs.num_walks
    np.testing.assert_array_equal(tfs._adj.numpy(), np.asarray(jfs._adj))
    np.testing.assert_array_equal(tfs._deg.numpy(), np.asarray(jfs._deg))
    assert tfs.device_table_bytes() == jfs.device_table_bytes()
    sample = jax.jit(jfs.sample)
    for i in range(3):
        key = jax.random.PRNGKey(11 + i)
        _assert_same_ids(sample(key), tfs.sample_from(draws_from_jax_key(tfs, key)))


@pytest.mark.parametrize("order", ["walk_ego_pair", "walk_pair_ego"])
def test_all_dead_round_bitwise_and_pad(order):
    jg = dense_bipartite(JGraph, n_u=4, n_i=3, drop=(0, 1, 2, 3))
    tg = dense_bipartite(TGraph, n_u=4, n_i=3, drop=(0, 1, 2, 3))
    jfs, tfs = _samplers(jg, tg, order=order, metapaths=("u2click2i - i2click2u",))
    key = jax.random.PRNGKey(0)
    got = tfs.sample_from(draws_from_jax_key(tfs, key))
    _assert_same_ids(jax.jit(jfs.sample)(key), got)
    parts = [got["shared"]] if "shared" in got else [got["src"], got["dst"]]
    for levels, _ in parts:
        for lvl in levels:
            assert (lvl == PAD).all()


def test_eligibility_matches_repro(both):
    jpc, tpc = _pipes()
    for md in (4, 32):
        assert tfused.fused_device_bytes(both[1].graph, tpc, max_degree=md) == \
            jfused.fused_device_bytes(both[0].graph, jpc, max_degree=md)
    for budget in (1e-4, 256.0):
        assert tfused.fused_eligibility(both[1].graph, tpc,
                                        fused=tfused.FusedConfig(budget_mb=budget)) == \
            jfused.fused_eligibility(both[0].graph, jpc,
                                     fused=jfused.FusedConfig(budget_mb=budget))


def test_make_train_sampler_fused_backend(both):
    _, tpc = _pipes()
    fs = make_train_sampler(both[1].graph, tpc, backend="fused", seed=2, device="cpu")
    assert isinstance(fs, tfused.FusedSampler) and fs.seed == 2
    with pytest.raises(ValueError, match="unknown sampling backend"):
        make_train_sampler(both[1].graph, tpc, backend="device")


# -------------------------------------------------------------- fused step
STEP_CASES = {
    "lightgcn-bag": dict(gnn_type="lightgcn", side_info=True),
    "gcn": dict(gnn_type="gcn"),  # GNN weights: Adam moves
}


def _fused_trainers(both, case, **kw):
    jmc, tmc = _cfgs(both[0].graph, **STEP_CASES[case])
    jpc, tpc = _pipes()
    common = dict(num_steps=8, log_every=0, seed=0, sparse_lr=0.5, dense_lr=1e-2,
                  prefetch_batches=0, eval_at_end=False, auto_backend=False,
                  sampling_backend="fused", fused_max_degree=8)
    common.update(kw)
    jt = JTrainer(both[0], both[0].graph, jmc, jpc, JTrainerConfig(**common))
    tt = TTrainer(both[1], both[1].graph, tmc, tpc, TTrainerConfig(**common), device="cpu")
    return jt, tt


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_fused_step_matches_repro(both, case):
    jt, tt = _fused_trainers(both, case)
    init = {k: np.asarray(v) for k, v in jt.init_params().items()}
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    tp = tt.init_params(init)
    js, ts = jt.opt.init(jp), tt.opt.init(tp)
    for i in range(2):  # two steps: Adam's bias correction moves
        key = jax.random.PRNGKey(21 + i)
        jp, js, jloss = jt._fused_step(jp, js, key)
        tp, ts, tloss = tt._fused_step(tp, ts, draws_from_jax_key(tt._fused_sampler, key))
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=RTOL, atol=ATOL)
    assert tp.keys() == jp.keys()
    for k in tp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, js))
    got = jax.tree_util.tree_leaves(convert.state_to_numpy(ts))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


# ------------------------------------------------- the port's own sampling
def _pair_counts_host(g, pc, num_batches, seed):
    counts = np.zeros(g.num_nodes * g.num_nodes, np.int64)
    for b in TPipeline(g, pc, seed=seed).batches(num_batches):
        np.add.at(counts, b.src_ids * g.num_nodes + b.dst_ids, 1)
    return counts


def _pair_counts_fused(fs, num_batches, seed):
    n = fs.graph.num_nodes
    gen = torch.Generator().manual_seed(seed)
    counts = np.zeros(n * n, np.int64)
    for _ in range(num_batches):
        batch = fs.sample(gen)
        if "shared" in batch:  # shared towers: level 0 carries the centers
            centers = batch["shared"][0][0][:, 0]
            src, dst = centers[batch["src_sel"]], centers[batch["dst_sel"]]
        else:
            src, dst = batch["src"][0], batch["dst"][0]
            if fs.ego is not None:
                src, dst = src[0][:, 0], dst[0][:, 0]
        src, dst = src.numpy(), dst.numpy()
        ok = src >= 0
        np.add.at(counts, src[ok] * n + dst[ok], 1)
    return counts


def _small_pipe(metapaths=("u2click2i - i2click2u",), ego=None, order="walk_ego_pair"):
    _, tpc = _pipes(order=order)
    return dataclasses.replace(
        tpc, walk=dataclasses.replace(tpc.walk, metapaths=list(metapaths), walk_len=5),
        ego=ego, batch_pairs=64, walks_per_round=32)


def test_own_sample_support_set_equals_host_pairs():
    g = dense_bipartite(TGraph)
    pc = _small_pipe()
    host = _pair_counts_host(g, pc, 40, seed=0)
    fused = _pair_counts_fused(tfused.FusedSampler(g, pc, device="cpu"), 40, seed=0)
    assert set(np.flatnonzero(host)) == set(np.flatnonzero(fused))


@pytest.mark.parametrize("metapaths,drop", [
    (("u2click2i - i2click2u",), ()),
    (("u2click2i - i2click2u", "i2click2u - u2click2i"), ()),
    (("u2click2i - i2click2u",), (2, 5)),
], ids=["one-metapath", "two-metapaths", "dead-ends"])
def test_own_sample_pair_distribution_matches_host(metapaths, drop):
    g = dense_bipartite(TGraph, n_u=7, drop=drop)
    pc = _small_pipe(metapaths)
    host = _pair_counts_host(g, pc, 120, seed=1)
    fused = _pair_counts_fused(tfused.FusedSampler(g, pc, device="cpu"), 120, seed=2)
    for dead in drop:
        assert fused.reshape(g.num_nodes, -1)[dead].sum() == 0
        assert fused.reshape(g.num_nodes, -1)[:, dead].sum() == 0
    assert chi2_two_sample(host, fused)


@pytest.mark.parametrize("order", ["walk_ego_pair", "walk_pair_ego"])
def test_own_ego_child_distribution_per_center(order):
    from repro_torch.sampling import EgoConfig

    g = dense_bipartite(TGraph)
    ego = EgoConfig(relations=list(RELS), fanouts=[3, 2])
    fs = tfused.FusedSampler(g, _small_pipe(ego=ego, order=order), device="cpu")
    centers = np.arange(g.num_nodes, dtype=np.int64)
    reps = 60
    rng = np.random.default_rng(0)
    host = np.stack([sample_ego_batch(rng, g, centers, ego).levels[1] for _ in range(reps)])
    gen = torch.Generator().manual_seed(1)
    fused = []
    for _ in range(reps):
        bits = [torch.randint(0, 2**32, s, generator=gen, dtype=torch.int64)
                for s in fs.ego_bits_shapes(len(centers))]
        fused.append(fs._ego_levels(bits, torch.from_numpy(centers))[1].numpy())
    R, F = len(RELS), 3
    hc = host.reshape(reps, len(centers), R, F)
    fc = np.stack(fused).reshape(reps, len(centers), R, F)

    def counts(children):
        c = np.zeros(g.num_nodes + 1, np.int64)  # last slot counts PAD
        ch = children.reshape(-1)
        np.add.at(c, np.where(ch >= 0, ch, g.num_nodes), 1)
        return c

    for v in centers:
        for ri in range(R):
            assert chi2_two_sample(counts(hc[:, v, ri]), counts(fc[:, v, ri])), (v, ri)


def test_own_ego_pad_and_degree0_centers_propagate_pad():
    from repro_torch.sampling import EgoConfig

    g = dense_bipartite(TGraph, n_u=6, drop=(3,))
    ego = EgoConfig(relations=["u2click2i"], fanouts=[2, 2])
    fs = tfused.FusedSampler(g, _small_pipe(ego=ego), device="cpu")
    gen = torch.Generator().manual_seed(0)
    bits = [torch.randint(0, 2**32, s, generator=gen, dtype=torch.int64)
            for s in fs.ego_bits_shapes(3)]
    levels = fs._ego_levels(bits, torch.tensor([3, PAD, 6]))  # dead u, PAD, item
    assert (levels[1] == PAD).all() and (levels[2] == PAD).all()


# ----------------------------------------------------------------- trainer
def _port_trainer(ds, backend, steps, **kw):
    _, tmc = _cfgs(ds.graph)
    _, tpc = _pipes()
    tpc = dataclasses.replace(tpc, batch_pairs=128)
    kw = {"prefetch_batches": 0, **kw}
    cfg = TTrainerConfig(num_steps=steps, log_every=0, eval_at_end=False, sparse_lr=1.0,
                         seed=0, sampling_backend=backend, **kw)
    return TTrainer(ds, ds.graph, tmc, tpc, cfg, device="cpu")


def test_fused_trainer_deterministic_per_seed(both):
    r1 = _port_trainer(both[1], "fused", 8).train()
    r2 = _port_trainer(both[1], "fused", 8).train()
    assert r1.plan["sampling"] == "fused" and r1.plan["prefetch"] == 0
    assert r1.plan["fused_measured_bytes"] > 0
    assert r1.losses == r2.losses and len(r1.losses) == 8
    assert r1.pairs_seen == 8 * 128
    for k in r1.params:
        assert torch.equal(r1.params[k], r2.params[k])


def test_fused_loss_trajectory_statistically_matches_host(both):
    """Fused training tracks the host pipeline: same model and seed,
    independent sampling streams; the tail means agree within 6 sigma of
    the run-to-run noise (``tests/test_fused_sampling.py``'s bound)."""
    tails = {}
    for backend in ("host", "fused"):
        res = _port_trainer(both[1], backend, 80).train()
        assert res.plan["sampling"] == backend
        assert len(res.losses) == 80 and np.isfinite(res.losses).all()
        tails[backend] = np.asarray(res.losses[-20:])
    scale = max(tails["host"].std(), tails["fused"].std(), 1e-3)
    assert abs(tails["host"].mean() - tails["fused"].mean()) < 6 * scale


def test_over_budget_falls_back_to_host(both, caplog):
    with caplog.at_level(logging.WARNING, logger="repro_torch.train"):
        tr = _port_trainer(both[1], "fused", 3, fused_budget_mb=0.0001)
    assert tr._fused_sampler is None
    assert any("falling back to the host pipeline" in r.message for r in caplog.records)
    res = tr.train()
    assert res.plan["sampling"] == "host" and len(res.losses) == 3


def test_auto_plan_measures_the_fused_step(both):
    tr = _port_trainer(both[1], "auto", 4, calibrate_min_steps=2, auto_backend=True)
    res = tr.train()
    assert res.plan["calibrated"]
    assert res.plan["measurements"]["fused_step_s"] > 0
    assert res.plan["sampling"] in ("host", "fused")
    # the calibration draws from its own generator: an explicit fused run of
    # the same seed trains identically when auto picks fused
    if res.plan["sampling"] == "fused":
        assert res.losses == _port_trainer(both[1], "fused", 4).train().losses


_LIBC = ctypes.PyDLL(None)  # calls through PyDLL keep the GIL (CDLL's let go of it)


def _hold_gil(seconds: float) -> None:
    """Sleep ``seconds`` of wall time without letting go of the GIL: no
    other thread of the process runs Python meanwhile."""
    _LIBC.usleep(int(seconds * 1e6))


def _paced_plan(ds, producer_wait) -> dict:
    """The plan of an "auto" trainer whose costs are all set by sleeps: each
    host batch (one real batch, repeated) ``producer_wait``s 50 ms in the
    prefetch thread, each host step holds the GIL for 50 ms, each fused
    step for 70 ms (the steps compute nothing, so the machine's load shifts
    no comparison). Pipelined host steps then take about 50 ms if the
    producer's wait lets go of the GIL, 100 ms if it holds it."""
    tr = _port_trainer(ds, "auto", 64, calibrate_min_steps=2, auto_backend=True,
                       prefetch_batches=None)
    pipe = make_train_sampler(tr.engine, tr.pipe_cfg, backend="host", seed=0)
    item = next(tr._host_batches(pipe, 1))

    def batches(pipeline, num):
        for _ in range(num):
            producer_wait(0.05)
            yield item

    def step(p, st, batch, cost=0.05):
        _hold_gil(cost)
        return p, st, torch.zeros(())

    tr._host_batches, tr._step_fn = batches, lambda: step
    tr._fused_step = lambda p, st, draws: step(p, st, draws, cost=0.07)
    plan = tr._resolve_plan(tr.init_params())
    assert plan["calibrated"]
    return plan


def test_auto_plan_picks_fused_when_the_gil_slows_pipelined_steps(both):
    """C5: the host batch (50 ms) and the host step (50 ms) are each faster
    than the fused step (70 ms) alone, but both hold the GIL, so pipelined
    host steps take about 100 ms. The plan measures that and says fused."""
    plan = _paced_plan(both[1], _hold_gil)
    m = plan["measurements"]
    assert max(m["host_batch_s"], m["step_s"]) < m["fused_step_s"] < m["pipelined_step_s"]
    assert plan["sampling"] == "fused" and plan["prefetch"] == 0, plan


def test_auto_plan_keeps_the_host_when_pipelined_steps_win(both):
    """The converse: the producer's 50 ms wait lets go of the GIL, so
    pipelined host steps overlap it with the step (about 50 ms) and beat the
    fused step (70 ms); serial steps (100 ms) would not."""
    plan = _paced_plan(both[1], time.sleep)
    m = plan["measurements"]
    assert m["pipelined_step_s"] < m["fused_step_s"] < m["host_batch_s"] + m["step_s"]
    assert plan["sampling"] == "host" and plan["prefetch"] == 2, plan


def test_unknown_sampling_backend_raises(both):
    with pytest.raises(ValueError, match="sampling_backend"):
        _port_trainer(both[1], "device", 3)


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the window_pairs kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
class TestOnCard:
    @pytest.mark.parametrize("B,L,win", [(57, 6, 2), (1000, 6, 2), (513, 32, 5)])
    def test_window_pairs_kernel_matches_plain(self, cuda, B, L, win):
        from repro_torch.kernels.window_pairs import window_pair_ids_cuda

        rng = np.random.default_rng(B)
        paths = rng.integers(0, 1 << 20, size=(B, L)).astype(np.int32)
        for b in range(B):
            paths[b, rng.integers(0, L + 1):] = PAD
        paths[::7] = PAD  # all-PAD rows
        pos = torch.from_numpy(twindow_positions(L, win).astype(np.int32)).to(cuda)
        p = torch.from_numpy(paths).to(cuda)
        got = window_pair_ids_cuda(p, pos)
        want = tref.window_pair_ids_ref(p, pos)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)

    def test_fused_sample_on_card_equals_cpu_without_syncs(self, cuda, both):
        _, tpc = _pipes(order="walk_ego_pair")
        kw = dict(value_slots=(TSlot("slot0", 64, 3),), seed=1)
        cpu = tfused.FusedSampler(both[1].graph, tpc, device="cpu", **kw)
        card = tfused.FusedSampler(both[1].graph, tpc, device=cuda, **kw)
        draws = cpu.draw(torch.Generator().manual_seed(0))
        draws_card = draws.to(cuda)  # a blocking H2D copy: outside the guard
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = card.sample_from(draws_card)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        want = cpu.sample_from(draws)
        flat_g, flat_w = [], []
        for tree, out in ((got, flat_g), (want, flat_w)):
            stack = [tree]
            while stack:
                t = stack.pop()
                if isinstance(t, dict):
                    stack.extend(t[k] for k in sorted(t))
                elif isinstance(t, (list, tuple)):
                    stack.extend(t)
                elif t is not None:
                    out.append(t)
        assert len(flat_g) == len(flat_w)
        for g, w in zip(flat_g, flat_w):
            assert torch.equal(g.cpu(), w)
