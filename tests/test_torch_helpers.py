"""The port's public helpers against ``repro``'s: the graph accessors, the
device batches, ``encode_all_nodes``, ``evaluate_recall_bruteforce``, the
legacy and parity flags, ``all_pairs``, ``abstract_params``, the oracles
``inbatch_loss_ref`` and ``flash_attention_ref``, and
``examples/quickstart_torch.py``.

Tolerances as the conformance record's: embeddings to rtol 1e-5 / atol 1e-6,
numpy values and ids exactly (the recall oracle is the same numpy code in
both packages).
"""
import dataclasses
import math
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.core as jcore
import repro.embedding as jemb
import repro.graph as jgraph
from repro.kernels import ref as jref
from repro_torch import configs as tconfigs
from repro_torch import core as tcore
from repro_torch import embedding as temb
from repro_torch import graph as tgraph
from repro_torch.core import gnn as tgnn
from repro_torch.kernels import ref as tref
from repro_torch.sampling import EgoConfig, PairConfig, PipelineConfig, make_train_sampler
from repro_torch.sampling import fused as tfused
from repro_torch.walk import WalkConfig
from test_torch_model import RELS, _cfgs

pytestmark = pytest.mark.quick

RTOL, ATOL = 1e-5, 1e-6
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tds():
    return tgraph.generate(tgraph.TOY, seed=0)


def _flat(jcfg, seed=7):
    return {k: np.asarray(v) for k, v in
            jcore.init_model_params(jax.random.PRNGKey(seed), jcfg).items()}


# -------------------------------------------------------------------- graph
def test_node_types_match_repro(toy_ds, tds):
    jg, tg = toy_ds.graph, tds.graph
    for ntype in jg.node_type_ranges:
        np.testing.assert_array_equal(tg.nodes_of_type(ntype), jg.nodes_of_type(ntype))
        assert tg.nodes_of_type(ntype).dtype == np.int64
    for node in (0, jg.num_nodes // 3, toy_ds.num_users - 1, toy_ds.num_users,
                 jg.num_nodes - 1):
        assert tg.node_type_of(node) == jg.node_type_of(node)
    with pytest.raises(KeyError):
        tg.node_type_of(tg.num_nodes)


def test_slot_values_match_repro(toy_ds, tds):
    assert toy_ds.graph.slots, "TOY carries side-info slots"
    for name, jslot in toy_ds.graph.slots.items():
        tslot = tds.graph.slots[name]
        for node in range(0, tds.graph.num_nodes, 97):
            np.testing.assert_array_equal(tslot.values_of(node), jslot.values_of(node))


def test_global_ids_match_repro(toy_ds, tds):
    u = np.arange(0, toy_ds.num_users, 13)
    i = np.arange(0, toy_ds.num_items, 11)
    np.testing.assert_array_equal(tds.user_global(u), toy_ds.user_global(u))
    np.testing.assert_array_equal(tds.item_global(i), toy_ds.item_global(i))
    assert tds.item_global(np.array([0]))[0] == tds.num_users


# --------------------------------------------------------------------- core
@pytest.mark.parametrize("gnn", [True, False], ids=["lightgcn", "walk"])
def test_encode_all_nodes_matches_repro(toy_ds, tds, gnn):
    jcfg, tcfg = _cfgs(toy_ds.graph, walk=not gnn)
    flat = _flat(jcfg)
    want = jcore.encode_all_nodes(flat, jcfg, jgraph.DistributedGraphEngine(toy_ds.graph, 2),
                                  np.random.default_rng(4), toy_ds.graph, batch_size=200)
    got = tcore.encode_all_nodes({k: torch.from_numpy(v.copy()) for k, v in flat.items()}, tcfg,
                                 tgraph.DistributedGraphEngine(tds.graph, 2),
                                 np.random.default_rng(4), tds.graph, batch_size=200,
                                 device="cpu")
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_evaluate_recall_bruteforce_matches_repro(trained_embeddings, toy_ds):
    ue, ie, train_pairs = trained_embeddings
    kw = dict(top_k=20, top_n=5, max_users=60, seed=2)
    want = jcore.recall.evaluate_recall_bruteforce(ue, ie, train_pairs, toy_ds.test_pairs, **kw)
    got = tcore.recall.evaluate_recall_bruteforce(ue, ie, train_pairs, toy_ds.test_pairs, **kw)
    assert got == want
    # the device path recommends the oracle's ids, so its metrics are the same
    assert tcore.evaluate_recall(ue, ie, train_pairs, toy_ds.test_pairs, method="device",
                                 device="cpu", **kw) == want


def _train_batch(ds, seed=0):
    pipe = PipelineConfig(walk=WalkConfig(metapaths=["u2click2i - i2click2u"], walk_len=6),
                          pair=PairConfig(win_size=2),
                          ego=EgoConfig(relations=list(RELS), fanouts=[4, 3]),
                          batch_pairs=64)
    return next(make_train_sampler(ds.graph, pipe, seed=seed).batches(1))


def test_device_batches_are_the_host_batches(toy_ds, tds):
    """``device_batch`` / ``sparse_device_batch``: the host pytree, moved;
    on the CPU the very values, equal to ``repro``'s host batch."""
    jcfg, tcfg = _cfgs(tds.graph, side_info=True)
    batch = _train_batch(tds)
    host = tcore.host_batch(tds.graph, batch, tcfg)
    dev = tcore.device_batch(tds.graph, batch, tcfg, device="cpu")
    jhost = jcore.host_batch(toy_ds.graph, batch, jcfg)
    for h, d, j in zip(jax.tree_util.tree_leaves(host), jax.tree_util.tree_leaves(dev),
                       jax.tree_util.tree_leaves(jhost)):
        assert isinstance(d, torch.Tensor) and d.device.type == "cpu"
        np.testing.assert_array_equal(d.numpy(), np.asarray(h))
        np.testing.assert_array_equal(np.asarray(h), np.asarray(j))
    buckets = {}
    sparse = tcore.sparse_device_batch(tds.graph, batch, tcfg, buckets, device="cpu")
    want = tcore.sparse_host_batch(tds.graph, batch, tcfg, dict(buckets))
    assert buckets  # the bucket widths are kept for the caller
    for d, h in zip(jax.tree_util.tree_leaves(sparse), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(d.numpy(), np.asarray(h))


def test_core_exports_match_repro_by_name():
    for name in ("host_batch", "sparse_host_batch", "loss_fn", "split_params",
                 "sparse_dense_split", "neg_sampling_loss", "inbatch_softmax_loss",
                 "inbatch_sigmoid_loss", "device_batch", "sparse_device_batch",
                 "encode_all_nodes"):
        assert callable(getattr(tcore, name)) and callable(getattr(jcore, name)), name


def test_use_kernel_aggregation_records_and_selects_nothing():
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.normal(size=(2, 3, 4, 8)).astype(np.float32))
    m = torch.from_numpy(rng.random((2, 3, 4)) < 0.5)
    before = tgnn.masked_mean(h, m)
    try:
        tgnn.use_kernel_aggregation(True)
        assert tgnn._USE_KERNEL_AGGR is True
        assert torch.equal(tgnn.masked_mean(h, m), before)
    finally:
        tgnn.use_kernel_aggregation(False)


# ------------------------------------------------------------------- config
def test_fused_config_keeps_use_kernel_pairs_and_selects_nothing(tds):
    """``repro``'s ``FusedConfig(use_kernel_pairs=False)`` builds in the port
    and gives the same fused batch as the default."""
    assert [f.name for f in dataclasses.fields(tfused.FusedConfig)] == \
        ["max_degree", "budget_mb", "use_kernel_pairs", "oversample"]
    pipe = PipelineConfig(walk=WalkConfig(metapaths=["u2click2i - i2click2u"], walk_len=6),
                          pair=PairConfig(win_size=2),
                          ego=EgoConfig(relations=list(RELS), fanouts=[4, 3]),
                          batch_pairs=64)
    on, off = (tfused.FusedSampler(tds.graph, pipe, seed=3, device="cpu",
                                   fused=tfused.FusedConfig(max_degree=4, use_kernel_pairs=k))
               for k in (True, False))
    draws = on.draw(torch.Generator().manual_seed(5))
    a, b = on.sample_from(draws), off.sample_from(draws)
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert la and len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def test_all_pairs_match_repro():
    assert tconfigs.all_pairs() == jconfigs.all_pairs()


def test_embedding_abstract_params_match_repro():
    cfg = dict(num_nodes=50, dim=8, slots=())
    jcfg = jemb.EmbeddingConfig(**cfg, dtype="bfloat16")
    tcfg = temb.EmbeddingConfig(**cfg, dtype="bfloat16")
    jcfg = dataclasses.replace(jcfg, slots=(jemb.SlotSpec("s0", 20, 3),))
    tcfg = dataclasses.replace(tcfg, slots=(temb.SlotSpec("s0", 20, 3),))
    want, got = jemb.abstract_params(jcfg), temb.abstract_params(tcfg)
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape and got[k].device.type == "meta"
        assert str(got[k].dtype).replace("torch.", "") == str(want[k].dtype)


# ------------------------------------------------------------------ oracles
def test_inbatch_loss_ref_matches_repro():
    rng = np.random.default_rng(1)
    s, d = (rng.normal(size=(37, 16)).astype(np.float32) for _ in range(2))
    got = tref.inbatch_loss_ref(torch.from_numpy(s), torch.from_numpy(d), 0.5)
    want = jref.inbatch_loss_ref(jnp.asarray(s), jnp.asarray(d), 0.5)
    assert got.shape == ()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_flash_attention_ref_matches_repro():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 9, 6, 8)).astype(np.float32)
    k, v = (rng.normal(size=(2, 9, 2, 8)).astype(np.float32) for _ in range(2))
    got = tref.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), True, 4)
    want = jref.flash_attention_ref(*(jnp.asarray(a) for a in (q, k, v)), True, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------------ example
def test_quickstart_torch_runs_on_the_cpu():
    sys.path.insert(0, str(REPO / "examples"))
    import quickstart_torch

    res = quickstart_torch.main(["--device", "cpu", "--steps", "3"])
    assert len(res.losses) == 3 and all(math.isfinite(x) for x in res.losses)
    assert set(res.eval_history[-1]) >= {"u2i", "icf", "ucf"}
