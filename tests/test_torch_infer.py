"""The serving slice end to end against ``repro``: full-graph inference and
recall evaluation on the CPU path of the port.

The egos are sampled from the same numpy stream in both packages, so the
embeddings agree to rtol 1e-5 / atol 1e-6; recall metrics agree exactly,
since both sides recommend the same ids.
"""
import jax
import numpy as np
import pytest

import repro.core.model as jmodel
import repro.graph as jgraph
from repro.core.recall import evaluate_recall as j_evaluate_recall
from repro.infer import embed_all_nodes as j_embed_all_nodes
from repro.infer import export_embeddings as j_export
from repro.infer import load_embeddings as j_load
from repro_torch import convert
from repro_torch import graph as tgraph
from repro_torch.core.recall import STRATEGIES, evaluate_recall
from repro_torch.infer import embed_all_nodes, export_embeddings, load_embeddings
from test_torch_model import _cfgs

pytestmark = pytest.mark.quick

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def tds():
    return tgraph.generate(tgraph.TOY, seed=0)


@pytest.mark.parametrize("side_info", [False, True])
def test_embed_all_nodes_matches_repro(toy_ds, tds, side_info):
    jcfg, tcfg = _cfgs(toy_ds.graph, "lightgcn", side_info=side_info)
    flat = {k: np.asarray(v) for k, v in
            jmodel.init_model_params(jax.random.PRNGKey(7), jcfg).items()}
    want = j_embed_all_nodes(flat, jcfg, jgraph.DistributedGraphEngine(toy_ds.graph, 2),
                             toy_ds.graph, batch_size=128, seed=3)
    model = convert.params_from_numpy(flat, tcfg, device="cpu")
    got = embed_all_nodes(model, tgraph.DistributedGraphEngine(tds.graph, 2), tds.graph,
                          batch_size=128, seed=3, device="cpu")
    assert got.shape == want.shape == (tds.graph.num_nodes, 16)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_embed_all_nodes_walk_based(toy_ds, tds):
    jcfg, tcfg = _cfgs(toy_ds.graph, walk=True)
    flat = {k: np.asarray(v) for k, v in
            jmodel.init_model_params(jax.random.PRNGKey(1), jcfg).items()}
    want = j_embed_all_nodes(flat, jcfg, toy_ds.graph, toy_ds.graph, batch_size=97)
    got = embed_all_nodes(convert.params_from_numpy(flat, tcfg, device="cpu"),
                          tds.graph, tds.graph, batch_size=97, device="cpu")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("top_k,top_n", [(100, 20), (7, 3)])
def test_evaluate_recall_device_matches_repro_bruteforce(trained_embeddings, toy_ds,
                                                         top_k, top_n):
    ue, ie, train_pairs = trained_embeddings
    want = j_evaluate_recall(ue, ie, train_pairs, toy_ds.test_pairs, top_k=top_k,
                             top_n=top_n, method="bruteforce")
    got = evaluate_recall(ue, ie, train_pairs, toy_ds.test_pairs, top_k=top_k,
                          top_n=top_n, method="device", user_chunk=50, device="cpu")
    assert got.keys() == want.keys()
    assert set(STRATEGIES) <= got.keys()
    assert got == want  # same ids -> identical metrics


def test_evaluate_recall_bruteforce_and_max_users(trained_embeddings, toy_ds):
    ue, ie, train_pairs = trained_embeddings
    kw = dict(top_k=20, max_users=40, seed=5)
    want = j_evaluate_recall(ue, ie, train_pairs, toy_ds.val_pairs,
                             method="bruteforce", **kw)
    assert evaluate_recall(ue, ie, train_pairs, toy_ds.val_pairs,
                           method="bruteforce", **kw) == want
    assert evaluate_recall(ue, ie, train_pairs, toy_ds.val_pairs, method="device",
                           device="cpu", **kw) == want


def test_ivf_is_not_ported_yet(trained_embeddings, toy_ds):
    ue, ie, train_pairs = trained_embeddings
    with pytest.raises(NotImplementedError, match="later slice"):
        evaluate_recall(ue, ie, train_pairs, toy_ds.test_pairs, method="ivf")


def test_embedding_export_is_interchangeable(tmp_path):
    emb = np.random.default_rng(0).normal(size=(37, 8)).astype(np.float32)
    p1 = export_embeddings(str(tmp_path / "torch"), emb, num_shards=4,
                           meta={"model": np.bytes_("lightgcn")})
    np.testing.assert_array_equal(j_load(p1), emb)
    np.testing.assert_array_equal(load_embeddings(p1), emb)
    p2 = j_export(str(tmp_path / "jax"), emb, num_shards=3)
    np.testing.assert_array_equal(load_embeddings(p2), emb)
