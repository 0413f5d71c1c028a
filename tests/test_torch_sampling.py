"""The port's host training pipeline against ``repro``'s, bitwise.

Both packages generate the TOY graph from one seed and draw the same
``np.random.Generator`` stream, so walks, window pairs, pipeline batches
(both orders, both negative modes), the unique-id helpers and the host batch
pytrees (dense and sparse) must be identical arrays, not close ones.
"""
import numpy as np
import pytest
import torch

import repro.core.model as jmodel
from repro.embedding import table as jtable
from repro.graph import DistributedGraphEngine as JEngine
from repro.graph import TOY as JTOY
from repro.graph import generate as jgenerate
from repro.sampling import EgoConfig as JEgo
from repro.sampling import PairConfig as JPair
from repro.sampling import PipelineConfig as JPipe
from repro.sampling import pairs as jpairs
from repro.sampling.pipeline import SamplePipeline as JPipeline
from repro.walk import MetapathWalker as JWalker
from repro.walk import WalkConfig as JWalk
from repro.walk import parse_metapath as jparse
from repro_torch.core import model as tmodel
from repro_torch.embedding import table as ttable
from repro_torch.graph import TOY as TTOY
from repro_torch.graph import DistributedGraphEngine as TEngine
from repro_torch.graph import generate as tgenerate
from repro_torch.sampling import EgoConfig as TEgo
from repro_torch.sampling import PairConfig as TPair
from repro_torch.sampling import PipelineConfig as TPipe
from repro_torch.sampling import SamplePipeline as TPipeline
from repro_torch.sampling import make_train_sampler
from repro_torch.sampling import pairs as tpairs
from repro_torch.walk import MetapathWalker as TWalker
from repro_torch.walk import WalkConfig as TWalk
from repro_torch.walk import parse_metapath as tparse
from test_torch_model import _cfgs

pytestmark = pytest.mark.quick

RELS = ("u2click2i", "i2click2u")
METAPATHS = ["u2click2i - i2click2u", "u2buy2i - i2buy2u"]


@pytest.fixture(scope="module")
def both():
    """(repro dataset, port dataset), TOY from seed 0."""
    return jgenerate(JTOY, seed=0), tgenerate(TTOY, seed=0)


def _pipes(order="walk_ego_pair", neg_mode="inbatch", gnn=True):
    out = []
    for Walk, Pair, Ego, Pipe in ((JWalk, JPair, JEgo, JPipe), (TWalk, TPair, TEgo, TPipe)):
        out.append(Pipe(
            walk=Walk(metapaths=METAPATHS, walk_len=6),
            pair=Pair(win_size=2, neg_mode=neg_mode, num_negatives=3),
            ego=Ego(relations=list(RELS), fanouts=[4, 3]) if gnn else None,
            order=order, batch_pairs=64, walks_per_round=16,
        ))
    return out


def _assert_tree_equal(a, b, path="batch"):
    """Bitwise equality of two pytrees of arrays (numpy, jax or torch)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    elif a is None:
        assert b is None, path
    else:
        x = np.asarray(a)
        y = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, (path, x.dtype, y.dtype,
                                                           x.shape, y.shape)
        np.testing.assert_array_equal(x, y, err_msg=path)


def _assert_batches_equal(jb, tb):
    for name in ("src_ids", "dst_ids", "neg_ids"):
        _assert_tree_equal(getattr(jb, name), getattr(tb, name), name)
    for name in ("src_ego", "dst_ego", "neg_ego"):
        je, te = getattr(jb, name), getattr(tb, name)
        assert (je is None) == (te is None), name
        if je is not None:
            _assert_tree_equal(je.levels, te.levels, name)


# ------------------------------------------------------------------- walks
def test_parse_metapath():
    assert tparse("u2click2i - i2click2u") == jparse("u2click2i - i2click2u")
    with pytest.raises(ValueError):
        tparse("u2click2i - u2click2i")


@pytest.mark.parametrize("engine", ["graph", "engine"])
def test_walker_paths_bitwise(both, engine):
    jds, tds = both
    jg = jds.graph if engine == "graph" else JEngine(jds.graph, num_partitions=3)
    tg = tds.graph if engine == "graph" else TEngine(tds.graph, num_partitions=3)
    jw = JWalker(jg, JWalk(metapaths=METAPATHS, walk_len=7))
    tw = TWalker(tg, TWalk(metapaths=METAPATHS, walk_len=7))
    jr, tr = np.random.default_rng(3), np.random.default_rng(3)
    for n in (1, 40, 101):
        np.testing.assert_array_equal(tw.generate(tr, n), jw.generate(jr, n))
    starts = np.arange(0, 50, 7)
    np.testing.assert_array_equal(tw.walk(tr, starts), jw.walk(jr, starts))


@pytest.mark.parametrize("walk_len,win", [(6, 2), (3, 5), (8, 1)])
def test_window_pairs_bitwise(both, walk_len, win):
    paths = JWalker(both[0].graph, JWalk(metapaths=METAPATHS, walk_len=walk_len)).generate(
        np.random.default_rng(0), 30)
    np.testing.assert_array_equal(tpairs.window_positions(walk_len, win),
                                  jpairs.window_positions(walk_len, win))
    tp, jp = tpairs.window_pairs(paths, win), jpairs.window_pairs(paths, win)
    np.testing.assert_array_equal(tp, jp)
    for a, b in zip(tpairs.pairs_to_nodes(paths, tp), jpairs.pairs_to_nodes(paths, jp)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ the pipeline
@pytest.mark.parametrize("order", ["walk_ego_pair", "walk_pair_ego"])
@pytest.mark.parametrize("neg_mode", ["inbatch", "random"])
def test_pipeline_batches_bitwise(both, order, neg_mode):
    jds, tds = both
    jcfg, tcfg = _pipes(order, neg_mode)
    jp = JPipeline(JEngine(jds.graph, num_partitions=2), jcfg, seed=5)
    tp = make_train_sampler(TEngine(tds.graph, num_partitions=2), tcfg, seed=5)
    assert isinstance(tp, TPipeline)
    n = 0
    for jb, tb in zip(jp.batches(7), tp.batches(7)):
        _assert_batches_equal(jb, tb)
        assert len(tb.src_ids) == 64
        n += 1
    assert n == 7 and tp.ego_sampling_ops == jp.ego_sampling_ops


def test_walk_only_pipeline_bitwise(both):
    jds, tds = both
    jcfg, tcfg = _pipes(gnn=False)
    jb = list(JPipeline(jds.graph, jcfg, seed=1).batches(4))
    tb = list(TPipeline(tds.graph, tcfg, seed=1).batches(4))
    for a, b in zip(jb, tb):
        _assert_batches_equal(a, b)


# ----------------------------------------------------------- unique ids
@pytest.mark.parametrize("bucket", [0, 8, 64])
def test_unique_pad_ids_and_remap_bitwise(bucket):
    rng = np.random.default_rng(bucket)
    arrays = [rng.integers(-1, 50, size=(7, 5)), rng.integers(-1, 90, size=13)]
    ju, tu = jtable.unique_pad_ids(arrays, bucket), ttable.unique_pad_ids(arrays, bucket)
    _assert_tree_equal(ju, tu)
    assert (tu[: len(tu) - len(np.unique(tu[tu >= 0]))] == -1).all()  # PADs lead
    for a in arrays:
        _assert_tree_equal(jtable.remap_ids(ju, a), ttable.remap_ids(tu, a))
    _assert_tree_equal(jtable.remap_ids(np.full(8, -1), arrays[0]),
                       ttable.remap_ids(np.full(8, -1), arrays[0]))


def test_gather_and_scatter_rows_match_repro():
    rng = np.random.default_rng(0)
    table = rng.normal(size=(10, 3)).astype(np.float32)
    uniq = np.array([-1, -1, 0, 4, 9])
    rows = rng.normal(size=(5, 3)).astype(np.float32)
    jnp = pytest.importorskip("jax.numpy")
    got = ttable.gather_rows(torch.from_numpy(table), torch.from_numpy(uniq))
    _assert_tree_equal(jtable.gather_rows(jnp.asarray(table), jnp.asarray(uniq)), got)
    t = torch.from_numpy(table.copy())
    assert ttable.scatter_rows(t, torch.from_numpy(uniq), torch.from_numpy(rows)) is t
    _assert_tree_equal(jtable.scatter_rows(jnp.asarray(table), jnp.asarray(uniq),
                                           jnp.asarray(rows)), t)


# --------------------------------------------------------- host batches
@pytest.mark.parametrize("case", [
    dict(), dict(side_info=True, slot_mode="bag"), dict(side_info=True, slot_mode="values"),
    dict(walk=True, side_info=True, slot_mode="values"), dict(walk=True, neg="random"),
], ids=["gnn", "gnn-bag", "gnn-values", "walk-values", "walk-random-neg"])
def test_host_batch_pytrees_bitwise(both, case):
    jds, tds = both
    case = dict(case)
    neg = case.pop("neg", "inbatch")
    jmc, tmc = _cfgs(jds.graph, **case)
    jpc, tpc = _pipes(neg_mode=neg, gnn=not case.get("walk"))
    jb = next(iter(JPipeline(jds.graph, jpc, seed=2).batches(1)))
    tb = next(iter(TPipeline(tds.graph, tpc, seed=2).batches(1)))
    _assert_tree_equal(jmodel.host_batch(jds.graph, jb, jmc),
                       tmodel.host_batch(tds.graph, tb, tmc))
    jbk, tbk = {}, {}
    for _ in range(2):  # the second batch reuses (and may grow) the buckets
        js = jmodel.sparse_host_batch(jds.graph, jb, jmc, buckets=jbk)
        ts = tmodel.sparse_host_batch(tds.graph, tb, tmc, buckets=tbk)
        _assert_tree_equal(js, ts)
    assert jbk == tbk


def test_to_device_keeps_the_tree(both):
    tds = both[1]
    tmc = _cfgs(tds.graph, side_info=True, slot_mode="values")[1]
    tpc = _pipes()[1]
    host = tmodel.sparse_host_batch(tds.graph, next(iter(TPipeline(tds.graph, tpc).batches(1))),
                                    tmc)
    dev = tmodel.to_device(host, "cpu")
    _assert_tree_equal(host, dev)
    assert isinstance(dev["src"][0][0], torch.Tensor) and dev["src"][1] is not None
