"""The port's numpy host layer draws ``repro``'s stream exactly.

``repro_torch`` keeps its own copies of the graph generator, the
partitioned engine and ego sampling (it imports nothing of ``repro``), so
these tests hold the copies to bitwise-identical output for one seed.
"""
import numpy as np
import pytest

import repro.graph as jgraph
from repro.sampling.ego import EgoConfig as JEgoConfig
from repro.sampling.ego import sample_ego_batch as j_sample_ego_batch
from repro_torch import graph as tgraph
from repro_torch.sampling.ego import EgoConfig, sample_ego_batch
from repro_torch.utils.ragged import ragged_row_offsets

pytestmark = pytest.mark.quick

RELS = ("u2click2i", "i2click2u")


@pytest.fixture(scope="module")
def both():
    return jgraph.generate(jgraph.TOY, seed=3), tgraph.generate(tgraph.TOY, seed=3)


def test_specs_are_the_same(both):
    assert {k: v.__dict__ for k, v in jgraph.SPECS.items()} == {
        k: v.__dict__ for k, v in tgraph.SPECS.items()
    }


def test_generate_gives_identical_arrays(both):
    j, t = both
    for name in ("val_pairs", "test_pairs", "user_clusters", "item_clusters"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    assert j.train_edges.keys() == t.train_edges.keys()
    for b in j.train_edges:
        for a, c in zip(j.train_edges[b], t.train_edges[b]):
            np.testing.assert_array_equal(a, c)
    jg, tg = j.graph, t.graph
    assert jg.node_type_ranges == tg.node_type_ranges
    assert jg.relation_names() == tg.relation_names()
    for r in jg.relations:
        np.testing.assert_array_equal(tg.relations[r].indptr, jg.relations[r].indptr)
        np.testing.assert_array_equal(tg.relations[r].indices, jg.relations[r].indices)
    for s in jg.slots:
        np.testing.assert_array_equal(tg.slots[s].indptr, jg.slots[s].indptr)
        np.testing.assert_array_equal(tg.slots[s].values, jg.slots[s].values)


@pytest.mark.parametrize("engine", ["partitioned", "graph"])
@pytest.mark.parametrize("fanouts", [(4, 3), (2,), (3, 2, 2)])
def test_ego_batches_identical(both, engine, fanouts):
    j, t = both
    if engine == "partitioned":
        je = jgraph.DistributedGraphEngine(j.graph, num_partitions=3)
        te = tgraph.DistributedGraphEngine(t.graph, num_partitions=3)
    else:
        je, te = j.graph, t.graph
    centers = np.arange(0, j.graph.num_nodes, 7, dtype=np.int64)
    centers[::9] = -1  # PAD centers propagate PAD children
    jb = j_sample_ego_batch(np.random.default_rng(11), je, centers,
                            JEgoConfig(relations=list(RELS), fanouts=list(fanouts)))
    tb = sample_ego_batch(np.random.default_rng(11), te, centers,
                          EgoConfig(relations=list(RELS), fanouts=list(fanouts)))
    assert len(jb.levels) == len(tb.levels) == len(fanouts) + 1
    for a, b in zip(jb.levels, tb.levels):
        np.testing.assert_array_equal(b, a)
    if engine == "partitioned":
        assert te.stats.neighbor_requests == je.stats.neighbor_requests
        assert te.stats.cross_partition_requests == je.stats.cross_partition_requests


def test_partition_rng_stream(both):
    from repro.graph.engine import partition_rng as j_rng
    from repro_torch.graph.engine import partition_rng as t_rng

    np.testing.assert_array_equal(t_rng(123, 2).integers(0, 10**9, 16),
                                  j_rng(123, 2).integers(0, 10**9, 16))


def test_ragged_row_offsets_matches():
    from repro.utils.ragged import ragged_row_offsets as j_ragged

    lens = np.array([3, 0, 2, 5, 0, 1])
    for a, b in zip(ragged_row_offsets(lens), j_ragged(lens)):
        np.testing.assert_array_equal(a, b)
