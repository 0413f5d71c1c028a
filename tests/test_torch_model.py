"""The port's encoder against ``repro``'s, from ``repro``'s parameters.

Parameters come from ``repro.core.model.init_model_params`` under a fixed
key and are carried across with ``repro_torch.convert``; one ego batch is
sampled with numpy and fed to both encoders. Embeddings agree to
rtol 1e-5 / atol 1e-6 (the two frameworks sum in different orders).
"""
import jax
import numpy as np
import pytest
import torch

import repro.core.model as jmodel
from repro.core.hetero import HeteroGNNConfig as JHetero
from repro.embedding import EmbeddingConfig as JEmb
from repro.embedding import SlotSpec as JSlot
from repro.sampling.ego import EgoConfig, sample_ego_batch
from repro.train import checkpoint
from repro_torch import convert
from repro_torch.core import model as tmodel
from repro_torch.core.gnn import GNN_TYPES
from repro_torch.core.hetero import HeteroGNNConfig as THetero
from repro_torch.embedding import EmbeddingConfig as TEmb
from repro_torch.embedding import SlotSpec as TSlot

pytestmark = pytest.mark.quick

RELS = ("u2click2i", "i2click2u")
RTOL, ATOL = 1e-5, 1e-6
DIM = 16


def _cfgs(g, gnn_type="lightgcn", relation_agg="uniform", side_info=False,
          slot_mode="bag", use_kernel_aggr=None, walk=False):
    """The same configuration in both packages."""
    out = []
    for Emb, Slot, Het, G4R in ((JEmb, JSlot, JHetero, jmodel.Graph4RecConfig),
                                (TEmb, TSlot, THetero, tmodel.Graph4RecConfig)):
        slots = (Slot("slot0", 64, 3), Slot("slot1", 64, 3)) if side_info else ()
        out.append(G4R(
            embedding=Emb(num_nodes=g.num_nodes, dim=DIM, slots=slots),
            gnn=None if walk else Het(gnn_type=gnn_type, num_relations=2, num_layers=2,
                                      dim=DIM, relation_agg=relation_agg,
                                      use_kernel_aggr=use_kernel_aggr),
            fanouts=() if walk else (4, 3), relations=RELS,
            use_side_info=side_info, slot_mode=slot_mode,
        ))
    return out


def _jax_params(jcfg, seed=0):
    p = jmodel.init_model_params(jax.random.PRNGKey(seed), jcfg)
    return {k: np.asarray(v) for k, v in p.items()}


def _encode_both(g, jcfg, tcfg, seed=0):
    flat = _jax_params(jcfg, seed)
    centers = np.arange(0, g.num_nodes, 17, dtype=np.int64)
    centers[-3:] = -1  # PAD centers
    ego = sample_ego_batch(np.random.default_rng(5), g, centers,
                           EgoConfig(relations=list(RELS), fanouts=[4, 3]))
    bag = bool(jmodel.bag_slot_specs(jcfg))
    jlevels, jslots = jmodel._ego_arrays(g, ego, jcfg)
    want = jmodel.encode_ego(flat, jcfg, jlevels, jslots,
                             jmodel.slot_count_arrays(g, jcfg) if bag else None)
    model = convert.params_from_numpy(flat, tcfg, device="cpu")
    sample = tmodel.to_device(tmodel._ego_arrays_np(g, ego, tcfg), "cpu")
    counts = tmodel.slot_count_arrays(g, tcfg, "cpu") if bag else None
    return np.asarray(want), model(sample, counts).numpy()


@pytest.mark.parametrize("relation_agg", ["uniform", "gatne"])
@pytest.mark.parametrize("gnn_type", GNN_TYPES)
def test_encode_ego_every_zoo_member(toy_ds, gnn_type, relation_agg):
    jcfg, tcfg = _cfgs(toy_ds.graph, gnn_type, relation_agg)
    want, got = _encode_both(toy_ds.graph, jcfg, tcfg)
    assert got.shape == (30, DIM)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("slot_mode", ["bag", "values"])
def test_encode_ego_side_info(toy_ds, slot_mode):
    jcfg, tcfg = _cfgs(toy_ds.graph, "sage-mean", side_info=True, slot_mode=slot_mode)
    want, got = _encode_both(toy_ds.graph, jcfg, tcfg, seed=1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("gnn_type", ["lightgcn", "gin"])
def test_encode_ego_against_pallas_path(toy_ds, gnn_type):
    # repro with its Pallas seg_aggr kernel (interpret mode on the CPU)
    jcfg, tcfg = _cfgs(toy_ds.graph, gnn_type, use_kernel_aggr=True)
    want, got = _encode_both(toy_ds.graph, jcfg, tcfg, seed=2)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_encode_ids_walk_based(toy_ds):
    jcfg, tcfg = _cfgs(toy_ds.graph, walk=True, side_info=True, slot_mode="values")
    flat = _jax_params(jcfg, 3)
    ids = np.array([0, 5, -1, 499, 250], dtype=np.int64)
    vspecs = jmodel.value_slot_specs(jcfg)
    jslots = jmodel._slots_for_ids(toy_ds.graph, ids, vspecs)
    want = jmodel.encode_ids(flat, jcfg, jax.device_put(ids), jax.device_put(jslots))
    model = convert.params_from_numpy(flat, tcfg, device="cpu")
    tslots = tmodel._slots_for_ids(toy_ds.graph, ids, tmodel._split_slot_specs(tcfg)[1])
    got = model(tmodel.to_device((ids, tslots), "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert not got[2].any()  # PAD id -> zero row, not the table's last row


class TestConvert:
    def test_roundtrip(self, toy_ds):
        jcfg, tcfg = _cfgs(toy_ds.graph, "gat", "gatne", side_info=True)
        flat = _jax_params(jcfg)
        back = convert.model_to_numpy(convert.params_from_numpy(flat, tcfg, device="cpu"))
        assert back.keys() == flat.keys()
        for k in flat:
            np.testing.assert_array_equal(back[k], flat[k])

    def test_load_params_of_a_repro_checkpoint(self, toy_ds, tmp_path):
        jcfg, tcfg = _cfgs(toy_ds.graph, "ngcf")
        flat = _jax_params(jcfg)
        path = checkpoint.save(str(tmp_path / "ckpt"), flat)
        loaded = convert.load_params(path)
        model = convert.params_from_numpy(loaded, tcfg, device="cpu")
        for k, v in convert.model_to_numpy(model).items():
            np.testing.assert_array_equal(v, flat[k])

    def test_mismatched_params_raise(self, toy_ds):
        jcfg, tcfg = _cfgs(toy_ds.graph, "gcn")
        flat = _jax_params(jcfg)
        with pytest.raises(KeyError):
            convert.params_from_numpy({k: v for k, v in flat.items() if k != "gnn/l1/r0/w"},
                                      tcfg, device="cpu")
        bad = dict(flat, **{"gnn/l0/r0/w": np.zeros((3, 3), np.float32)})
        with pytest.raises(ValueError):
            convert.params_from_numpy(bad, tcfg, device="cpu")

    def test_torch_init_has_repro_shapes(self, toy_ds):
        for gnn_type in GNN_TYPES:
            jcfg, tcfg = _cfgs(toy_ds.graph, gnn_type, "gatne", side_info=True)
            flat = _jax_params(jcfg)
            model = convert.init_params(tcfg, seed=4, device="cpu")
            assert {k: tuple(v.shape) for k, v in model.params.items()} == {
                k: v.shape for k, v in flat.items()
            }
            # the same seed draws the same weights
            again = convert.init_params(tcfg, seed=4, device="cpu")
            for k, v in model.params.items():
                assert torch.equal(v, again.params[k])
