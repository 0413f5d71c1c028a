"""Warm start and the recall sweep: the port against ``repro`` on TOY (CPU).

- ``save_table`` / ``load_table``: an npz from either package loads in the
  other with equal arrays.
- ``warm_start`` gives tables bitwise equal to ``repro``'s from the same npz
  (f32 and f64 sources), in the fresh table's dtype and on its device; a
  shape mismatch leaves the table untouched.
- ``train_torch --warm-start`` starts from the npz's table and
  ``--export-embeddings`` writes shards that ``repro.infer.load_embeddings``
  reads with equal values.
- ``eval_torch`` and ``eval_recsys`` loading the same exported embeddings
  report equal Recall/Hit/NDCG (1e-6) for every method; the port's
  ``recall_report`` renders ``repro``'s markdown for the same JSON.
- ``warm_start_torch`` runs both stages on the CPU, the warm run starting
  from the saved table.
"""
import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.embedding import load_table as jload_table
from repro.embedding import save_table as jsave_table
from repro.embedding import warm_start as jwarm_start
from repro.infer import load_embeddings as jload_embeddings
from repro.launch.recall_report import render_recall_report as jrender
from repro_torch.embedding import load_table, save_table, warm_start
from repro_torch.infer import load_embeddings
from repro_torch.launch.recall_report import render_recall_report

pytestmark = pytest.mark.quick


@pytest.fixture(scope="module")
def examples():
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "examples")
    sys.path.insert(0, path)
    import eval_recsys
    import eval_torch
    import train_torch
    import warm_start_torch
    yield {"eval_recsys": eval_recsys, "eval_torch": eval_torch, "train_torch": train_torch,
           "warm_start_torch": warm_start_torch}
    sys.path.remove(path)


def _tables(seed=0):
    rng = np.random.default_rng(seed)
    return {"emb/node": rng.standard_normal((50, 8)).astype(np.float32),
            "emb/slot:slot0": rng.standard_normal((6, 8)).astype(np.float32),
            "gnn/w": rng.standard_normal((8, 8)).astype(np.float32)}


def test_npz_round_trips_between_packages(tmp_path):
    tabs = _tables()
    save_table(str(tmp_path / "port.npz"), {k: torch.from_numpy(v) for k, v in tabs.items()})
    jsave_table(str(tmp_path / "repro.npz"), {k: jnp.asarray(v) for k, v in tabs.items()})
    for got in (jload_table(str(tmp_path / "port.npz")), load_table(str(tmp_path / "repro.npz")),
                load_table(str(tmp_path / "port.npz"))):
        assert got.keys() == tabs.keys()
        for k, v in tabs.items():
            assert got[k].dtype == v.dtype
            np.testing.assert_array_equal(got[k], v)


@pytest.mark.parametrize("src_dtype", [np.float32, np.float64])
def test_warm_start_bitwise_equals_repro(tmp_path, src_dtype):
    fresh = _tables(seed=1)
    pre = {k: v.astype(src_dtype) for k, v in _tables(seed=2).items() if k != "gnn/w"}
    pre["emb/bad"] = np.ones((3, 3), src_dtype)  # no such table: ignored
    path = str(tmp_path / "pre.npz")
    np.savez(path, **pre)
    want = jwarm_start({k: jnp.asarray(v) for k, v in fresh.items()}, jload_table(path))
    params = {k: torch.from_numpy(v.copy()) for k, v in fresh.items()}
    got = warm_start(params, load_table(path))
    assert got.keys() == params.keys()
    for k in fresh:
        assert got[k].dtype == params[k].dtype == torch.float32
        assert np.asarray(want[k]).tobytes() == got[k].numpy().tobytes(), k
    assert got["gnn/w"] is params["gnn/w"]  # not in the npz: untouched
    assert not np.array_equal(got["emb/node"].numpy(), fresh["emb/node"])


def test_warm_start_shape_mismatch_leaves_the_table(tmp_path):
    params = {k: torch.from_numpy(v) for k, v in _tables().items()}
    got = warm_start(params, {"emb/node": np.zeros((49, 8), np.float32),
                              "emb/slot:slot0": np.zeros((6, 8, 1), np.float32)})
    for k, v in params.items():
        assert got[k] is v
    want = jwarm_start({"emb/node": jnp.ones((50, 8))}, {"emb/node": np.zeros((49, 8))})
    assert np.asarray(want["emb/node"]).sum() == 50 * 8  # repro leaves it too


def test_train_torch_warm_start_and_export(examples, tmp_path):
    from repro_torch.graph import SPECS, generate

    tt = examples["train_torch"]
    n = generate(SPECS["toy"], seed=1).graph.num_nodes
    pre = np.random.default_rng(4).standard_normal((n, 32)).astype(np.float32)
    npz = str(tmp_path / "pre.npz")
    save_table(npz, {"node": torch.from_numpy(pre)})  # repro's example saves "node"
    base = ["--steps", "6", "--prefetch-batches", "0", "--seed", "1"]
    args = tt.parser().parse_args(base + ["--warm-start", npz, "--export-embeddings",
                                          str(tmp_path / "emb")])
    res = tt.run(args, device="cpu", eval_at_end=False)
    # the same trainer fed the warm-started table by hand runs the same steps
    trainer = res["trainer"]
    params = trainer.init_params()
    params["emb/node"] = torch.from_numpy(pre.copy())
    again = trainer.train(params)
    assert res["result"].losses == again.losses
    cold = tt.run(tt.parser().parse_args(base), device="cpu", eval_at_end=False)["result"]
    assert cold.losses != res["result"].losses
    path = res["exported"]
    port, ref = load_embeddings(path), jload_embeddings(path)
    assert port.shape == (n, 32) and port.dtype == np.float32
    np.testing.assert_array_equal(port, ref)


@pytest.fixture(scope="module")
def exported(examples, tmp_path_factory):
    """Trained TOY embeddings exported by the port's sweep, one file a model."""
    out = tmp_path_factory.mktemp("sweep")
    et = examples["eval_torch"]
    args = et.parser().parse_args(["--steps", "20", "--models", "lightgcn,metapath2vec",
                                   "--strategies", "u2i", "--export-embeddings",
                                   str(out / "emb")])
    res = et.run(args, device="cpu")
    assert [p.rsplit(".", 2)[-2] for p in res["exported"]] == ["lightgcn", "metapath2vec"]
    return out, res


@pytest.mark.parametrize("method", ["device", "ivf", "bruteforce"])
@pytest.mark.parametrize("model", ["lightgcn", "metapath2vec"])
def test_sweep_equals_eval_recsys(examples, exported, tmp_path, monkeypatch, model, method):
    out, _ = exported
    path = str(out / f"emb.toy.{model}.npz")
    flags = ["--models", model, "--method", method, "--load-embeddings", path,
             "--top-k", "50"]
    et, er = examples["eval_torch"], examples["eval_recsys"]
    port = et.run(et.parser().parse_args(flags + ["--report", str(tmp_path / "t.json")]),
                  device="cpu")
    monkeypatch.setattr(sys, "argv", ["eval_recsys.py"] + flags + [
        "--report", str(tmp_path / "j.json"), "--markdown", str(tmp_path / "j.md")])
    er.main()
    ref = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    assert got["split"] == ref["split"] and len(got["results"]) == len(ref["results"]) == 1
    g, r = got["results"][0], ref["results"][0]
    for k in ("dataset", "model", "method", "top_k", "num_users", "num_items"):
        assert g[k] == r[k], k
    assert g["metrics"].keys() == r["metrics"].keys()
    for k, v in r["metrics"].items():
        assert abs(g["metrics"][k] - v) <= 1e-6, (k, g["metrics"][k], v)
    assert port["payload"] == got


TIE_TOL = 1e-6  # ids may differ only between candidates this close in exact score


@pytest.mark.parametrize("method", ["device", "ivf", "bruteforce"])
def test_sweep_search_ids_equal_repro(exported, method):
    """The searches behind the sweep's metrics on the same exported
    embeddings (U2I with history exclusion, ICF, UCF): the port's ids equal
    ``repro``'s wherever the two candidates' exact scores differ by more than
    ``TIE_TOL``, and for the exact methods equal the numpy oracle's
    everywhere. ``repro``'s device path reorders near-ties (ROADMAP C1), so
    it is not held bitwise."""
    from repro.core import recall as jrecall
    from repro.retrieval import IVFConfig as JIVFConfig
    from repro_torch.core import recall as trecall
    from repro_torch.graph import SPECS, generate
    from repro_torch.retrieval import IVFConfig, brute_force_topk
    from repro_torch.retrieval.topk import pad_id_rows

    out, _ = exported
    ds = generate(SPECS["toy"], seed=0)
    emb = load_embeddings(str(out / "emb.toy.lightgcn.npz"))
    ue = trecall._normalize(emb[: ds.num_users])
    ie = trecall._normalize(emb[ds.num_users : ds.num_users + ds.num_items])
    t = trecall._make_searchers(method, ue, ie, 512, "cpu", IVFConfig(nlist=8, nprobe=4))
    j = jrecall._make_searchers(method, ue, ie, "ref", 8192, 512, JIVFConfig(nlist=8, nprobe=4))
    hist = trecall._user_histories(np.concatenate(
        [np.stack([u, i], 1) for (u, i) in ds.train_edges.values()]), ds.num_users)
    users = np.array(sorted(hist), dtype=np.int64)
    ex = pad_id_rows([hist[u] for u in users])
    for corpus, q, k, excl in (("item", ue[users], 50, ex), ("item", ie, 20, None),
                               ("user", ue, 21, None)):
        C = ie if corpus == "item" else ue
        (_, ti), (_, ji) = t[corpus](q, k, excl), j[corpus](q, k, excl)
        ti, ji = np.asarray(ti), np.asarray(ji)
        scores = q.astype(np.float64) @ C.astype(np.float64).T
        for r, c in np.argwhere(ti != ji):
            gap = abs(scores[r, ti[r, c]] - scores[r, ji[r, c]])
            assert gap <= TIE_TOL, (corpus, r, c, ti[r, c], ji[r, c], gap)
        if method != "ivf":
            np.testing.assert_array_equal(ti, brute_force_topk(q, C, k, exclude=excl)[1])


def test_recall_report_equals_repro(exported):
    _, res = exported
    results = res["payload"]["results"] + [
        dict(r, dataset="ub", method="ivf", num_users=8000, num_items=20000)
        for r in res["payload"]["results"]]
    assert render_recall_report(results) == jrender(results)
    assert res["markdown"] == jrender(res["payload"]["results"])


def test_sweep_mp_equals_inproc(examples):
    """``--engine-backend mp`` gives the in-process sweep's report: the same batches, so the same embeddings and metrics."""
    et = examples["eval_torch"]
    flags = ["--steps", "4", "--models", "lightgcn", "--strategies", "u2i"]
    inproc, mp = (et.run(et.parser().parse_args(flags + ["--engine-backend", b]),
                         device="cpu")["payload"]["results"] for b in ("inproc", "mp"))
    assert [r["metrics"] for r in mp] == [r["metrics"] for r in inproc]


def test_warm_start_example_runs(examples, tmp_path):
    ws = examples["warm_start_torch"]
    out = str(tmp_path / "mp2v.npz")
    res = ws.run(ws.parser().parse_args(["--pretrain-steps", "8", "--steps", "6", "--out", out]),
                 device="cpu")
    table = load_table(out)["node"]
    np.testing.assert_array_equal(table, res["pretrain"].params["emb/node"].numpy())
    assert len(res["cold"].losses) == len(res["warm"].losses) == 6
    assert res["cold"].losses != res["warm"].losses
    assert "u2i" in res["warm"].eval_history[-1]
