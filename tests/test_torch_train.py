"""The port's training path against ``repro``'s, from ``repro``'s parameters.

- ``loss_fn``'s value and gradients vs ``jax.value_and_grad`` of ``repro``'s,
  on one bitwise-identical host batch: rtol 1e-5 / atol 1e-6.
- One step of each optimizer rule vs ``repro``'s (Adam over two steps, so
  its bias correction moves).
- 12-step trajectories of the port's ``Graph4RecTrainer`` vs ``repro``'s
  from converted init weights, dense and sparse (``sparse_min_rows=0``):
  losses to rtol 1e-4, tables and weights to atol 1e-4 (twelve steps of
  float32 updates summed in other orders).
- The port's sparse step equals its dense step, two same-seed runs are
  identical, and a port checkpoint loads in ``repro``.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.model as jmodel
from repro.embedding import optimizer as jemb_opt
from repro.graph import DistributedGraphEngine as JEngine
from repro.graph import TOY as JTOY
from repro.graph import generate as jgenerate
from repro.sampling.pipeline import SamplePipeline as JPipeline
from repro.train import Graph4RecTrainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import checkpoint as jcheckpoint
from repro.train import optimizer as jopt
from repro_torch import convert
from repro_torch.core import model as tmodel
from repro_torch.embedding import optimizer as temb_opt
from repro_torch.graph import TOY as TTOY
from repro_torch.graph import DistributedGraphEngine as TEngine
from repro_torch.graph import generate as tgenerate
from repro_torch.obs import HealthConfig, Telemetry
from repro_torch.sampling import SamplePipeline as TPipeline
from repro_torch.train import Graph4RecTrainer as TTrainer
from repro_torch.train import TrainerConfig as TTrainerConfig
from repro_torch.train import optimizer as topt
from test_torch_model import _cfgs, _jax_params
from test_torch_sampling import _pipes

pytestmark = pytest.mark.quick

RTOL, ATOL = 1e-5, 1e-6
TRAJ_RTOL, TRAJ_ATOL = 1e-4, 1e-4


@pytest.fixture(scope="module")
def both():
    return jgenerate(JTOY, seed=0), tgenerate(TTOY, seed=0)


@pytest.fixture(autouse=True)
def deterministic():
    """Trajectory and conformance checks run under deterministic algorithms
    (the port's standing contract), so no backward may sum in a varying
    order."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


# ------------------------------------------------------------------- loss_fn
LOSS_CASES = {
    "lightgcn-bag": dict(cfg=dict(gnn_type="lightgcn", side_info=True), neg="inbatch"),
    "gcn": dict(cfg=dict(gnn_type="gcn"), neg="inbatch"),
    "lightgcn-neg-sampling": dict(cfg=dict(gnn_type="lightgcn"), neg="random"),
    "walk-values-neg-sampling": dict(cfg=dict(walk=True, side_info=True, slot_mode="values"),
                                     neg="random"),
}


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_loss_fn_value_and_grads_match_repro(both, case, sparse):
    jds, tds = both
    spec = LOSS_CASES[case]
    jmc, tmc = _cfgs(jds.graph, **spec["cfg"])
    loss = "neg_sampling" if spec["neg"] == "random" else "inbatch_softmax"
    jmc, tmc = (dataclasses.replace(c, loss=loss) for c in (jmc, tmc))
    jpc, tpc = _pipes(neg_mode=spec["neg"], gnn=not spec["cfg"].get("walk"))
    jb = next(iter(JPipeline(jds.graph, jpc, seed=4).batches(1)))
    tb = next(iter(TPipeline(tds.graph, tpc, seed=4).batches(1)))
    flat = _jax_params(jmc, seed=1)
    if sparse:
        jbatch = jmodel.sparse_host_batch(jds.graph, jb, jmc)
        tbatch = tmodel.sparse_host_batch(tds.graph, tb, tmc)
        uniq = jbatch.pop("uniq")
        tbatch.pop("uniq")
        # differentiate w.r.t. the gathered sub-tables, as the sparse step does
        flat = {**{k: v for k, v in flat.items() if not k.startswith("emb/")},
                **{f"emb/{k}": flat[f"emb/{k}"][np.maximum(u, 0)] for k, u in uniq.items()}}
    else:
        jbatch = jmodel.host_batch(jds.graph, jb, jmc)
        tbatch = tmodel.host_batch(tds.graph, tb, tmc)
    want_loss, want_grads = jax.jit(jax.value_and_grad(jmodel.loss_fn), static_argnums=1)(
        {k: jnp.asarray(v) for k, v in flat.items()}, jmc, jax.device_put(jbatch))
    params = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in flat.items()}
    got = tmodel.loss_fn(params, tmc, tmodel.to_device(tbatch, "cpu"))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want_loss), rtol=RTOL, atol=ATOL)
    assert params.keys() == want_grads.keys()
    for k, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grads[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_inbatch_sigmoid_loss_stride_branch_matches_repro():
    from repro.core import loss as jloss
    from repro_torch.core import loss as tloss

    rng = np.random.default_rng(0)
    s, d = (rng.normal(size=(9, 8)).astype(np.float32) for _ in range(2))
    want = float(jloss.inbatch_sigmoid_loss(jnp.asarray(s), jnp.asarray(d), 3))
    got = tloss.inbatch_sigmoid_loss(torch.from_numpy(s), torch.from_numpy(d), 3).item()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    gen = torch.Generator().manual_seed(0)  # the random branch: other numbers, finite
    assert np.isfinite(tloss.inbatch_sigmoid_loss(torch.from_numpy(s), torch.from_numpy(d), 3,
                                                  generator=gen).item())


# ---------------------------------------------------------------- optimizers
def _opt_data(seed=0):
    rng = np.random.default_rng(seed)
    params = {"emb/node": rng.normal(size=(12, 4)).astype(np.float32),
              "gnn/l0/r0/w": rng.normal(size=(4, 4)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(2)]
    for g in grads:
        g["emb/node"][::3] = 0.0  # untouched rows
    return params, grads


@pytest.mark.parametrize("rule", ["rowwise_adagrad", "adam", "adamw", "masked"])
def test_optimizer_steps_match_repro(rule):
    params, grads = _opt_data()
    make = {
        "rowwise_adagrad": lambda m: m.rowwise_adagrad(0.3, init_accum=0.1),
        "adam": lambda m: m.adam(1e-2),
        "adamw": lambda m: m.adam(1e-2, weight_decay=0.1),
        "masked": lambda m: m.masked(m.rowwise_adagrad(0.5), m.adam(1e-2),
                                     lambda k: k.startswith("emb/")),
    }[rule]
    jo, to = make(jopt), make(topt)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        ju, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = jopt.apply_updates(jp, ju)
        tu, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        tp = topt.apply_updates(tp, tu)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    # the state crosses to numpy and back, and repro's state converts too
    back = convert.state_from_numpy(convert.state_to_numpy(ts), device="cpu")
    from_repro = convert.state_from_numpy(jax.tree_util.tree_map(np.asarray, js), device="cpu")
    for a, b in ((ts, back), (ts, from_repro)):
        la, lb = jax.tree_util.tree_leaves(convert.state_to_numpy(a)), \
            jax.tree_util.tree_leaves(convert.state_to_numpy(b))
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL)
    assert type(back) is type(ts)


def test_dense_embedding_optimizer_matches_repro():
    params, grads = _opt_data()
    p = {"node": params["emb/node"]}
    g = {"node": grads[0]["emb/node"]}
    jp, js = jemb_opt.rowwise_adagrad_update(
        {k: jnp.asarray(v) for k, v in p.items()}, {k: jnp.asarray(v) for k, v in g.items()},
        jemb_opt.rowwise_adagrad_init({k: jnp.asarray(v) for k, v in p.items()}, 0.1), lr=0.4)
    tp, ts = temb_opt.rowwise_adagrad_update(
        {k: torch.from_numpy(v) for k, v in p.items()}, {k: torch.from_numpy(v) for k, v in g.items()},
        temb_opt.rowwise_adagrad_init({k: torch.from_numpy(v) for k, v in p.items()}, 0.1), lr=0.4)
    np.testing.assert_allclose(tp["node"].numpy(), np.asarray(jp["node"]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ts.accum["node"].numpy(), np.asarray(js.accum["node"]),
                               rtol=RTOL, atol=ATOL)


# -------------------------------------------------------------- trajectories
def _trainer(pkg, ds, sparse, gnn_type="lightgcn", side_info=False, steps=12, **kw):
    """One package's trainer in the 12-step configuration (the shape of
    tests/test_sparse_updates.py:build_trainer)."""
    jmc, tmc = _cfgs(ds.graph, gnn_type=gnn_type, side_info=side_info)
    jpc, tpc = _pipes()
    pc = jpc if pkg == "repro" else tpc
    pc = dataclasses.replace(pc, batch_pairs=64, walks_per_round=32,
                             walk=dataclasses.replace(pc.walk, walk_len=5))
    common = dict(num_steps=steps, log_every=0, seed=0, sparse_lr=0.5, dense_lr=1e-2,
                  prefetch_batches=0, eval_at_end=False, auto_backend=False,
                  sparse_updates=True, sparse_min_rows=0 if sparse else 1 << 30)
    common.update(kw)
    if pkg == "repro":
        return JTrainer(ds, JEngine(ds.graph, num_partitions=2), jmc, pc,
                        JTrainerConfig(**common))
    return TTrainer(ds, TEngine(ds.graph, num_partitions=2), tmc, pc,
                    TTrainerConfig(**common), device="cpu")


TRAJ_CASES = {
    "lightgcn-bag": dict(gnn_type="lightgcn", side_info=True),
    "gcn": dict(gnn_type="gcn"),  # GNN weights: Adam moves
}


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("case", list(TRAJ_CASES))
def test_trajectory_matches_repro(both, case, sparse):
    jt = _trainer("repro", both[0], sparse, **TRAJ_CASES[case])
    tt = _trainer("port", both[1], sparse, **TRAJ_CASES[case])
    assert tt._sparse_on == sparse and jt._sparse_on == sparse
    init = {k: np.asarray(v) for k, v in jt.init_params().items()}
    jr = jt.train({k: jnp.asarray(v) for k, v in init.items()})
    tr = tt.train(init)
    assert len(tr.losses) == 12 and tr.pairs_seen == jr.pairs_seen
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=TRAJ_RTOL, atol=TRAJ_ATOL)
    assert tr.losses[-1] < tr.losses[0]
    assert tr.params.keys() == jr.params.keys()
    for k, v in tr.params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jr.params[k]), rtol=0,
                                   atol=TRAJ_ATOL, err_msg=k)


@pytest.mark.parametrize("case", list(TRAJ_CASES))
def test_port_sparse_equals_dense_and_repeats(both, case):
    ts, td, ts2 = (_trainer("port", both[1], s, **TRAJ_CASES[case])
                   for s in (True, False, True))
    init = ts.init_params()
    init_copy = {k: v.clone() for k, v in init.items()}
    rs, rd, rs2 = ts.train(init), td.train(init), ts2.train(init)
    for k in init:  # the caller's parameters survive the in-place sparse step
        assert torch.equal(init[k], init_copy[k])
    np.testing.assert_allclose(rs.losses, rd.losses, rtol=RTOL, atol=ATOL)
    for k in rs.params:
        np.testing.assert_allclose(rs.params[k].numpy(), rd.params[k].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert rs.losses == rs2.losses  # same seed: identical
    for k in rs.params:
        assert torch.equal(rs.params[k], rs2.params[k])


def test_prefetch_and_calibration_do_not_change_the_run(both):
    serial = _trainer("port", both[1], True, steps=40)
    prefetch = _trainer("port", both[1], True, steps=40, prefetch_batches=2)
    calibrated = _trainer("port", both[1], True, steps=40, prefetch_batches=None,
                          auto_backend=True)
    init = serial.init_params()
    base = serial.train(init)
    for tr in (prefetch, calibrated):
        res = tr.train(init)
        assert res.losses == base.losses
    assert calibrated._plan["calibrated"] and calibrated._plan["prefetch"] in (0, 2)
    assert prefetch._plan["prefetch"] == 2


def test_evaluate_matches_repro(both):
    """``evaluate``: full-graph inference + device recall, from the same
    weights, gives ``repro``'s recall metrics."""
    kw = dict(eval_max_users=150, eval_top_k=20, eval_top_n=10)
    jt = _trainer("repro", both[0], True, steps=3, **kw)
    tt = _trainer("port", both[1], True, steps=3, **kw)
    flat = {k: v.numpy() for k, v in tt.train().params.items()}
    want = jt.evaluate({k: jnp.asarray(v) for k, v in flat.items()})
    got = tt.evaluate(tt.init_params(flat))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)


def test_checkpoint_loads_in_repro(both, tmp_path):
    tt = _trainer("port", both[1], True, side_info=True, steps=3)
    res = tt.train()
    flat = {k: v.numpy() for k, v in res.params.items()}
    path = convert.save(str(tmp_path / "port"), flat)
    loaded = jcheckpoint.load_flat(path)
    assert loaded.keys() == flat.keys()
    for k, v in flat.items():
        assert loaded[k].shape == v.shape and loaded[k].dtype == v.dtype
        np.testing.assert_array_equal(loaded[k], v)
    want = {k: tuple(v.shape) for k, v in jmodel.init_model_params(
        jax.random.PRNGKey(0), _cfgs(both[0].graph, side_info=True)[0]).items()}
    assert {k: v.shape for k, v in loaded.items()} == want


@pytest.mark.parametrize("override", [
    dict(engine_backend="mp"),
    dict(engine_backend="mp", telemetry=Telemetry()),
    dict(engine_backend="mp", health=HealthConfig()),
    dict(engine_backend="mp", attribution=True),
], ids=["mp", "mp-telemetry", "mp-health", "mp-attribution"])
def test_mp_engine_trains_with_each_option_bitwise(both, override):
    """No trainer option is left unported: the mp graph service trains with
    and without each observability hook, to the in-process run's losses
    bitwise, and reaps its workers on exit; an unknown backend raises."""
    base = _trainer("port", both[1], True, steps=3).train().losses
    tr = _trainer("port", both[1], True, steps=3, engine_local_threshold=0, **override)
    with tr:
        assert tr.train().losses == base
        assert tr.train().plan["engine_backend"] == "mp"
        # half the cores, clamped to the two partitions
        assert tr.engine.num_workers == min(2, max(1, (os.cpu_count() or 2) // 2))
    assert not any(p.is_alive() for p in tr.engine._procs)
    with pytest.raises(ValueError, match="engine_backend"):
        _trainer("port", both[1], True, engine_backend="bogus")
