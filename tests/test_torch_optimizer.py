"""The port's optimizers (``repro_torch.train.optimizer``) against
``repro``'s: the cases of ``tests/test_optimizer.py`` on the port, then the
same numpy-seeded trees through both packages.

f32: five steps of every optimizer, parameters and states to rtol 1e-6
(element-wise f32 arithmetic in the same order on both sides). bf16: ``sgd``
(with and without momentum), ``adagrad`` and ``clip_by_global_norm``
bitwise, dtypes included: JAX rounds a Python scalar to the leaf's dtype
first, as the port's ``_weak`` does. Every state round-trips through
``convert.state_to_numpy`` and ``state_from_numpy``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as J
from repro_torch import convert
from repro_torch.train import optimizer as O
from repro_torch.train import (Optimizer, adagrad, adam, adamw, apply_updates,
                               clip_by_global_norm, masked, sgd)

pytestmark = pytest.mark.quick

RTOL = 1e-6
SHAPES = {"w": (4,), "emb/t": (6, 3), "b": (2, 5), "a": (3,)}


def _emb(k):
    return k.startswith("emb/")


# the same optimizer built from either package's module
OPTS = {
    "sgd": lambda M: M.sgd(0.1),
    "sgd_momentum": lambda M: M.sgd(0.05, momentum=0.9),
    "adagrad": lambda M: M.adagrad(0.5),
    "adam": lambda M: M.adam(0.1),
    "adamw": lambda M: M.adamw(0.1, weight_decay=0.1),
    "masked": lambda M: M.masked(M.adagrad(1.0), M.sgd(0.1, momentum=0.5), select_a=_emb),
}


def _np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in SHAPES.items()}


def _torch_tree(tree, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) for k, v in tree.items()}


def _jax_tree(tree, dtype=jnp.float32):
    return {k: jnp.asarray(v, dtype=dtype) for k, v in tree.items()}


def _as_f32(tree):
    """Leaves as f32 numpy (bf16 -> f32 is exact) and their dtype names."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, torch.Tensor):
            out[k] = (v.float().numpy(), str(v.dtype).replace("torch.", ""))
        else:
            out[k] = (np.asarray(v, dtype=np.float32), str(v.dtype))
    return out


def _run_both(name, steps=5, dtype="float32"):
    """``steps`` updates of optimizer ``name`` in both packages from the same
    parameters and gradients; yields each step's (port, repro) parameters
    and the final states."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    topt, jopt = OPTS[name](O), OPTS[name](J)
    p0 = _np_tree(0)
    tp, jp = _torch_tree(p0, tdt), _jax_tree(p0, jdt)
    ts, js = topt.init(tp), jopt.init(jp)
    out = []
    for step in range(steps):
        g = _np_tree(100 + step)
        tu, ts = topt.update(_torch_tree(g, tdt), ts, tp)
        ju, js = jopt.update(_jax_tree(g, jdt), js, jp)
        tp, jp = apply_updates(tp, tu), J.apply_updates(jp, ju)
        out.append((tp, jp))
    return out, ts, js


def _assert_states_close(t, j, rtol):
    """The port's state (as numpy) against ``repro``'s, node by node."""
    if isinstance(j, dict):
        assert isinstance(t, dict) and t.keys() == j.keys()
        for k in j:
            _assert_states_close(t[k], j[k], rtol)
    elif isinstance(j, tuple):
        assert isinstance(t, tuple) and len(t) == len(j)
        if hasattr(j, "_fields"):
            assert t._fields == j._fields
        for a, b in zip(t, j):
            _assert_states_close(a, b, rtol)
    else:
        np.testing.assert_allclose(np.asarray(t, np.float64), np.asarray(j, np.float64),
                                   rtol=rtol, atol=0)


# ------------------------------------------------- tests/test_optimizer.py's cases
def _quad_grads(p):
    return {"w": 2 * (p["w"] - 3.0), "emb/t": 2 * (p["emb/t"] - 1.0)}


def _quad_run(opt, steps=200):
    params = {"w": torch.zeros(4), "emb/t": torch.zeros(4)}
    state = opt.init(params)
    for _ in range(steps):
        updates, state = opt.update(_quad_grads(params), state, params)
        params = apply_updates(params, updates)
    return params


@pytest.mark.parametrize("opt", [sgd(0.1), sgd(0.05, momentum=0.9), adagrad(0.5), adam(0.1),
                                 adamw(0.1, weight_decay=0.0)],
                         ids=["sgd", "sgd_momentum", "adagrad", "adam", "adamw"])
def test_converges_on_quadratic(opt):
    assert isinstance(opt, Optimizer)
    np.testing.assert_allclose(_quad_run(opt)["w"].numpy(), 3.0, atol=0.05)


def test_adamw_decays_weights():
    # decay pulls the optimum below 3.0
    assert float(_quad_run(adamw(0.05, weight_decay=0.1), 300)["w"][0]) < \
        float(_quad_run(adam(0.05), 300)["w"][0])


def test_masked_routes_by_key():
    opt = masked(adagrad(1.0), sgd(0.0), select_a=_emb)
    params = {"w": torch.zeros(2), "emb/t": torch.zeros(2)}
    updates, _ = opt.update({"w": torch.ones(2), "emb/t": torch.ones(2)},
                            opt.init(params), params)
    assert float(updates["emb/t"].abs().sum()) > 0  # adagrad moved
    np.testing.assert_allclose(updates["w"].numpy(), 0.0)  # lr 0 sgd


def test_clip_by_global_norm_unit_norm():
    clipped = clip_by_global_norm({"a": torch.full((3,), 10.0)}, 1.0)
    np.testing.assert_allclose(float(torch.linalg.norm(clipped["a"])), 1.0, rtol=1e-5)


def test_adam_state_pytree_matches_params():
    state = adam(1e-3).init({"a": torch.zeros(2, 3), "b": torch.zeros(4)})
    assert state.mu["a"].shape == (2, 3) and state.nu["b"].shape == (4,)


def test_sgd_without_momentum_keeps_no_state():
    assert sgd(0.1).init(_torch_tree(_np_tree(0))) == ()


# ------------------------------------------------------------ against repro
@pytest.mark.parametrize("name", list(OPTS))
def test_five_f32_steps_match_repro(name):
    steps, ts, js = _run_both(name)
    for tp, jp in steps:
        for k, (got, _) in _as_f32(tp).items():
            np.testing.assert_allclose(got, np.asarray(jp[k]), rtol=RTOL, atol=0)
    _assert_states_close(convert.state_to_numpy(ts), jax.tree_util.tree_map(np.asarray, js),
                         RTOL)


@pytest.mark.parametrize("name", ["sgd", "sgd_momentum", "adagrad"])
def test_bf16_steps_bitwise_repro(name):
    steps, ts, js = _run_both(name, dtype="bfloat16")
    for tp, jp in steps:
        got, want = _as_f32(tp), _as_f32(jp)
        for k in want:
            assert got[k][1] == want[k][1] == "bfloat16", k
            np.testing.assert_array_equal(got[k][0], want[k][0], err_msg=k)
    tl, jl = jax.tree_util.tree_leaves(convert.state_to_numpy(ts)), jax.tree_util.tree_leaves(js)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a.astype(np.float32), np.asarray(b, np.float32))


@pytest.mark.parametrize("max_norm", [0.5, 1e3])  # scaled down, and left as it is
@pytest.mark.parametrize("dtypes", ["f32", "bf16", "mixed"])
def test_clip_by_global_norm_matches_repro(max_norm, dtypes):
    """Leaves summed in ``tree_leaves`` order (sorted keys), the ratio's
    scalars rounded to a bf16 norm's dtype, and a bf16 leaf of a mixed tree
    promoted to f32 by the f32 norm, as JAX promotes it."""
    tree = _np_tree(7, scale=3.0)
    pick = {"f32": lambda k: "float32", "bf16": lambda k: "bfloat16",
            "mixed": lambda k: "bfloat16" if k in ("b", "emb/t") else "float32"}[dtypes]
    tt = {k: torch.from_numpy(v).to(getattr(torch, pick(k))) for k, v in tree.items()}
    jt = {k: jnp.asarray(v, dtype=getattr(jnp, pick(k))) for k, v in tree.items()}
    got, want = _as_f32(clip_by_global_norm(tt, max_norm)), _as_f32(J.clip_by_global_norm(jt,
                                                                                           max_norm))
    for k in want:
        assert got[k][1] == want[k][1], k
        if dtypes == "f32":
            np.testing.assert_allclose(got[k][0], want[k][0], rtol=RTOL, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k][0], want[k][0], err_msg=k)


def test_clip_sums_leaves_in_sorted_key_order():
    """Insertion order does not change the norm: leaves go in sorted order."""
    tree = _torch_tree(_np_tree(3, scale=5.0), torch.bfloat16)
    rev = dict(reversed(list(tree.items())))
    a, b = clip_by_global_norm(tree, 0.1), clip_by_global_norm(rev, 0.1)
    for k in tree:
        assert torch.equal(a[k], b[k])


# ------------------------------------------------------------- round trips
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(OPTS))
def test_state_round_trips_through_numpy(name, dtype):
    """Bitwise, bf16 states by their bits; the restored state's next
    update equals the original's."""
    opt = OPTS[name](O)
    params = _torch_tree(_np_tree(0), getattr(torch, dtype))
    state = opt.init(params)
    for step in range(2):
        upd, state = opt.update(_torch_tree(_np_tree(50 + step), params["w"].dtype), state,
                                params)
        params = apply_updates(params, upd)
    back = convert.state_from_numpy(convert.state_to_numpy(state), device="cpu")
    assert type(back) is type(state)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    g = _torch_tree(_np_tree(60), params["w"].dtype)
    u1, _ = opt.update(g, state, params)
    u2, _ = opt.update(g, back, params)
    for k in u1:
        assert torch.equal(u1[k], u2[k])


@pytest.mark.parametrize("name", list(OPTS))
def test_repro_state_loads_into_the_port(name):
    """``repro``'s state after five steps, as numpy, continues in the port:
    the next update equals ``repro``'s."""
    _, _, js = _run_both(name)
    topt, jopt = OPTS[name](O), OPTS[name](J)
    ts = convert.state_from_numpy(jax.tree_util.tree_map(np.asarray, js), device="cpu")
    p, g = _np_tree(1), _np_tree(200)
    tu, _ = topt.update(_torch_tree(g), ts, _torch_tree(p))
    ju, _ = jopt.update(_jax_tree(g), js, _jax_tree(p))
    for k in ju:
        np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]), rtol=RTOL, atol=0)
