"""The port's MoE layer (``repro_torch.models.moe``) against ``repro``'s on
the CPU.

Each case draws ``repro``'s parameters (``init_moe`` from a PRNG key) and
numpy-seeded inputs, and feeds the same values to both packages. f32
outputs and the aux loss are held to rtol/atol 1e-5 (two frameworks' f32
matmuls summed in other orders), gradients in the input and every leaf to
``jax.vjp``'s at 1e-4; the routing itself (experts, slots, drops) must be
equal. In bf16 the output is held to one bf16 rounding step of its largest
value: the one-hot dispatch and combine are exact in both, the expert
einsums round their f32 sums once each.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JMOE
from repro_torch.models import moe as MOE

pytestmark = pytest.mark.quick

RTOL = ATOL = 1e-5
GRAD_RTOL = GRAD_ATOL = 1e-4

BASE = MOE.MoEConfig(d_model=32, d_ff=48, num_experts=4, top_k=2, group_size=16)
CASES = {  # name -> (config changes, B, S)
    "groups": ({}, 2, 64),  # G 8 groups of 16
    "one_group": ({"group_size": 64}, 3, 32),  # g = S < group_size
    "g1": ({}, 3, 1),  # decode: g 1, C 4
    "drops": ({"capacity_factor": 0.5, "group_size": 32}, 2, 32),  # tests/test_models.py:240
    "gelu": ({"mlp_kind": "gelu"}, 2, 32),
    "top3_of_6": ({"num_experts": 6, "top_k": 3, "capacity_factor": 1.0}, 2, 48),
}


def _cfgs(changes):
    cfg = dataclasses.replace(BASE, **changes)
    return cfg, JMOE.MoEConfig(**dataclasses.asdict(cfg))


def _params(jcfg, seed: int, dtype=jnp.float32):
    jp = JMOE.init_moe(jax.random.PRNGKey(seed), jcfg, dtype)
    return jp, {k: torch.from_numpy(np.array(np.asarray(v, np.float32))) for k, v in jp.items()}


def _module(cfg, tp, dtype=torch.float32):
    return MOE.MoE(cfg, {k: v if k == "router" else v.to(dtype) for k, v in tp.items()})


def _x(seed: int, B: int, S: int, d: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _jax_routing(jp, jcfg, x):
    """repro's routing, written out from moe.py:79-100: each choice's expert
    and whether it was kept, from its own one-hot loop."""
    B, S, d = x.shape
    g = min(jcfg.group_size, S)
    xt = jnp.asarray(x).reshape(B * S // g, g, d)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ jp["router"], axis=-1)
    _, top_idx = jax.lax.top_k(probs, jcfg.top_k)
    C = JMOE._capacity(jcfg, g)
    counts = jnp.zeros((xt.shape[0], jcfg.num_experts), jnp.int32)
    kept, slots = [], []
    for kk in range(jcfg.top_k):
        m = jax.nn.one_hot(top_idx[..., kk], jcfg.num_experts, dtype=jnp.int32)
        pos = jnp.cumsum(m, axis=1) - m + counts[:, None, :]
        keep = (m > 0) & (pos < C)
        counts = counts + (m * keep).sum(axis=1)
        kept.append(np.asarray(keep.any(-1)))
        slots.append(np.asarray((pos * m).sum(-1)))
    return np.asarray(top_idx), np.stack(kept, -1), np.stack(slots, -1)


@pytest.mark.parametrize("case", list(CASES))
def test_moe_forward_matches_repro(case):
    changes, B, S = CASES[case]
    cfg, jcfg = _cfgs(changes)
    jp, tp = _params(jcfg, 1)
    x = _x(2, B, S, cfg.d_model)
    y, aux = MOE.moe_forward(_module(cfg, tp), cfg, torch.from_numpy(x))
    jy, jaux = JMOE.moe_forward(jp, jcfg, jnp.asarray(x))
    assert y.shape == (B, S, cfg.d_model) and y.dtype == torch.float32
    assert aux.dtype == torch.float32 and aux.dim() == 0
    _close(y, jy)
    _close(aux, jaux)
    g = MOE.group_size(cfg, S)
    r = MOE.route(_module(cfg, tp), cfg, torch.from_numpy(x).reshape(-1, g, cfg.d_model))
    top_idx, kept, slots = _jax_routing(jp, jcfg, x)
    np.testing.assert_array_equal(r.top_idx.numpy(), top_idx)
    np.testing.assert_array_equal(r.kept.numpy(), kept)
    np.testing.assert_array_equal(np.where(kept, r.pos.numpy(), -1), np.where(kept, slots, -1))
    assert r.capacity == JMOE._capacity(jcfg, g)
    if case == "drops":
        assert not kept.all()  # capacity 0.5 drops choices
    if case == "g1":
        assert r.capacity == 4 and kept.all()


def test_capacity_matches_repro():
    for E, K, cf, g in [(4, 2, 1.25, 16), (64, 8, 1.25, 512), (64, 8, 8.0, 512),
                        (16, 2, 1.25, 1024), (64, 8, 1.25, 1), (8, 2, 0.5, 64), (6, 3, 1.0, 48)]:
        cfg, jcfg = _cfgs({"num_experts": E, "top_k": K, "capacity_factor": cf})
        assert MOE.capacity(cfg, g) == JMOE._capacity(jcfg, g), (E, K, cf, g)


def test_zero_router_picks_experts_in_index_order():
    """Uniform probabilities: repro's top_k picks experts 0..K-1 in every
    token, and so must the port, with weights 1/K."""
    cfg, jcfg = _cfgs({"num_experts": 6, "top_k": 3, "capacity_factor": 8.0})
    jp, tp = _params(jcfg, 3)
    jp["router"] = jnp.zeros_like(jp["router"])
    tp["router"] = torch.zeros_like(tp["router"])
    x = _x(4, 2, 32, cfg.d_model)
    m = _module(cfg, tp)
    r = MOE.route(m, cfg, torch.from_numpy(x).reshape(-1, 16, cfg.d_model))
    assert (r.top_idx == torch.arange(3)).all()
    _close(r.top_vals, np.full(r.top_vals.shape, 1 / 3, np.float32))
    y, aux = MOE.moe_forward(m, cfg, torch.from_numpy(x))
    jy, jaux = JMOE.moe_forward(jp, jcfg, jnp.asarray(x))
    _close(y, jy)
    _close(aux, jaux)


def test_group_must_divide_the_sequence():
    cfg, jcfg = _cfgs({})
    _, tp = _params(jcfg, 1)
    with pytest.raises(ValueError, match="multiple of the MoE group"):
        MOE.moe_forward(_module(cfg, tp), cfg, torch.zeros(1, 24, cfg.d_model))


@pytest.mark.parametrize("case", ["groups", "drops", "gelu"])
def test_moe_gradients_match_jax_vjp(case):
    """d(x) and d(every leaf) under random cotangents of y and aux."""
    changes, B, S = CASES[case]
    cfg, jcfg = _cfgs(changes)
    jp, tp = _params(jcfg, 5)
    rng = np.random.default_rng(6)
    x = _x(7, B, S, cfg.d_model)
    gy = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    gaux = np.float32(rng.standard_normal())
    _, vjp = jax.vjp(lambda p, x_: JMOE.moe_forward(p, jcfg, x_), jp, jnp.asarray(x))
    jgp, jgx = vjp((jnp.asarray(gy), jnp.asarray(gaux)))
    m = _module(cfg, tp)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = MOE.moe_forward(m, cfg, xt)
    names = sorted(tp)
    grads = torch.autograd.grad((y * torch.from_numpy(gy)).sum() + aux * float(gaux),
                                [xt] + [getattr(m, n) for n in names])
    _close(grads[0], jgx, GRAD_RTOL, GRAD_ATOL)
    for n, g in zip(names, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgp[n]), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=n)


def test_bf16_cast_points_match_repro():
    """bf16 weights and input with the f32 router: the output and combine
    in bf16, the aux loss f32, the routing equal to repro's and the output
    within one bf16 rounding step (2^-7) of its largest value."""
    cfg, jcfg = _cfgs({})
    jp, tp = _params(jcfg, 8, jnp.bfloat16)
    assert jp["router"].dtype == jnp.float32 and jp["wu"].dtype == jnp.bfloat16
    x = torch.from_numpy(_x(9, 2, 64, cfg.d_model)).bfloat16()
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    m = _module(cfg, tp, torch.bfloat16)
    assert m.router.dtype == torch.float32
    y, aux = MOE.moe_forward(m, cfg, x)
    jy, jaux = JMOE.moe_forward(jp, jcfg, jx)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    want = np.asarray(jy, np.float32)
    np.testing.assert_allclose(y.detach().float().numpy(), want, rtol=0,
                               atol=2.0 ** -7 * np.abs(want).max())
    _close(aux, jaux)
    r = MOE.route(m, cfg, x.reshape(-1, 16, cfg.d_model))
    top_idx, kept, _ = _jax_routing(jp, jcfg, np.asarray(jx))
    np.testing.assert_array_equal(r.top_idx.numpy(), top_idx)
    np.testing.assert_array_equal(r.kept.numpy(), kept)


def test_init_scales_and_dtypes():
    cfg = dataclasses.replace(BASE, d_model=256, d_ff=128, num_experts=8)
    a = MOE.init_moe(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    b = MOE.init_moe(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    assert a.router.dtype == torch.float32 and a.wg.dtype == a.wd.dtype == torch.bfloat16
    assert a.wu.shape == (8, 256, 128) and a.wd.shape == (8, 128, 256)
    assert abs(a.router.std().item() * 16 - 1) < 0.1
    assert abs(a.wd.float().std().item() * np.sqrt(128) - 1) < 0.05
    gelu = MOE.init_moe(torch.Generator().manual_seed(0),
                        dataclasses.replace(cfg, mlp_kind="gelu"), torch.float32)
    assert gelu.wg is None and set(gelu.state_dict()) == {"router", "wu", "wd"}
