"""The port's Mamba2 mixer (``repro_torch.models.mamba2``) against ``repro``'s
on the CPU.

``repro``'s parameters (``init_mamba2`` from a PRNG key, ``A_log``, ``D``
and ``dt_bias`` f32) and numpy-seeded inputs go to both packages. The f32
chunked SSD is held to rtol/atol 1e-5 for a sequence under one chunk and
for two and three chunks, the decode step's outputs and both caches to
1e-5 over 24 steps, the gradients in the input and every leaf to
``jax.vjp``'s at 1e-4, and in bf16 the forward to 2^-6 of its largest
value (both keep the state in bf16 and round the dual-form weights to bf16
at ``repro``'s cast points; the two frameworks' f32 exps and sums round
apart before those casts).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as JM
from repro_torch.models import mamba2 as M

pytestmark = pytest.mark.quick

RTOL = ATOL = 1e-5
GRAD_RTOL = GRAD_ATOL = 1e-4

CFG = M.Mamba2Config(d_model=48, d_state=16, headdim=16, expand=2, chunk=16)


def _jcfg(cfg):
    return JM.Mamba2Config(**dataclasses.asdict(cfg))


def _params(cfg, seed: int, dtype=jnp.float32):
    jp = JM.init_mamba2(jax.random.PRNGKey(seed), _jcfg(cfg), dtype)
    tp = {k: torch.from_numpy(np.array(np.asarray(v, np.float32))) for k, v in jp.items()}
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return jp, M.Mamba2({k: v if k in M.F32_NAMES else v.to(tdt) for k, v in tp.items()})


def _u(seed: int, B: int, S: int, d: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("S", [8, 32, 48])  # under one chunk, two and three chunks
def test_forward_matches_repro(S):
    jp, p = _params(CFG, 1)
    u = _u(2, 2, S, CFG.d_model)
    got = M.mamba2_forward(p, CFG, torch.from_numpy(u))
    want = JM.mamba2_forward(jp, _jcfg(CFG), jnp.asarray(u))
    assert got.shape == (2, S, CFG.d_model) and got.dtype == torch.float32
    _close(got, want)


def test_chunk_must_divide_the_sequence():
    _, p = _params(CFG, 1)
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        M.mamba2_forward(p, CFG, torch.zeros(1, 24, CFG.d_model))


def test_decode_steps_and_caches_match_repro():
    """24 steps from zero caches: outputs, the state and the conv history,
    each step; the port updates its cache in place."""
    jp, p = _params(CFG, 3)
    jcfg = _jcfg(CFG)
    u = _u(4, 3, 24, CFG.d_model)
    cache = M.init_mamba_cache(CFG, 3, torch.float32)
    jcache = JM.init_mamba_cache(jcfg, 3, jnp.float32)
    assert cache["ssm"].shape == jcache["ssm"].shape == (3, CFG.n_heads, 16, 16)
    assert cache["conv"].shape == jcache["conv"].shape == (3, 3, CFG.d_inner + 32)
    ssm, conv = cache["ssm"], cache["conv"]
    step = jax.jit(lambda c, x: JM.mamba2_decode_step(jp, jcfg, c, x))
    for i in range(24):
        y, cache = M.mamba2_decode_step(p, CFG, cache, torch.from_numpy(u[:, i:i + 1]))
        jy, jcache = step(jcache, jnp.asarray(u[:, i:i + 1]))
        _close(y, jy)
        _close(cache["ssm"], jcache["ssm"])
        _close(cache["conv"], jcache["conv"])
    assert cache["ssm"] is ssm and cache["conv"] is conv


def test_forward_agrees_with_decode():
    """The port alone: the chunked SSD over 48 tokens and 48 decode steps
    (repro's tests/test_models.py TestMamba2.test_forward_matches_stepwise)."""
    _, p = _params(CFG, 5)
    u = torch.from_numpy(_u(6, 2, 48, CFG.d_model))
    full = M.mamba2_forward(p, CFG, u)
    cache = M.init_mamba_cache(CFG, 2, torch.float32)
    dec = torch.cat([M.mamba2_decode_step(p, CFG, cache, u[:, i:i + 1])[0]
                     for i in range(48)], dim=1)
    _close(dec, full.detach().numpy())


def test_gradients_match_jax_vjp():
    jp, p = _params(CFG, 7)
    jcfg = _jcfg(CFG)
    rng = np.random.default_rng(8)
    u = _u(9, 2, 32, CFG.d_model)
    gy = rng.standard_normal((2, 32, CFG.d_model)).astype(np.float32)
    _, vjp = jax.vjp(lambda p_, u_: JM.mamba2_forward(p_, jcfg, u_), jp, jnp.asarray(u))
    jgp, jgu = vjp(jnp.asarray(gy))
    ut = torch.from_numpy(u).requires_grad_(True)
    y = M.mamba2_forward(p, CFG, ut)
    grads = torch.autograd.grad((y * torch.from_numpy(gy)).sum(),
                                [ut] + [getattr(p, n) for n in M.MAMBA_NAMES])
    _close(grads[0], jgu, GRAD_RTOL, GRAD_ATOL)
    for n, g in zip(M.MAMBA_NAMES, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgp[n]), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=n)


def test_bf16_cast_points_match_repro():
    jp, p = _params(CFG, 10, jnp.bfloat16)
    assert p.A_log.dtype == p.D.dtype == p.dt_bias.dtype == torch.float32
    assert p.wx.dtype == p.conv.dtype == torch.bfloat16
    u = torch.from_numpy(_u(11, 2, 32, CFG.d_model)).bfloat16()
    ju = jnp.asarray(u.float().numpy()).astype(jnp.bfloat16)
    got = M.mamba2_forward(p, CFG, u)
    want = np.asarray(JM.mamba2_forward(jp, _jcfg(CFG), ju), np.float32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=2.0 ** -6 * np.abs(want).max())
    cache = M.init_mamba_cache(CFG, 2, torch.bfloat16)
    y, cache = M.mamba2_decode_step(p, CFG, cache, u[:, :1])
    assert y.dtype == cache["ssm"].dtype == cache["conv"].dtype == torch.bfloat16


def test_init_distributions():
    cfg = dataclasses.replace(CFG, d_model=256)
    a = M.init_mamba2(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    b = M.init_mamba2(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    H = cfg.n_heads
    assert a.A_log.dtype == a.D.dtype == a.dt_bias.dtype == torch.float32
    assert torch.allclose(a.A_log, torch.log(torch.arange(1, H + 1, dtype=torch.float32)))
    assert torch.equal(a.D, torch.ones(H))
    dt = torch.nn.functional.softplus(a.dt_bias)  # the inverse softplus undone
    assert (dt >= cfg.dt_min * 0.999).all() and (dt <= cfg.dt_max * 1.001).all()
    assert abs(a.conv.float().std().item() * 10 - 1) < 0.1
    assert abs(a.wx.float().std().item() * 16 - 1) < 0.05
    assert a.conv.shape == (4, cfg.d_inner + 2 * cfg.d_state)
