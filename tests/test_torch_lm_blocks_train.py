"""Training the port's MoE, Mamba2 and hybrid archs (``make_train_step``,
``adam``) against ``repro``'s on the CPU, at their reduced configs (f32).

Both packages start from ``repro``'s ``init_params(PRNGKey(k))``, converted,
and train on each package's ``synth_batch`` (bitwise the same tokens).
Every leaf's gradient is held to ``jax.grad``'s at rtol 1e-4 with a floor
of 1e-4 of the leaf's largest |gradient| (the two frameworks' f32 sums in
other orders). Losses and every parameter after one Adam step (Mixtral,
OLMoE, Mamba2) and a 12-step Jamba trajectory are held to 1e-4 against
``jax.jit(make_train_step(adam))`` at lr 1e-5: Adam's first update is
``lr * g / (|g| + 1e-8)``, so an element whose gradient lies within the two
frameworks' f32 rounding of zero may move by anything in [-lr, lr] in
either package (at lr 1e-3 a few of the reduced Jamba's 2.9 M elements land
up to 2 lr apart after step 1, and a MoE router near-tie later turns on
those differences); at lr 1e-5 that stays inside the bound.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.launch.train import synth_batch as jax_synth_batch
from repro.models import transformer as JT
from repro.train import optimizer as jax_opt
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as opt_lib

pytestmark = pytest.mark.quick

RTOL = ATOL = 1e-4
LR = 1e-5
ARCHS = {"mixtral-8x22b": 1, "olmoe-1b-7b": 2, "mamba2-1.3b": 3, "jamba-v0.1-52b": 4}


@pytest.fixture(autouse=True)
def deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


@functools.lru_cache(maxsize=None)
def _jax_init(arch: str, seed: int, dtype: str = "float32"):
    jspec = jax_get_arch(arch, reduced=True)
    jspec = dataclasses.replace(jspec, lm=dataclasses.replace(jspec.lm, dtype=dtype))
    return jspec, jspec.init_params(jax.random.PRNGKey(seed))


def _pair(arch: str, seed: int, dtype: str = "float32"):
    """(repro spec, repro params, port spec, a fresh port model) from repro's init."""
    jspec, jparams = _jax_init(arch, seed, dtype)
    spec = get_arch(arch, reduced=True)
    spec = dataclasses.replace(spec, lm=dataclasses.replace(spec.lm, dtype=dtype))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jspec, jparams, spec, convert.lm_params_from_numpy(spec.lm, tree, device="cpu")


# ---------------------------------------------------------------- training
def _jax_train(jspec, jparams, steps: int, seed: int, B: int, S: int):
    opt = jax_opt.adam(LR)
    state = opt.init(jparams)
    step = jax.jit(jspec.make_train_step(opt))
    rng = np.random.default_rng(seed)
    losses = []
    for _ in range(steps):
        jparams, state, loss = step(jparams, state, jax_synth_batch(rng, jspec, B, S))
        losses.append(float(loss))
    return jparams, losses


def _torch_train(spec, model, steps: int, seed: int, B: int, S: int):
    opt = opt_lib.adam(LR)
    state = opt.init(dict(model.named_parameters()))
    step = spec.make_train_step(opt)
    rng = np.random.default_rng(seed)
    losses = []
    for _ in range(steps):
        model, state, loss = step(model, state, launch_train.synth_batch(rng, spec, B, S, "cpu"))
        losses.append(float(loss))
    return model, losses


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _leaves(tree[key], f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree) for k, v in _leaves(t, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def _assert_trees_close(model, jparams):
    mine, want = _leaves(convert.lm_model_to_numpy(model)), _leaves(jparams)
    assert mine.keys() == want.keys()
    for k in want:
        assert mine[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(mine[k].astype(np.float32), want[k].astype(np.float32),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_gradients_match_jax_grad(arch):
    """The loss's gradient in every leaf, routers and experts included."""
    jspec, jparams, spec, model = _pair(arch, ARCHS[arch])
    rng = np.random.default_rng(6)
    batch = launch_train.synth_batch(rng, spec, 2, 64, "cpu")
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    want = _leaves(jax.jit(jax.grad(lambda p: JT.lm_loss(p, jspec.lm, jbatch["tokens"],
                                                         jbatch["labels"])))(jparams))
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(T.lm_loss(model, spec.lm, batch["tokens"], batch["labels"]),
                                list(params.values()))
    for p, g in zip(params.values(), grads):
        p.data = g  # the gradients in repro's tree layout, through convert
    got = _leaves(convert.lm_model_to_numpy(model))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                   atol=ATOL * np.abs(want[k]).max(), err_msg=k)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "olmoe-1b-7b", "mamba2-1.3b"])
def test_one_step_matches_repro(arch):
    """Gradients reach the routers, the experts and the Mamba2 scalars:
    every parameter after one Adam step is held against repro's."""
    jspec, jparams, spec, model = _pair(arch, ARCHS[arch])
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    want_params, want = _jax_train(jspec, jparams, 1, 4, 2, 64)
    model, got = _torch_train(spec, model, 1, 4, 2, 64)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    _assert_trees_close(model, want_params)
    moved = {k for k, v in model.named_parameters() if not torch.equal(v.detach(), before[k])}
    assert moved == set(before)


def test_jamba_trajectory_matches_repro():
    """12 steps of the reduced Jamba period (every block kind), B 2 x S 64."""
    jspec, jparams, spec, model = _pair("jamba-v0.1-52b", ARCHS["jamba-v0.1-52b"])
    want_params, want = _jax_train(jspec, jparams, 12, 6, 2, 64)
    model, got = _torch_train(spec, model, 12, 6, 2, 64)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    _assert_trees_close(model, want_params)


def test_remat_on_and_off_bitwise():
    """Checkpointing every kind of block changes no bit (reduced Jamba)."""
    runs = []
    for remat in (False, True):
        spec = get_arch("jamba-v0.1-52b", reduced=True)
        spec = dataclasses.replace(spec, lm=dataclasses.replace(spec.lm, remat=remat))
        model = spec.init_params(torch.Generator().manual_seed(0), "cpu")
        model, losses = _torch_train(spec, model, 2, 7, 2, 64)
        runs.append((losses, {k: v.detach().clone() for k, v in model.state_dict().items()}))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1])


def test_bf16_model_turns_f32_at_step_one_as_repro():
    """A bf16 OLMoE: its routers f32 from the start, every leaf f32 after
    Adam's first step (ROADMAP C6), in both packages; the first loss within
    3e-2 of repro's."""
    jspec, jparams, spec, model = _pair("olmoe-1b-7b", 5, "bfloat16")
    dtypes = {k: v.dtype for k, v in model.named_parameters()}
    assert {k for k, d in dtypes.items() if d == torch.float32} == {
        k for k in dtypes if k.endswith(".router")}
    want_params, want = _jax_train(jspec, jparams, 1, 2, 2, 64)
    model, got = _torch_train(spec, model, 1, 2, 2, 64)
    assert all(a.dtype == jnp.float32 for a in jax.tree_util.tree_leaves(want_params))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-2)
