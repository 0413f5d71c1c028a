"""LM training in the port (``configs/base.py:make_train_step``,
``train/optimizer.py:adam``, ``launch/train.py``) against ``repro``'s on
the CPU.

The reduced dense archs start from ``repro``'s own ``init_params``,
converted with ``convert.lm_params_from_numpy``, and train on each package's
``synth_batch`` (bitwise the same tokens and labels) against
``jax.jit(spec.make_train_step(adam(lr)))``. Losses and every parameter are
held to rtol/atol 1e-4: two frameworks' f32 matmuls, transcendentals and
attention backwards (``repro`` differentiates its einsum path, the port runs
``attention_bwd_ref``), summed in other orders over a few Adam steps, whose
first update is lr times the gradient's sign. Under deterministic
algorithms the port's own runs (remat on and off) are bitwise equal. In
bf16 ``repro``'s Adam promotes every parameter to f32 at the first step
(ROADMAP C6); the port's does the same, and the first loss agrees to 3e-2.
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
from repro.train import optimizer as jax_opt
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.launch import train as launch_train
from repro_torch.train import optimizer as opt_lib

pytestmark = pytest.mark.quick

RTOL = ATOL = 1e-4
BF16_LOSS_TOL = 3e-2
LR = 1e-3
B, S = 4, 32


@pytest.fixture(autouse=True)
def deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def _specs(arch: str, microbatches: int = 1, dtype: str = "float32", remat=None):
    """(repro spec, port spec) of the reduced ``arch`` with these fields."""
    out = []
    for spec in (jax_get_arch(arch, reduced=True), get_arch(arch, reduced=True)):
        lm = dataclasses.replace(spec.lm, dtype=dtype,
                                 remat=spec.lm.remat if remat is None else remat)
        out.append(dataclasses.replace(spec, lm=lm, microbatches=microbatches))
    return out


@functools.lru_cache(maxsize=None)
def _init(arch: str, seed: int):
    return jax_get_arch(arch, reduced=True).init_params(jax.random.PRNGKey(seed))


def _models(jspec, spec, seed: int):
    """``repro``'s params for (arch, seed) in the spec's dtype, and the
    port's model converted from them."""
    jparams = jax.tree_util.tree_map(lambda a: a.astype(jnp.dtype(jspec.lm.dtype)),
                                     _init(jspec.arch_id.replace("-smoke", ""), seed))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, convert.lm_params_from_numpy(spec.lm, tree, device="cpu")


def _jax_train(jspec, jparams, steps: int, seed: int, lr: float = LR):
    opt = jax_opt.adam(lr)
    state = opt.init(jparams)
    step = jax.jit(jspec.make_train_step(opt))
    rng = np.random.default_rng(seed)
    losses = []
    for _ in range(steps):
        jparams, state, loss = step(jparams, state, jax_synth_batch(rng, jspec, B, S))
        losses.append(float(loss))
    return jparams, losses


def _torch_train(spec, model, steps: int, seed: int, lr: float = LR):
    opt = opt_lib.adam(lr)
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


def _assert_trees_close(model, jparams, rtol=RTOL, atol=ATOL):
    mine, want = _leaves(convert.lm_model_to_numpy(model)), _leaves(jparams)
    assert mine.keys() == want.keys()
    for k in want:
        assert mine[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(mine[k].astype(np.float32), want[k].astype(np.float32),
                                   rtol=rtol, atol=atol, err_msg=k)


# ------------------------------------------------------------------- Adam
def test_adam_promotes_a_bf16_leaf_as_repro():
    rng = np.random.default_rng(0)
    p = rng.standard_normal((6, 5)).astype(np.float32)
    gs = [rng.standard_normal((6, 5)).astype(np.float32) for _ in range(3)]
    jp = {"w": jnp.asarray(p).astype(jnp.bfloat16)}
    tp = {"w": torch.from_numpy(p).bfloat16()}
    jo, to = jax_opt.adam(1e-2), opt_lib.adam(1e-2)
    js, ts = jo.init(jp), to.init(tp)
    for g in gs:
        # the gradient takes the parameter's dtype, as autograd gives it
        jg = {"w": jnp.asarray(g).astype(jp["w"].dtype)}
        tg = {"w": torch.from_numpy(g).to(tp["w"].dtype)}
        ju, js = jo.update(jg, js, jp)
        tu, ts = to.update(tg, ts, tp)
        assert str(tu["w"].dtype).replace("torch.", "") == str(ju["w"].dtype)
        np.testing.assert_array_equal(tu["w"].numpy(), np.asarray(ju["w"]))
        jp, tp = jax_opt.apply_updates(jp, ju), opt_lib.apply_updates(tp, tu)
        assert tp["w"].dtype == torch.float32 and jp["w"].dtype == jnp.float32
        for m in ("mu", "nu"):
            assert (str(getattr(ts, m)["w"].dtype).replace("torch.", "")
                    == str(getattr(js, m)["w"].dtype))
        np.testing.assert_array_equal(tp["w"].numpy(), np.asarray(jp["w"]))


def test_adam_f32_leaf_bits_unchanged_by_the_promotion():
    """On an f32 leaf the update is the formula as written, in f32."""
    rng = np.random.default_rng(1)
    p = {"w": torch.from_numpy(rng.standard_normal((7, 3)).astype(np.float32))}
    g = {"w": torch.from_numpy(rng.standard_normal((7, 3)).astype(np.float32))}
    opt = opt_lib.adam(3e-4)
    upd, state = opt.update(g, opt.init(p), p)
    bc1, bc2 = 1 - torch.pow(0.9, torch.tensor(1.0)), 1 - torch.pow(0.999, torch.tensor(1.0))
    want = -3e-4 * (state.mu["w"] / bc1) / (torch.sqrt(state.nu["w"] / bc2) + 1e-8)
    assert upd["w"].dtype == torch.float32
    assert torch.equal(upd["w"], want)


# ---------------------------------------------------------------- batches
@pytest.mark.parametrize("arch", ["smollm-135m", "starcoder2-7b"])
def test_synth_batch_bitwise_repro(arch):
    jspec, spec = jax_get_arch(arch, reduced=True), get_arch(arch, reduced=True)
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):
        want = jax_synth_batch(r1, jspec, 3, 17)
        got = launch_train.synth_batch(r2, spec, 3, 17, "cpu")
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert int(got["labels"][:, -1].max()) == -1


# ----------------------------------------------------------- trajectories
@pytest.mark.parametrize("microbatches", [1, 2])
def test_smollm_trajectory_matches_repro(microbatches):
    jspec, spec = _specs("smollm-135m", microbatches)
    jparams, model = _models(jspec, spec, 1)
    want_params, want = _jax_train(jspec, jparams, 4, seed=2)
    model, got = _torch_train(spec, model, 4, seed=2)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    _assert_trees_close(model, want_params)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "starcoder2-7b", "deepseek-coder-33b"])
def test_one_step_matches_repro(arch):
    """qwen2 (qkv bias), starcoder2 (window 16 under S 32, LayerNorm, GELU)
    and deepseek, one step each."""
    jspec, spec = _specs(arch)
    jparams, model = _models(jspec, spec, 3)
    want_params, want = _jax_train(jspec, jparams, 1, seed=4)
    model, got = _torch_train(spec, model, 1, seed=4)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    _assert_trees_close(model, want_params)


def test_remat_on_and_off_bitwise():
    runs = []
    for remat in (False, True):
        _, spec = _specs("smollm-135m", remat=remat)
        model = spec.init_params(torch.Generator().manual_seed(0), "cpu")
        model, losses = _torch_train(spec, model, 3, seed=6)
        runs.append((losses, {k: v.detach().clone() for k, v in model.state_dict().items()}))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1])


def test_bf16_model_turns_f32_at_step_one_as_repro():
    jspec, spec = _specs("smollm-135m", dtype="bfloat16")
    jparams, model = _models(jspec, spec, 1)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    want_params, want = _jax_train(jspec, jparams, 1, seed=2)
    model, got = _torch_train(spec, model, 1, seed=2)
    assert all(a.dtype == jnp.float32 for a in jax.tree_util.tree_leaves(want_params))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_LOSS_TOL)
    # the next step runs the forward in the parameters' dtype, f32
    model, _ = _torch_train(spec, model, 1, seed=3)
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_make_train_step_updates_in_place():
    _, spec = _specs("smollm-135m")
    model = spec.init_params(torch.Generator().manual_seed(0), "cpu")
    before = {k: (id(p), p.detach().clone()) for k, p in model.named_parameters()}
    opt = opt_lib.adam(LR)
    step = spec.make_train_step(opt)
    out, _, loss = step(model, opt.init(dict(model.named_parameters())),
                        launch_train.synth_batch(np.random.default_rng(0), spec, B, S, "cpu"))
    assert out is model and loss.grad_fn is None and loss.dim() == 0
    for k, p in model.named_parameters():
        assert id(p) == before[k][0] and p.grad is None
        assert not torch.equal(p.detach(), before[k][1]), k


def test_launch_train_run_reduces_loss():
    args = launch_train.parser().parse_args(
        ["--device", "cpu", "--reduced", "--steps", "30", "--lr", "3e-3"])
    seen = []
    res = launch_train.run(args, after_step=lambda i, m, loss: seen.append(i))
    assert seen == list(range(30)) and len(res["step_s"]) == 30 and res["tokens_per_s"] > 0
    assert res["losses"][-1] < res["losses"][0]
    assert np.all(np.isfinite(res["losses"]))


def test_launch_train_loads_no_jax():
    """The launcher stands alone: importing it loads neither JAX nor ``repro``."""
    import os
    import pathlib
    import subprocess
    import sys

    code = ("import sys\nimport repro_torch.launch.train\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(pathlib.Path(__file__).resolve().parents[1] / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
