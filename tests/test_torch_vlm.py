"""The port's Qwen2-VL (``repro_torch.models.qwen2_vl``, the ``vlm`` kind of
``configs/base.py``) against ``repro``'s on the CPU, at the reduced config
(f32, 2 layers, hd 32, M-RoPE sections (4, 6, 6), 16 patches on a 4 x 4
grid).

Both packages start from ``repro``'s ``init_params(PRNGKey(k))``, converted
with ``convert.lm_params_from_numpy`` (Qwen2-VL's tree is an LM tree). The
patch merge and the M-RoPE ids are held bitwise (the merge at S = Np, where
``dynamic_update_slice`` clamps the span's start to 0, at Np + 1 and at
32), the loss, the prefill with patches, and one ``make_train_step(adam)``
step (loss and every parameter) to rtol/atol 1e-4 (two frameworks' f32
matmuls summed in other orders), greedy ``BatchedServer`` outputs exactly.
On the card (``cuda`` marker, skipped here): the bf16 flash forward and
backward at the full config's grouping, hd 128 and G 7 (28 query heads over
4), against the plain version.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import qwen2_vl as JVLM
from repro.serve import BatchedServer as JaxServer
from repro.serve import ServeConfig as JaxServeConfig
from repro.train import optimizer as jax_opt
from repro_torch import convert
from repro_torch.configs import ShapeSpec, get_arch
from repro_torch.kernels import ref
from repro_torch.models import qwen2_vl as VLM
from repro_torch.serve import BatchedServer, ServeConfig
from repro_torch.train import optimizer as opt_lib

pytestmark = pytest.mark.quick

ARCH = "qwen2-vl-7b"
RTOL = ATOL = 1e-4


@pytest.fixture(autouse=True)
def deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


@functools.lru_cache(maxsize=None)
def _jax_init(seed: int):
    jspec = jax_get_arch(ARCH, reduced=True)
    return jspec, jspec.init_params(jax.random.PRNGKey(seed))


def _pair(seed: int = 1):
    """(repro spec, repro params, port spec, a fresh port model)."""
    jspec, jparams = _jax_init(seed)
    spec = get_arch(ARCH, reduced=True)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jspec, jparams, spec, convert.lm_params_from_numpy(spec.lm, tree, device="cpu")


def _inputs(seed: int, B: int, S: int, spec):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, spec.lm.vocab, size=(B, S)).astype(np.int32)
    patches = (rng.standard_normal((B, spec.n_patches, spec.lm.d_model)) * 0.02).astype(
        np.float32)
    return toks, patches


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("S", [16, 17, 32])
def test_merge_vision_embeds_bitwise(S):
    """S = Np (16) clamps the span to start 0, as dynamic_update_slice does."""
    jspec, jparams, spec, model = _pair()
    toks, patches = _inputs(S, 2, S, spec)
    got = VLM.merge_vision_embeds(model, spec.lm, torch.from_numpy(toks),
                                  torch.from_numpy(patches))
    want = np.asarray(JVLM.merge_vision_embeds(jparams, jspec.lm, jnp.asarray(toks),
                                               jnp.asarray(patches)))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    start = 0 if S == 16 else 1
    np.testing.assert_array_equal(got[:, start:start + 16].detach().numpy(), patches)


def test_merge_refuses_fewer_tokens_than_patches():
    jspec, jparams, spec, model = _pair()
    toks, patches = _inputs(0, 2, 15, spec)
    with pytest.raises(TypeError):
        JVLM.merge_vision_embeds(jparams, jspec.lm, jnp.asarray(toks), jnp.asarray(patches))
    with pytest.raises(ValueError, match="do not fit"):
        VLM.merge_vision_embeds(model, spec.lm, torch.from_numpy(toks),
                                torch.from_numpy(patches))


@pytest.mark.parametrize("S,n_patches,grid", [
    (16, 16, (4, 4)), (17, 16, (4, 4)), (40, 16, (4, 4)), (40, 12, (3, 5)),
    (2048, 1024, (32, 32)),  # the full config
])
def test_mrope_positions_equal_repro(S, n_patches, grid):
    got = VLM.mrope_positions(2, S, n_patches, grid)
    want = np.asarray(JVLM.mrope_positions(2, S, n_patches, grid))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if n_patches == 1024:  # text resumes at 1 + max(H, W): backwards at index 1,025
        assert got[0, 1025].tolist() == [33, 33, 33] and got[0, 1024].tolist() == [1, 32, 32]


def test_vlm_loss_and_prefill_match_repro():
    jspec, jparams, spec, model = _pair()
    toks, patches = _inputs(5, 2, 40, spec)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    loss = VLM.vlm_loss(model, spec.lm, torch.from_numpy(toks), torch.from_numpy(labels),
                        torch.from_numpy(patches), spec.grid_hw)
    jloss = JVLM.vlm_loss(jparams, jspec.lm, jnp.asarray(toks), jnp.asarray(labels),
                          jnp.asarray(patches), jspec.grid_hw)
    _close(loss, jloss)
    assert spec.make_train_loss()(model, {
        "tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels),
        "patch_embeds": torch.from_numpy(patches)}).item() == loss.item()
    batch = {"tokens": toks, "patch_embeds": patches}
    got = spec.make_prefill()(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    want = jspec.make_prefill()(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    assert got.shape == (2, spec.lm.vocab_padded)
    _close(got, want)


def test_one_train_step_matches_repro():
    """One ``make_train_step(adam(1e-3))`` step on ``synth_batch``: the loss
    and every parameter against ``repro``'s jitted step. The key bias
    ``bk`` adds q . bk to every logit of a softmax row, so its gradient is
    zero but for f32 rounding, whose sign sets Adam's first update (lr g /
    (|g| + eps), about +-lr): its elements are held to within lr of their
    start in both packages instead of to each other."""
    from repro.launch.train import synth_batch as jax_synth_batch
    from repro_torch.launch import train as launch_train

    lr = 1e-3
    jspec, jparams, spec, model = _pair(2)
    start = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jparams)))
    jopt, opt = jax_opt.adam(lr), opt_lib.adam(lr)
    jparams, _, jloss = jax.jit(jspec.make_train_step(jopt))(
        jparams, jopt.init(jparams), jax_synth_batch(np.random.default_rng(3), jspec, 2, 24))
    batch = launch_train.synth_batch(np.random.default_rng(3), spec, 2, 24, "cpu")
    model, _, loss = spec.make_train_step(opt)(model, opt.init(dict(model.named_parameters())),
                                               batch)
    _close(loss, jloss)
    flat_mine = jax.tree_util.tree_leaves_with_path(convert.lm_model_to_numpy(model))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jparams)))
    assert len(flat_mine) == len(flat_want) == len(start)
    for path, leaf in flat_mine:
        name = jax.tree_util.keystr(path)
        if name.endswith("['bk']"):
            for moved in (leaf, flat_want[path]):
                assert np.abs(moved - start[path]).max() <= lr * (1 + 1e-3), name
            continue
        np.testing.assert_allclose(leaf, flat_want[path], rtol=RTOL, atol=ATOL, err_msg=name)


def test_batched_server_matches_repro():
    """Text requests through both servers, greedy: equal outputs (decode
    positions (t, t, t))."""
    jspec, jparams, spec, model = _pair(3)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, spec.lm.vocab, size=int(n)).tolist()
               for n in rng.integers(2, 9, size=5)]
    cfg = {"batch_size": 3, "max_new_tokens": 8, "cache_len": 24}
    got = BatchedServer(spec, model, ServeConfig(**cfg)).generate(prompts)
    want = JaxServer(jspec, jparams, JaxServeConfig(**cfg)).generate(prompts)
    assert got == want and len(got) == 5 and all(len(o) == 8 for o in got)


def test_init_cache_and_serve_step_match_repro():
    jspec, jparams, spec, model = _pair()
    shape = ShapeSpec("decode", 12, 2, "decode")
    cache = spec.init_cache(model, shape)
    jcache = jspec.init_cache(jparams, shape)
    step, jstep = spec.make_serve_step(), jax.jit(jspec.make_serve_step())
    toks = np.random.default_rng(4).integers(0, spec.lm.vocab, size=(2, 10)).astype(np.int32)
    for i in range(10):
        got, cache = step(model, cache, {"token": torch.from_numpy(toks[:, i:i + 1])})
        want, jcache = jstep(jparams, jcache, {"token": jnp.asarray(toks[:, i:i + 1])})
        _close(got, want)


# ------------------------------------------------------------------- card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(1, 2048), (2, 300)])
def test_flash_hd128_g7_bf16_on_card(cuda, B, S):
    """The full config's attention grouping (28 heads over 4, hd 128) in
    bf16, causal: the forward and backward kernels against the plain
    version, by ``chip_smoke.py``'s bounds (forward 3e-2 absolute and 2^-4
    row-scaled, backward 2^-6 row-scaled)."""
    from repro_torch.kernels import flash_attn as fa_mod

    gen = torch.Generator(device=cuda).manual_seed(S)
    q, k, v, do = (torch.randn(B, S, h, 128, device=cuda, generator=gen).bfloat16()
                   for h in (28, 4, 4, 28))
    o, lse = fa_mod.flash_attention_cuda(q, k, v, True, None, with_lse=True)
    want, want_lse = ref.attention_fwd_ref(q, k, v, True, None)
    err = (o.float() - want.float()).abs()
    assert err.max().item() <= 3e-2
    assert (err.amax(-1) / want.float().abs().amax(-1).clamp_min(1e-30)).max() <= 2 ** -4
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    got = fa_mod.flash_attention_bwd_cuda(q, k, v, o, lse, do, True, None)
    for g, w in zip(got, ref.attention_bwd_ref(q, k, v, o, lse, do, True, None)):
        g, w = g.float(), w.float()
        scale = w.abs().amax(-1).clamp_min(2 ** -10 * w.abs().max().item())
        assert ((g - w).abs().amax(-1) / scale).max().item() <= 2 ** -6
