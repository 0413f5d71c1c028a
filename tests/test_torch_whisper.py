"""The port's Whisper (``repro_torch.models.whisper``, cross-attention in
``models/layers.py``, the ``whisper`` kind of ``configs/base.py``) against
``repro``'s on the CPU, at the reduced config (f32, 2 + 2 layers, d 96, 4
heads of hd 24, 32 frames).

Both packages start from ``repro``'s ``init_params(PRNGKey(k))`` (its
biases and norms moved off zero and one by a seeded N(0, 0.05^2), so that
they count), converted with ``convert.whisper_params_from_numpy``. The
encoder states, the teacher-forced logits, the loss, the prefill and 16
decode steps (against teacher forcing and against ``repro``'s
``decode_step``) are held to rtol/atol 1e-4 (two frameworks' f32 matmuls
summed in other orders), one ``make_train_step(adam)`` step likewise in
every parameter, ``enc_pos`` among them; the padded vocabulary's logits are
-1e30; the convert round trip and ``synth_batch`` (both new kinds) are
bitwise. The reduced config's hd 24 is not a head_dim the flash kernel
takes: its wrapper refuses it, and there is no route around it. On the card
(``cuda`` marker, skipped here): the encoder's flash calls, non-causal at S
1,500 (a 92-row tail tile) with G 1, forward and backward, against the
plain version.
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
from repro.models import whisper as JW
from repro.train import optimizer as jax_opt
from repro_torch import convert
from repro_torch.configs import ShapeSpec, get_arch
from repro_torch.kernels import flash_attn as fa_mod
from repro_torch.kernels import ref
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as L
from repro_torch.models import whisper as W
from repro_torch.train import optimizer as opt_lib

pytestmark = pytest.mark.quick

ARCH = "whisper-tiny"
RTOL = ATOL = 1e-4


@pytest.fixture(autouse=True)
def deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def _specs(vocab=None, dtype="float32"):
    out = []
    for spec in (jax_get_arch(ARCH, reduced=True), get_arch(ARCH, reduced=True)):
        w = dataclasses.replace(spec.whisper, dtype=dtype, vocab=vocab or spec.whisper.vocab)
        out.append(dataclasses.replace(spec, whisper=w))
    return out


@functools.lru_cache(maxsize=None)
def _tree(seed: int, dtype: str = "float32"):
    """``repro``'s init with every bias and norm leaf moved by N(0, 0.05^2)."""
    jspec = _specs(dtype=dtype)[0]
    tree = jax.tree_util.tree_map(np.asarray, jspec.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def move(path, a):
        name = jax.tree_util.keystr(path)
        if any(f"['{k}']" in name for k in ("bq", "bk", "bv", "bu", "bd", "scale", "bias")):
            return (a.astype(np.float32) + rng.normal(size=a.shape) * 0.05).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(move, tree)


def _pair(seed: int = 1, vocab=None):
    """(repro spec, repro params, port spec, a fresh port model)."""
    jspec, spec = _specs(vocab)
    tree = _tree(seed)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jspec, jparams, spec, convert.whisper_params_from_numpy(spec.whisper, tree, "cpu")


def _inputs(seed: int, B: int, S: int, cfg):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((B, cfg.n_audio_frames, cfg.d_model)) * 0.5).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    return audio, toks


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def test_encode_decode_and_loss_match_repro():
    jspec, jparams, spec, model = _pair()
    cfg, jcfg = spec.whisper, jspec.whisper
    audio, toks = _inputs(2, 2, 24, cfg)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -2:] = -1
    enc = W.encode(model, cfg, torch.from_numpy(audio))
    jenc = JW.encode(jparams, jcfg, jnp.asarray(audio))
    _close(enc, jenc)
    logits = W.decode_train(model, cfg, enc, torch.from_numpy(toks))
    assert logits.shape == (2, 24, cfg.vocab_padded)
    _close(logits, JW.decode_train(jparams, jcfg, jenc, jnp.asarray(toks)))
    loss = W.loss(model, cfg, torch.from_numpy(audio), torch.from_numpy(toks),
                  torch.from_numpy(labels))
    jloss = JW.loss(jparams, jcfg, jnp.asarray(audio), jnp.asarray(toks), jnp.asarray(labels))
    _close(loss, jloss)
    batch = {"audio_embeds": audio, "tokens": toks, "labels": labels}
    assert spec.make_train_loss()(model, {k: torch.from_numpy(v) for k, v in batch.items()}
                                  ).item() == loss.item()
    got = spec.make_prefill()(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(got, jspec.make_prefill()(jparams, {k: jnp.asarray(v) for k, v in batch.items()}))


def test_cross_attention_matches_repro():
    from repro.models import layers as JL

    jspec, jparams, spec, model = _pair(3)
    acfg = spec.whisper.attn_cfg(False)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 96)).astype(np.float32)
    enc = rng.standard_normal((2, 32, 96)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["dec_layers"]["cross_attn"])
    p = model.dec_layers[0].cross_attn
    kv = L.encode_cross_kv(p, acfg, torch.from_numpy(enc))
    jkv = JL.encode_cross_kv(jp, jspec.whisper.attn_cfg(False), jnp.asarray(enc))
    for a, b in zip(kv, jkv):
        _close(a, b, 1e-5, 1e-5)
    _close(L.cross_attn_forward(p, acfg, torch.from_numpy(x), kv),
           JL.cross_attn_forward(jp, jspec.whisper.attn_cfg(False), jnp.asarray(x), jkv),
           1e-5, 1e-5)


def test_decode_steps_match_teacher_forcing_and_repro():
    """16 decode steps through ``init_cache`` (the audio encoded once) and
    ``decode_step``: each step's logits against ``repro``'s step and
    against the teacher-forced logits at its position."""
    jspec, jparams, spec, model = _pair(2)
    cfg, jcfg = spec.whisper, jspec.whisper
    audio, toks = _inputs(4, 2, 16, cfg)
    forced = W.decode_train(model, cfg, W.encode(model, cfg, torch.from_numpy(audio)),
                            torch.from_numpy(toks))
    cache = W.init_cache(model, cfg, torch.from_numpy(audio), 20)
    jcache = JW.init_cache(jparams, jcfg, jnp.asarray(audio), 20)
    for k, jk in (("cross_k", "cross_k"), ("cross_v", "cross_v")):
        for i, t in enumerate(cache[k]):
            _close(t, jcache[jk][i])
    jstep = jax.jit(lambda p, c, t: JW.decode_step(p, jcfg, c, t))
    for i in range(16):
        tok = toks[:, i:i + 1]
        got, cache = W.decode_step(model, cfg, cache, torch.from_numpy(tok))
        want, jcache = jstep(jparams, jcache, jnp.asarray(tok))
        _close(got, want)
        _close(got, forced[:, i].detach().numpy())
    assert cache["t"] == 16


def test_dec_pos_clamps_at_the_trained_context():
    """Past ``max_target_positions`` the decoder reuses the last learned
    position, in teacher forcing and in the decode step, as ``repro``."""
    jspec, spec = _specs()
    jcfg = dataclasses.replace(jspec.whisper, max_target_positions=6)
    cfg = dataclasses.replace(spec.whisper, max_target_positions=6)
    tree = _tree(1)
    tree = {**tree, "dec_pos": tree["dec_pos"][:6]}
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    model = convert.whisper_params_from_numpy(cfg, tree, "cpu")
    audio, toks = _inputs(6, 2, 10, cfg)
    forced = W.decode_train(model, cfg, W.encode(model, cfg, torch.from_numpy(audio)),
                            torch.from_numpy(toks))
    _close(forced, JW.decode_train(jparams, jcfg, JW.encode(jparams, jcfg, jnp.asarray(audio)),
                                   jnp.asarray(toks)))
    cache = W.init_cache(model, cfg, torch.from_numpy(audio), 10)
    for i in range(10):
        got, cache = W.decode_step(model, cfg, cache, torch.from_numpy(toks[:, i:i + 1]))
    _close(got, forced[:, -1].detach().numpy())


def test_padded_vocab_is_masked():
    """vocab 500 of 512 rows: the 12 padded columns are -1e30 in teacher
    forcing, the prefill and the decode step, and the loss matches."""
    jspec, jparams, spec, model = _pair(1, vocab=500)
    cfg = spec.whisper
    assert cfg.vocab_padded == 512
    audio, toks = _inputs(7, 2, 8, cfg)
    labels = np.roll(toks, -1, axis=1)
    logits = W.decode_train(model, cfg, W.encode(model, cfg, torch.from_numpy(audio)),
                            torch.from_numpy(toks))
    prefill = spec.make_prefill()(model, {"audio_embeds": torch.from_numpy(audio),
                                          "tokens": torch.from_numpy(toks)})
    cache = W.init_cache(model, cfg, torch.from_numpy(audio), 4)
    step, _ = W.decode_step(model, cfg, cache, torch.from_numpy(toks[:, :1]))
    for t in (logits, prefill, step):
        assert (t[..., 500:] == -1e30).all() and (t[..., :500] > -1e29).all()
    _close(W.loss(model, cfg, torch.from_numpy(audio), torch.from_numpy(toks),
                  torch.from_numpy(labels)),
           JW.loss(jparams, jspec.whisper, jnp.asarray(audio), jnp.asarray(toks),
                   jnp.asarray(labels)))


def test_one_train_step_matches_repro():
    """One ``make_train_step(adam(1e-3))`` step on ``synth_batch``: the loss
    and every parameter, ``enc_pos`` (a parameter in both) among them,
    against ``repro``'s jitted step. The key biases ``bk`` (self- and
    cross-attention) add q . bk to every logit of a softmax row: their
    gradient is zero but for f32 rounding, whose sign sets Adam's first
    update (about +-lr), so they are held to within lr of their start in
    both packages instead."""
    lr = 1e-3
    jspec, jparams, spec, model = _pair(2)
    assert "enc_pos" in dict(model.named_parameters())
    start = jax.tree_util.tree_map(np.array, convert.whisper_model_to_numpy(model))  # copies
    jopt, opt = jax_opt.adam(lr), opt_lib.adam(lr)
    jparams, _, jloss = jax.jit(jspec.make_train_step(jopt))(
        jparams, jopt.init(jparams), jax_synth_batch(np.random.default_rng(3), jspec, 2, 12))
    batch = launch_train.synth_batch(np.random.default_rng(3), spec, 2, 12, "cpu")
    model, _, loss = spec.make_train_step(opt)(model, opt.init(dict(model.named_parameters())),
                                               batch)
    _close(loss, jloss)
    mine = dict(jax.tree_util.tree_leaves_with_path(convert.whisper_model_to_numpy(model)))
    want = dict(jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray,
                                                                           jparams)))
    first = dict(jax.tree_util.tree_leaves_with_path(start))
    assert mine.keys() == want.keys() == first.keys()
    for path, leaf in mine.items():
        name = jax.tree_util.keystr(path)
        if name.endswith("['bk']"):
            for moved in (leaf, want[path]):
                assert np.abs(moved - first[path]).max() <= lr * (1 + 1e-3), name
            continue
        np.testing.assert_allclose(leaf, want[path], rtol=RTOL, atol=ATOL, err_msg=name)
    moved = np.abs(mine[(jax.tree_util.DictKey("enc_pos"),)] -
                   first[(jax.tree_util.DictKey("enc_pos"),)])
    assert moved.max() > 0.5 * lr  # enc_pos trains, as in repro


def test_bf16_model_is_f32_after_one_step():
    """Adam turns every bf16 leaf f32 at step 1 in both packages (ROADMAP
    C6), ``enc_pos`` included."""
    jspec, spec = _specs(dtype="bfloat16")
    tree = _tree(1, "bfloat16")
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    model = convert.whisper_params_from_numpy(spec.whisper, tree, "cpu")
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    jopt, opt = jax_opt.adam(1e-3), opt_lib.adam(1e-3)
    jparams, _, jloss = jax.jit(jspec.make_train_step(jopt))(
        jparams, jopt.init(jparams), jax_synth_batch(np.random.default_rng(3), jspec, 2, 12))
    batch = launch_train.synth_batch(np.random.default_rng(3), spec, 2, 12, "cpu")
    assert batch["audio_embeds"].dtype == torch.bfloat16
    model, _, loss = spec.make_train_step(opt)(model, opt.init(dict(model.named_parameters())),
                                               batch)
    assert {str(a.dtype) for a in jax.tree_util.tree_leaves(jparams)} == {"float32"}
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert model.enc_pos.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jloss), rtol=3e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trip_bitwise(dtype):
    tree = _tree(1, dtype)
    spec = _specs(dtype=dtype)[1]
    model = convert.whisper_params_from_numpy(spec.whisper, tree, "cpu")
    back = convert.whisper_model_to_numpy(model)
    a, b = jax.tree_util.tree_leaves_with_path(back), dict(
        jax.tree_util.tree_leaves_with_path(tree))
    assert len(a) == len(b)
    for path, leaf in a:
        want = np.asarray(b[path])
        assert leaf.shape == want.shape and leaf.dtype.itemsize == want.dtype.itemsize
        view = np.uint16 if want.dtype.itemsize == 2 else np.uint32
        np.testing.assert_array_equal(leaf.view(view), want.view(view))
    assert all(v.dtype == getattr(torch, dtype) for v in model.state_dict().values())
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        convert.whisper_param_shapes(spec.whisper)
    with pytest.raises(TypeError, match="not in"):
        convert.whisper_params_from_numpy(
            dataclasses.replace(spec.whisper, dtype="float32" if dtype != "float32"
                                else "bfloat16"), tree, "cpu")


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "whisper-tiny"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_synth_batch_bitwise(arch, dtype):
    """Tokens, labels, then the patch or frame embeddings from the same
    stream, in the spec's dtype: bitwise ``repro``'s."""
    specs = []
    for spec in (jax_get_arch(arch, reduced=True), get_arch(arch, reduced=True)):
        field = "whisper" if spec.kind == "whisper" else "lm"
        specs.append(dataclasses.replace(
            spec, **{field: dataclasses.replace(getattr(spec, field), dtype=dtype)}))
    want = jax_synth_batch(np.random.default_rng(9), specs[0], 3, 20)
    got = launch_train.synth_batch(np.random.default_rng(9), specs[1], 3, 20, "cpu")
    name = "audio_embeds" if arch == "whisper-tiny" else "patch_embeds"
    assert set(got) == set(want) == {"tokens", "labels", name}
    for k, v in want.items():
        v = np.asarray(v)
        g = got[k]
        if k == name:
            assert str(g.dtype) == f"torch.{dtype}" and str(v.dtype) == dtype
            bits = np.uint16 if dtype == "bfloat16" else np.uint32
            np.testing.assert_array_equal(
                g.view(torch.int16 if dtype == "bfloat16" else torch.int32).numpy().view(bits),
                v.view(bits))
        else:
            np.testing.assert_array_equal(g.numpy(), v)


def test_init_cache_encodes_zero_audio_and_serve_step_matches_repro():
    """``ArchSpec.init_cache`` encodes zero audio of ``n_audio_frames``, as
    ``repro``'s does; the serve step on that cache matches."""
    jspec, jparams, spec, model = _pair(4)
    shape = ShapeSpec("decode", 12, 2, "decode")
    cache, jcache = spec.init_cache(model, shape), jspec.init_cache(jparams, shape)
    zero = W.init_cache(model, spec.whisper, torch.zeros(2, 32, 96), 12)
    assert all(torch.equal(a, b) for a, b in zip(cache["cross_k"], zero["cross_k"]))
    assert cache["self"][0]["k"].shape == (2, 12, 96) and cache["t"] == 0
    step, jstep = spec.make_serve_step(), jax.jit(jspec.make_serve_step())
    toks = np.random.default_rng(8).integers(0, 512, size=(2, 6)).astype(np.int32)
    for i in range(6):
        got, cache = step(model, cache, {"token": torch.from_numpy(toks[:, i:i + 1])})
        want, jcache = jstep(jparams, jcache, {"token": jnp.asarray(toks[:, i:i + 1])})
        _close(got, want)


def test_with_layers_and_remat():
    """``with_layers`` cuts both stacks; remat on and off give the same
    loss and gradients bitwise."""
    spec = get_arch(ARCH).with_layers(2)
    assert spec.whisper.n_layers == 2 and spec.whisper.d_model == 384
    with pytest.raises(ValueError, match="multiple of the period"):
        get_arch(ARCH).with_layers(5)
    jspec, jparams, red, model = _pair(1)
    batch = launch_train.synth_batch(np.random.default_rng(1), red, 2, 10, "cpu")
    out = []
    for remat in (False, True):
        s = dataclasses.replace(red, whisper=dataclasses.replace(red.whisper, remat=remat))
        loss = s.make_train_loss()(model, batch)
        out.append((loss, torch.autograd.grad(loss, list(model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_reduced_head_dim_is_refused_by_the_kernel():
    """hd 24 (the reduced config) is no head_dim of the flash kernel: its
    wrapper raises before anything is launched, and the dispatcher routes
    a CUDA tensor to the kernel, never to the plain version."""
    assert get_arch(ARCH, reduced=True).whisper.head_dim == 24
    assert 24 not in fa_mod.HEAD_DIMS and get_arch(ARCH).whisper.head_dim in fa_mod.HEAD_DIMS
    q = torch.zeros(1, 4, 4, 24)
    with pytest.raises(ValueError, match="head_dim"):
        fa_mod.flash_attention_cuda(q, q, q, False)


def test_serving_example_and_launcher_on_cpu(monkeypatch):
    """``examples/serve_lm_torch.py``'s ``run`` (greedy decode and prefill
    with audio) and ``launch/train.py``'s ``run`` on the reduced Whisper."""
    import pathlib

    monkeypatch.syspath_prepend(str(pathlib.Path(__file__).resolve().parents[1] / "examples"))
    import serve_lm_torch

    args = serve_lm_torch.parser().parse_args(
        ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len", "3", "--tokens", "5",
         "--prefill-len", "12", "--device", "cpu"])
    res = serve_lm_torch.run(args)
    assert len(res["tokens"]) == 2 and all(len(t) == 5 for t in res["tokens"])
    assert res["prefill_last_logits"].shape == (2, 512)
    assert res["prefill_batch"]["audio_embeds"].shape == (2, 32, 96)
    targs = launch_train.parser().parse_args(
        ["--arch", ARCH, "--reduced", "--steps", "3", "--batch", "2", "--seq", "12",
         "--device", "cpu", "--lr", "3e-3"])
    out = launch_train.run(targs)
    assert len(out["losses"]) == 3 and np.all(np.isfinite(out["losses"]))


# ------------------------------------- the bf16 backward on shared parts
@pytest.fixture(scope="module")
def chip_smoke():
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shared_part_inputs(q_part: float, k_part: float):
    """bf16 attention inputs whose queries and keys carry a common vector
    ``q_part`` / ``k_part`` times a unit normal's size (Whisper's decoder
    adds much the same cross-attention output at every position), a dO of a
    loss's size, and the plain forward's output and LSE."""
    g = torch.Generator().manual_seed(int(10 * q_part + k_part))
    B, S, H, hd = 2, 160, 2, 64
    q, k = (torch.randn(B, S, H, hd, generator=g) + part * torch.randn(1, 1, H, hd, generator=g)
            for part in (q_part, k_part))
    v = torch.randn(B, S, H, hd, generator=g)
    do = torch.randn(B, S, H, hd, generator=g) * 1e-5
    q, k, v, do = (t.bfloat16() for t in (q, k, v, do))
    o, lse = ref.attention_fwd_ref(q, k, v, True, None)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("q_part,k_part", [(0.0, 8.0), (8.0, 0.0), (8.0, 8.0)])
def test_bf16_backward_arithmetic_holds_shared_parts(chip_smoke, q_part, k_part):
    """dQ sums dS K over keys with sum_j dS_ij = 0, so a part all keys
    share cancels exactly; dS rounded to bf16 once leaves it in, past
    ``chip_smoke.py``'s row-scaled bound, where the kernel's split of dS
    into two bf16 parts (``bwd_kernel_emulation``) stays inside it. dK,
    over queries with a shared part, likewise."""
    inputs = _shared_part_inputs(q_part, k_part)
    plain = ref.attention_bwd_ref(*inputs, True, None)
    split = chip_smoke.bwd_kernel_emulation(*inputs, True, None)
    once = chip_smoke.bwd_kernel_emulation(*inputs, True, None, ds_split=False)
    assert all(chip_smoke.flash_bwd_ok(g, w) for g, w in zip(split, plain))
    worst = max(chip_smoke._row_rel(g, w, chip_smoke.FLASH_BWD_ROW_FLOOR)
                for g, w in zip(once, plain))
    assert worst > chip_smoke.FLASH_BWD_BF16_ROW_REL


# ------------------------------------------------------------------- card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_noncausal_s1500_g1_on_card(cuda, dtype):
    """The encoder's call (B 2 x S 1,500, 6 heads = 6 KV heads, hd 64,
    non-causal): forward and backward kernels against the plain version,
    by ``chip_smoke.py``'s bounds (f32 1e-5 forward, rtol 1e-4 backward;
    bf16 3e-2 and 2^-4 row-scaled forward, 2^-6 row-scaled backward), and
    bitwise on a re-run."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(1500)
    q, k, v, do = (torch.randn(2, 1500, 6, 64, device=cuda, generator=gen).to(dt)
                   for _ in range(4))
    o, lse = fa_mod.flash_attention_cuda(q, k, v, False, None, with_lse=True)
    want, want_lse = ref.attention_fwd_ref(q, k, v, False, None)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    if dt == torch.float32:
        torch.testing.assert_close(o, want, rtol=1e-5, atol=2e-5)
    else:
        err = (o.float() - want.float()).abs()
        assert err.max().item() <= 3e-2
        assert (err.amax(-1) / want.float().abs().amax(-1).clamp_min(1e-30)).max() <= 2 ** -4
    got = fa_mod.flash_attention_bwd_cuda(q, k, v, o, lse, do, False, None)
    again = fa_mod.flash_attention_bwd_cuda(q, k, v, o, lse, do, False, None)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for g, w in zip(got, ref.attention_bwd_ref(q, k, v, o, lse, do, False, None)):
        if dt == torch.float32:
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * w.abs().max().item())
        else:
            g, w = g.float(), w.float()
            scale = w.abs().amax(-1).clamp_min(2 ** -10 * w.abs().max().item())
            assert ((g - w).abs().amax(-1) / scale).max().item() <= 2 ** -6


@pytest.mark.cuda
@pytest.mark.parametrize("q_part,k_part", [(0.0, 8.0), (8.0, 0.0), (8.0, 8.0)])
def test_bf16_backward_kernel_holds_shared_parts_on_card(cuda, chip_smoke, q_part, k_part):
    """The bf16 backward kernel on ``_shared_part_inputs``: within
    ``chip_smoke.py``'s bound of the plain version and of its emulation."""
    inputs = [t.to(cuda) for t in _shared_part_inputs(q_part, k_part)]
    got = fa_mod.flash_attention_bwd_cuda(*inputs, True, None)
    plain = ref.attention_bwd_ref(*inputs, True, None)
    emu = chip_smoke.bwd_kernel_emulation(*inputs, True, None)
    for g, w, e in zip(got, plain, emu):
        assert chip_smoke.flash_bwd_ok(g, w) and chip_smoke.flash_bwd_ok(g, e)


@pytest.mark.cuda
def test_reduced_whisper_raises_on_card(cuda):
    """On the card the reduced Whisper's hd-24 attention reaches the kernel's
    wrapper, which refuses it: no plain-version fallback."""
    spec = get_arch(ARCH, reduced=True)
    model = spec.init_params(torch.Generator().manual_seed(0), cuda)
    audio = torch.zeros(1, 32, 96, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        W.encode(model, spec.whisper, audio)
