"""The port's LM substrate (``repro_torch.models``, ``configs``, ``serve``)
against ``repro``'s on the CPU.

The four dense-attention archs at their reduced sizes (f32) start from
``repro``'s own ``init_params(PRNGKey(k))``, converted with
``convert.lm_params_from_numpy``; logits, losses, prefill and decode logits
are held to rtol/atol 1e-4 (two frameworks' f32 matmuls and
transcendentals, summed in other orders, across two layers), the
norms and RoPE tables to 1e-6, the served greedy tokens and the converted
weights exactly. On the CPU the port's full-sequence attention is the
flash kernel's plain version; ``repro`` at these lengths takes its naive
einsum path. In bf16, the full configs' type, the norms and RoPE are held
bitwise, the decode attention to a bf16 ulp, and the reduced archs from
``repro``'s bf16 init to ``BF16_REL`` against ``repro``'s flash path. The
MoE, Mamba2 and hybrid archs are held in ``test_torch_lm_blocks.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_arch as jax_get_arch
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve import BatchedServer as JaxServer
from repro.serve import ServeConfig as JaxServeConfig
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, ShapeSpec, get_arch
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve import BatchedServer, ServeConfig

pytestmark = pytest.mark.quick

RTOL = ATOL = 1e-4
ARCHS = {"smollm-135m": 1, "qwen2-0.5b": 2, "starcoder2-7b": 3, "deepseek-coder-33b": 4}


@functools.lru_cache(maxsize=None)
def _pair(arch: str, seed: int):
    """(repro spec, repro params, port spec, port model) from repro's init."""
    jspec = jax_get_arch(arch, reduced=True)
    jparams = jspec.init_params(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    spec = get_arch(arch, reduced=True)
    return jspec, jparams, spec, convert.lm_params_from_numpy(spec.lm, tree, device="cpu")


def _tokens(seed: int, B: int, S: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S)).astype(np.int32)


def _close(got: torch.Tensor, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


# --------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_equal_repro(arch, reduced):
    mine, ref = get_arch(arch, reduced), jax_get_arch(arch, reduced)
    for f in ("arch_id", "kind", "family", "citation", "n_patches", "grid_hw",
              "sub_quadratic", "microbatches"):
        assert getattr(mine, f) == getattr(ref, f), f
    if mine.kind == "whisper":
        assert mine.lm is None and ref.lm is None
        assert dataclasses.asdict(mine.whisper) == dataclasses.asdict(ref.whisper)
        w, rw = mine.whisper, ref.whisper
        assert (w.vocab_padded, w.head_dim) == (rw.vocab_padded, rw.head_dim)
        for causal in (True, False):
            assert dataclasses.asdict(w.attn_cfg(causal)) == dataclasses.asdict(
                rw.attn_cfg(causal))
        return
    mine, ref = mine.lm, ref.lm
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.vocab_padded == ref.vocab_padded and mine.period() == ref.period()
    assert dataclasses.asdict(mine.attn_cfg()) == dataclasses.asdict(ref.attn_cfg())


def test_unported_archs_raise():
    """No arch is left unported: all ten of ``repro``'s resolve, full and
    reduced, with ``repro``'s kinds. What still raises: an unknown arch id,
    an unknown spec kind, a block kind outside (attn | mamba, dense | moe |
    none), and ``BatchedServer`` on a Whisper spec (``repro``'s refuses it
    too: LM-family archs only)."""
    assert ARCH_IDS == JAX_ARCH_IDS and len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        for reduced in (False, True):
            assert get_arch(arch, reduced).kind == jax_get_arch(arch, reduced).kind
    assert {a: get_arch(a).kind for a in ("qwen2-vl-7b", "whisper-tiny")} == {
        "qwen2-vl-7b": "vlm", "whisper-tiny": "whisper"}
    with pytest.raises(KeyError):
        get_arch("no-such-arch")
    spec = get_arch("smollm-135m", reduced=True)
    with pytest.raises(ValueError, match="arch kind"):
        dataclasses.replace(spec, kind="speech")
    for bad in (("conv", "dense"), ("attn", "sparse")):
        with pytest.raises(ValueError, match="mixer in"):
            T.init_lm(torch.Generator().manual_seed(0),
                      dataclasses.replace(spec.lm, blocks=(bad,) * 2))
    whisper = get_arch("whisper-tiny", reduced=True)
    with pytest.raises(AssertionError, match="LM-family archs only"):
        JaxServer(jax_get_arch("whisper-tiny", reduced=True), None, JaxServeConfig())
    with pytest.raises(ValueError, match="LM-family archs only"):  # telemetry is ported
        BatchedServer(whisper, whisper.init_params(torch.Generator().manual_seed(0), "cpu"),
                      ServeConfig())


# --------------------------------------------------------- norms and RoPE
def test_norms_match_repro():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 96)).astype(np.float32) * 3
    scale = rng.standard_normal(96).astype(np.float32)
    bias = rng.standard_normal(96).astype(np.float32)
    t = torch.from_numpy
    _close(L.rmsnorm(L.Norm("rms", t(scale)), t(x)), JL.rmsnorm({"scale": scale}, x),
           1e-6, 1e-6)
    _close(L.layernorm(L.Norm("ln", t(scale), t(bias)), t(x)),
           JL.layernorm({"scale": scale, "bias": bias}, x), 1e-6, 1e-6)
    _close(L.apply_norm("ln", L.Norm("ln", t(scale), t(bias)), t(x)),
           JL.apply_norm("ln", {"scale": scale, "bias": bias}, x), 1e-6, 1e-6)


@pytest.mark.parametrize("theta,sections", [(1e4, None), (1e6, None), (1e4, (4, 6, 6))])
def test_rope_matches_repro(theta, sections):
    rng = np.random.default_rng(1)
    B, S, H, hd = 2, 24, 3, 32
    shape = (B, S) if sections is None else (B, S, len(sections))
    pos = rng.integers(0, 4096, size=shape).astype(np.int32)
    cos, sin = L.rope_cos_sin(torch.from_numpy(pos), hd, theta, sections)
    jcos, jsin = JL.rope_cos_sin(jnp.asarray(pos), hd, theta, sections)
    _close(cos, jcos, 1e-6, 1e-6)
    _close(sin, jsin, 1e-6, 1e-6)
    x = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    _close(L.apply_rope(torch.from_numpy(x), cos, sin), JL.apply_rope(x, jcos, jsin),
           1e-6, 1e-6)


# ------------------------------------------------------- forward and loss
@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("S", [32, 48])
def test_forward_and_loss_match_repro(arch, S):
    jspec, jparams, spec, model = _pair(arch, ARCHS[arch])
    toks = _tokens(10 + S, 2, S, spec.lm.vocab)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -3:] = -1
    logits, aux = T.forward(model, spec.lm, torch.from_numpy(toks))
    jlogits, _ = JT.forward(jparams, jspec.lm, jnp.asarray(toks))
    assert logits.shape == (2, S, spec.lm.vocab_padded) and float(aux) == 0.0
    _close(logits, jlogits)
    loss = T.lm_loss(model, spec.lm, torch.from_numpy(toks), torch.from_numpy(labels))
    jloss = JT.lm_loss(jparams, jspec.lm, jnp.asarray(toks), jnp.asarray(labels))
    _close(loss, jloss)
    jloss_fn = jspec.make_train_loss()
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    _close(spec.make_train_loss()(model, batch),
           jloss_fn(jparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_matches_repro(arch):
    jspec, jparams, spec, model = _pair(arch, ARCHS[arch])
    toks = _tokens(7, 3, 40, spec.lm.vocab)
    got = spec.make_prefill()(model, {"tokens": torch.from_numpy(toks)})
    want = jspec.make_prefill()(jparams, {"tokens": jnp.asarray(toks)})
    assert got.shape == (3, spec.lm.vocab_padded)
    _close(got, want)


# ------------------------------------------------------------------ decode
@pytest.mark.parametrize("arch,cache_len", [(a, 32) for a in ARCHS] + [("smollm-135m", 24)])
def test_decode_steps_match_repro(arch, cache_len):
    """32 steps: starcoder2 (window 16) wraps its ring twice; a 24-slot
    full cache clamps its slot to the last for the final 8 steps."""
    jspec, jparams, spec, model = _pair(arch, ARCHS[arch])
    B, steps = 2, 32
    toks = _tokens(20, B, steps, spec.lm.vocab)
    cache = spec.init_cache(model, ShapeSpec("decode", cache_len, B, "decode"))
    jcache = JT.init_cache(jspec.lm, B, cache_len)
    if spec.lm.sliding_window:
        assert cache["layers"][0]["k"].shape[1] == spec.lm.sliding_window
    step = spec.make_serve_step()
    jstep = jax.jit(jspec.make_serve_step())
    for i in range(steps):
        lg, cache = step(model, cache, {"token": torch.from_numpy(toks[:, i:i + 1])})
        jlg, jcache = jstep(jparams, jcache, {"token": jnp.asarray(toks[:, i:i + 1])})
        _close(lg, jlg)
    assert cache["t"] == steps


def test_prefill_agrees_with_decode():
    """The port alone: the last prefill logits and the last of S decode
    steps (repro's own bound, test_models.py's forward-vs-decode check)."""
    _, _, spec, model = _pair("starcoder2-7b", 3)
    toks = torch.from_numpy(_tokens(5, 2, 40, spec.lm.vocab))
    full = spec.make_prefill()(model, {"tokens": toks})
    cache = T.init_cache(spec.lm, 2, 40)
    for i in range(40):
        lg, cache = T.decode_step(model, spec.lm, cache, toks[:, i:i + 1])
    rel = (lg - full).abs().max() / full.abs().max()
    assert rel < 2e-2


# -------------------------------------------------------------------- bf16
BF16_REL = 3e-2  # port vs repro, bf16 logits: max |a - b| / max |b|


def _bf16(x: np.ndarray):
    """The same bf16 values as a torch tensor and a jax array."""
    t = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _rel(got: torch.Tensor, want) -> float:
    """repro's forward-vs-decode measure (tests/test_models.py), in f32."""
    g = got.detach().float().numpy()
    w = want.float().numpy() if isinstance(want, torch.Tensor) else np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / np.abs(w).max())


def test_bf16_cast_points_match_repro():
    """The norms and RoPE in bf16 are bitwise repro's (each casts where
    repro casts: rsqrt to x.dtype, cos/sin to x.dtype); the masked GQA
    attention (the decode step's) is bf16 and within one bf16 ulp of its
    largest output (the two frameworks' f32 exp and bf16 products round
    apart there)."""
    rng = np.random.default_rng(0)
    x, jx = _bf16(rng.standard_normal((2, 8, 96)) * 3)
    sc, jsc = _bf16(rng.standard_normal(96))
    bi, jbi = _bf16(rng.standard_normal(96))
    for got, want in ((L.rmsnorm(L.Norm("rms", sc), x), JL.rmsnorm({"scale": jsc}, jx)),
                      (L.layernorm(L.Norm("ln", sc, bi), x),
                       JL.layernorm({"scale": jsc, "bias": jbi}, jx))):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.detach().float().numpy(),
                                      np.asarray(want, np.float32))
    B, S, H, K, hd = 2, 24, 3, 1, 32
    pos = rng.integers(0, 4096, size=(B, S)).astype(np.int32)
    cos, sin = L.rope_cos_sin(torch.from_numpy(pos), hd, 1e4, None)
    jcos, jsin = JL.rope_cos_sin(jnp.asarray(pos), hd, 1e4, None)
    q, jq = _bf16(rng.standard_normal((B, S, H, hd)))
    got = L.apply_rope(q, cos, sin)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(JL.apply_rope(jq, jcos, jsin), np.float32))
    k, jk = _bf16(rng.standard_normal((B, S, K, hd)))
    v, jv = _bf16(rng.standard_normal((B, S, K, hd)))
    for causal, window in ((True, None), (True, 8), (False, None)):
        got = L.gqa_attention(q, k, v, L.gqa_scores_mask(S, S, causal, window))
        want = np.asarray(JL.gqa_attention(jq, jk, jv, JL.gqa_scores_mask(S, S, causal, window)),
                          np.float32)
        assert got.dtype == torch.bfloat16
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=ulp)


@functools.lru_cache(maxsize=None)
def _pair_bf16(arch: str, seed: int):
    """``_pair`` with both configs in bf16; repro's own bf16 init."""
    jspec = jax_get_arch(arch, reduced=True)
    jspec = dataclasses.replace(jspec, lm=dataclasses.replace(jspec.lm, dtype="bfloat16"))
    jparams = jspec.init_params(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    spec = get_arch(arch, reduced=True)
    spec = dataclasses.replace(spec, lm=dataclasses.replace(spec.lm, dtype="bfloat16"))
    return jspec, jparams, spec, convert.lm_params_from_numpy(spec.lm, tree, device="cpu")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_bf16_model_matches_repro(arch):
    """The reduced archs in bf16, as the full configs serve: forward,
    prefill and 32 decode steps against repro's bf16 (its flash path for
    the full sequence, whose p stays f32, where the port's plain version
    rounds the normalised weights to bf16 and its card kernel the
    unnormalised ones) to ``BF16_REL``; repro's own flash and naive bf16 paths differ by up to
    1.8e-2 on these inputs. The port's prefill and decode agree to repro's
    2e-2 bound (tests/test_models.py), as repro's flash path does here."""
    jspec, jparams, spec, model = _pair_bf16(arch, ARCHS[arch])
    jflash = dataclasses.replace(jspec.lm, use_flash=True)  # Pallas interpret on the CPU
    B, S = 2, 32
    toks = _tokens(10, B, S, spec.lm.vocab)
    with torch.no_grad():
        logits, _ = T.forward(model, spec.lm, torch.from_numpy(toks))
        last = spec.make_prefill()(model, {"tokens": torch.from_numpy(toks)})
    jlogits, _ = JT.forward(jparams, jflash, jnp.asarray(toks))
    assert logits.dtype == last.dtype == torch.bfloat16
    assert _rel(logits, jlogits) < BF16_REL
    assert _rel(last, jlogits[:, -1]) < BF16_REL
    cache = spec.init_cache(model, ShapeSpec("decode", S, B, "decode"))
    jcache = JT.init_cache(jspec.lm, B, S)
    step = spec.make_serve_step()
    jstep = jax.jit(jspec.make_serve_step())
    for i in range(S):
        lg, cache = step(model, cache, {"token": torch.from_numpy(toks[:, i:i + 1])})
        jlg, jcache = jstep(jparams, jcache, {"token": jnp.asarray(toks[:, i:i + 1])})
        assert lg.dtype == torch.bfloat16
        assert _rel(lg, jlg) < BF16_REL, i
    assert _rel(lg, last) < 2e-2


# ----------------------------------------------------------------- serving
SERVE_CASES = [  # tests/test_serve.py's archs, seeds, configs and prompts
    ("smollm-135m", 0, dict(batch_size=3, max_new_tokens=5, cache_len=32),
     [[1, 2, 3], [4], [5, 6], [7, 8, 9, 10]]),
    ("qwen2-0.5b", 1, dict(batch_size=2, max_new_tokens=4, cache_len=16), [[1, 2], [3, 4]]),
    ("smollm-135m", 0, dict(batch_size=2, max_new_tokens=8, cache_len=32), [[1, 2]]),
    ("starcoder2-7b", 3, dict(batch_size=2, max_new_tokens=24, cache_len=64),
     [[5, 9, 1, 7, 3, 3, 8, 2, 6, 4, 1, 9, 2, 2, 7, 5, 8, 3], [11, 12]]),
]


@pytest.mark.parametrize("arch,seed,cfg,prompts", SERVE_CASES)
def test_batched_server_greedy_equals_repro(arch, seed, cfg, prompts):
    jspec, jparams, spec, model = _pair(arch, seed)
    got = BatchedServer(spec, model, ServeConfig(**cfg)).generate(prompts)
    want = JaxServer(jspec, jparams, JaxServeConfig(**cfg)).generate(prompts)
    assert got == want
    assert all(len(o) == cfg["max_new_tokens"] for o in got)


def test_batched_server_eos_stop_equals_repro():
    jspec, jparams, spec, model = _pair("smollm-135m", 0)
    cfg = dict(batch_size=2, max_new_tokens=8, cache_len=32)
    eos = BatchedServer(spec, model, ServeConfig(**cfg)).generate([[1, 2]])[0][0]
    got = BatchedServer(spec, model, ServeConfig(**cfg, eos_id=eos)).generate([[1, 2], [3]])
    want = JaxServer(jspec, jparams, JaxServeConfig(**cfg, eos_id=eos)).generate([[1, 2], [3]])
    assert got == want and got[0] == [eos]


def test_sampling_is_seeded():
    _, _, spec, model = _pair("smollm-135m", 0)
    cfg = ServeConfig(batch_size=2, max_new_tokens=6, cache_len=16, temperature=1.0, seed=5)
    a = BatchedServer(spec, model, cfg).generate([[1, 2], [3]])
    b = BatchedServer(spec, model, cfg).generate([[1, 2], [3]])
    assert a == b and all(0 <= t < spec.lm.vocab_padded for o in a for t in o)


# ----------------------------------------------------------------- convert
def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


@pytest.mark.parametrize("arch,dtype", [("smollm-135m", "float32"), ("qwen2-0.5b", "float32"),
                                        ("smollm-135m", "bfloat16"),
                                        ("starcoder2-7b", "bfloat16")])
def test_convert_round_trip_is_bitwise(arch, dtype):
    jspec = jax_get_arch(arch, reduced=True)
    cfg = dataclasses.replace(jspec.lm, dtype=dtype)
    tree = jax.tree_util.tree_map(np.asarray, JT.init_lm_params(jax.random.PRNGKey(9), cfg))
    pcfg = dataclasses.replace(get_arch(arch, reduced=True).lm, dtype=dtype)
    model = convert.lm_params_from_numpy(pcfg, tree, device="cpu")
    assert model.embed.dtype == T.torch_dtype(dtype)
    back = convert.lm_model_to_numpy(model)
    want, treedef = jax.tree_util.tree_flatten(tree)
    got, treedef2 = jax.tree_util.tree_flatten(back)
    assert treedef == treedef2
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(_bits(g), _bits(w))
    # the port's layer i is repro's stacked (rep, off) leaf
    p = pcfg.period()
    wq = tree["layers"][1 % p]["attn"]["wq"][1 // p]
    assert np.array_equal(_bits(model.layers[1].attn.wq.detach()
                                .view(torch.int16 if dtype == "bfloat16" else torch.int32)
                                .numpy()), _bits(wq))


def test_convert_rejects_a_mismatched_tree():
    jspec = jax_get_arch("qwen2-0.5b", reduced=True)
    tree = jax.tree_util.tree_map(np.asarray, jspec.init_params(jax.random.PRNGKey(0)))
    spec = get_arch("smollm-135m", reduced=True)  # other widths, no biases
    with pytest.raises((KeyError, ValueError)):
        convert.lm_params_from_numpy(spec.lm, tree, device="cpu")
    bf = dataclasses.replace(get_arch("qwen2-0.5b", reduced=True).lm, dtype="bfloat16")
    with pytest.raises(TypeError):
        convert.lm_params_from_numpy(bf, tree, device="cpu")


def test_port_init_is_seeded_and_scaled():
    spec = get_arch("qwen2-0.5b", reduced=True)
    a = spec.init_params(torch.Generator().manual_seed(0), "cpu")
    b = spec.init_params(torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    assert set(a.state_dict()) == set(convert.lm_param_shapes(spec.lm))
    d = spec.lm.d_model
    assert abs(a.layers[0].attn.wq.std().item() * np.sqrt(d) - 1) < 0.05
    assert torch.equal(a.layers[0].attn.bq, torch.zeros_like(a.layers[0].attn.bq))
    assert torch.equal(a.final_norm.scale, torch.ones(d))
