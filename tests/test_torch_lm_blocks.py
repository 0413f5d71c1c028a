"""The port's MoE, Mamba2 and hybrid archs (Mixtral-8x22B, OLMoE-1B-7B,
Mamba2-1.3B, Jamba-v0.1-52B) against ``repro``'s on the CPU, at their
reduced configs (f32; Jamba's is one 8-layer period with every block kind).

Both packages start from ``repro``'s ``init_params(PRNGKey(k))``, converted
with ``convert.lm_params_from_numpy``. Logits, aux losses, losses, prefill
and decode logits are held to rtol/atol 1e-4 (two frameworks' f32 matmuls
and transcendentals summed in other orders, through up to eight layers),
greedy ``BatchedServer`` outputs and converted weights exactly (training:
``test_torch_lm_blocks_train.py``). The sequence lengths are multiples of
the MoE groups (64) and the SSD chunks (32), as both packages require.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import transformer as JT
from repro.serve import BatchedServer as JaxServer
from repro.serve import ServeConfig as JaxServeConfig
from repro_torch import convert
from repro_torch.configs import ShapeSpec, get_arch
from repro_torch.models import transformer as T
from repro_torch.serve import BatchedServer, ServeConfig

pytestmark = pytest.mark.quick

RTOL = ATOL = 1e-4
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


def _tokens(seed: int, B: int, S: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S)).astype(np.int32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


# ------------------------------------------------------------ the registry
def test_eight_lm_archs_are_ported():
    """The eight ``lm`` archs, with Qwen2-VL (``vlm``) and Whisper
    (``whisper``) beside them: the ten of ``repro``, each of its kind."""
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    from repro_torch.configs import ARCH_IDS

    kinds = {a: get_arch(a).kind for a in ARCH_IDS}
    assert ARCH_IDS == JAX_ARCH_IDS
    assert sorted(a for a, k in kinds.items() if k == "lm") == sorted(
        set(ARCH_IDS) - {"qwen2-vl-7b", "whisper-tiny"})
    assert (kinds["qwen2-vl-7b"], kinds["whisper-tiny"]) == ("vlm", "whisper")
    jamba = get_arch("jamba-v0.1-52b")
    assert jamba.lm.period() == 8 and jamba.lm.block_list()[4] == ("attn", "dense")
    assert set(jamba.lm.block_list()) == {("mamba", "dense"), ("mamba", "moe"),
                                          ("attn", "dense")}


def test_with_layers_cuts_whole_periods():
    period = get_arch("jamba-v0.1-52b").with_layers(8)
    assert period.lm.n_layers == 8 and period.lm.block_list() == get_arch(
        "jamba-v0.1-52b").lm.block_list()[:8]
    assert period.lm.d_model == 4096 and period.lm.moe.num_experts == 16
    two = get_arch("olmoe-1b-7b").with_layers(2)
    assert two.lm.n_layers == 2 and two.lm.block_list() == (("attn", "moe"),) * 2
    assert get_arch("smollm-135m").with_layers(3).lm.blocks == ()
    for bad in (0, 4, 40):
        with pytest.raises(ValueError, match="multiple of the period"):
            get_arch("jamba-v0.1-52b").with_layers(bad)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_port_init_dtypes_and_shapes(arch):
    """The port's own init in bf16: every leaf in bf16 but the routers and
    Mamba2's A_log / D / dt_bias (f32), shapes as lm_param_shapes says."""
    spec = get_arch(arch, reduced=True)
    cfg = dataclasses.replace(spec.lm, dtype="bfloat16")
    model = T.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    sd = model.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == convert.lm_param_shapes(cfg)
    f32 = sorted(k for k, v in sd.items() if v.dtype == torch.float32)
    assert f32 and all(k.rsplit(".", 1)[-1] in T.F32_LEAVES for k in f32)
    assert all(v.dtype == T.leaf_dtype(cfg, k) for k, v in sd.items())
    assert [b.spec() for b in model.layers] == list(cfg.block_list())


# ------------------------------------------------------- forward and loss
@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_and_loss_match_repro(arch):
    jspec, jparams, spec, model = _pair(arch, ARCHS[arch])
    toks = _tokens(11, 2, 64, spec.lm.vocab)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -3:] = -1
    logits, aux = T.forward(model, spec.lm, torch.from_numpy(toks))
    jlogits, jaux = JT.forward(jparams, jspec.lm, jnp.asarray(toks))
    assert logits.shape == (2, 64, spec.lm.vocab_padded)
    _close(logits, jlogits)
    _close(aux, jaux)
    assert (aux.item() > 0) == (spec.lm.moe is not None)
    loss = T.lm_loss(model, spec.lm, torch.from_numpy(toks), torch.from_numpy(labels))
    _close(loss, JT.lm_loss(jparams, jspec.lm, jnp.asarray(toks), jnp.asarray(labels)))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_matches_repro(arch):
    jspec, jparams, spec, model = _pair(arch, ARCHS[arch])
    toks = _tokens(7, 3, 32, spec.lm.vocab)
    got = spec.make_prefill()(model, {"tokens": torch.from_numpy(toks)})
    want = jspec.make_prefill()(jparams, {"tokens": jnp.asarray(toks)})
    assert got.shape == (3, spec.lm.vocab_padded)
    _close(got, want)


# ------------------------------------------------------------------ decode
@pytest.mark.parametrize("arch", list(ARCHS))
def test_decode_steps_match_repro(arch):
    """24 steps: Mixtral (window 16) wraps its ring; Mamba2 layers carry
    their state and conv history; MoE layers route groups of one."""
    jspec, jparams, spec, model = _pair(arch, ARCHS[arch])
    B, steps = 2, 24
    toks = _tokens(20, B, steps, spec.lm.vocab)
    cache = spec.init_cache(model, ShapeSpec("decode", 32, B, "decode"))
    jcache = JT.init_cache(jspec.lm, B, 32)
    kinds = [set(c) for c in cache["layers"]]
    assert kinds == [{"k", "v"} if m == "attn" else {"ssm", "conv"}
                     for m, _ in spec.lm.block_list()]
    step = spec.make_serve_step()
    jstep = jax.jit(jspec.make_serve_step())
    for i in range(steps):
        lg, cache = step(model, cache, {"token": torch.from_numpy(toks[:, i:i + 1])})
        jlg, jcache = jstep(jparams, jcache, {"token": jnp.asarray(toks[:, i:i + 1])})
        _close(lg, jlg)
    assert cache["t"] == steps


SERVE_CASES = [
    ("mixtral-8x22b", dict(batch_size=2, max_new_tokens=20, cache_len=64),
     [[5, 9, 1, 7, 3, 3, 8, 2], [11, 12]]),
    ("olmoe-1b-7b", dict(batch_size=3, max_new_tokens=6, cache_len=32),
     [[1, 2, 3], [4], [5, 6], [7, 8, 9, 10]]),
    ("mamba2-1.3b", dict(batch_size=2, max_new_tokens=8, cache_len=32), [[1, 2], [3, 4, 5]]),
    ("jamba-v0.1-52b", dict(batch_size=2, max_new_tokens=6, cache_len=32), [[1, 2, 3], [4]]),
]


@pytest.mark.parametrize("arch,cfg,prompts", SERVE_CASES)
def test_batched_server_greedy_equals_repro(arch, cfg, prompts):
    jspec, jparams, spec, model = _pair(arch, ARCHS[arch])
    got = BatchedServer(spec, model, ServeConfig(**cfg)).generate(prompts)
    want = JaxServer(jspec, jparams, JaxServeConfig(**cfg)).generate(prompts)
    assert got == want
    assert all(len(o) == cfg["max_new_tokens"] for o in got)


# ----------------------------------------------------------------- convert
@pytest.mark.parametrize("arch,dtype", [("jamba-v0.1-52b", "float32"),
                                        ("jamba-v0.1-52b", "bfloat16"),
                                        ("mixtral-8x22b", "bfloat16"),
                                        ("mamba2-1.3b", "bfloat16")])
def test_convert_round_trip_is_bitwise(arch, dtype):
    """bf16 trees carry f32 routers and Mamba2 scalars; both cross bitwise."""
    _, jparams = _jax_init(arch, 9, dtype)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    cfg = dataclasses.replace(get_arch(arch, reduced=True).lm, dtype=dtype)
    model = convert.lm_params_from_numpy(cfg, tree, device="cpu")
    back = convert.lm_model_to_numpy(model)
    want, treedef = jax.tree_util.tree_flatten(tree)
    got, treedef2 = jax.tree_util.tree_flatten(back)
    assert treedef == treedef2
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype.itemsize == w.dtype.itemsize
        assert np.array_equal(_bits(g), _bits(w))
    dtypes = {str(a.dtype) for a in want}
    assert dtypes == ({"float32"} if dtype == "float32" else {"bfloat16", "float32"})


def test_convert_checks_each_leafs_dtype():
    _, jparams = _jax_init("jamba-v0.1-52b", 9, "bfloat16")
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    cfg = dataclasses.replace(get_arch("jamba-v0.1-52b", reduced=True).lm, dtype="bfloat16")
    convert.lm_params_from_numpy(cfg, tree, device="cpu")
    off = 1  # (mamba, moe)
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["layers"][off]["moe"]["router"] = tree["layers"][off]["moe"]["router"].astype(
        tree["embed"].dtype)
    with pytest.raises(TypeError, match="router"):
        convert.lm_params_from_numpy(cfg, bad, device="cpu")
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["layers"][0]["mamba"]["wx"] = tree["layers"][0]["mamba"]["wx"].astype(np.float32)
    with pytest.raises(TypeError, match="wx"):
        convert.lm_params_from_numpy(cfg, bad, device="cpu")
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    del bad["layers"][off]["moe"]
    with pytest.raises(KeyError):
        convert.lm_params_from_numpy(cfg, bad, device="cpu")
