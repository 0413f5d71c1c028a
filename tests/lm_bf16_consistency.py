"""bf16 prefill vs decode at full width: the port and ``repro`` on the same
weights and prompts, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/lm_bf16_consistency.py [B S [ARCH]]

``ARCH`` (default ``smollm-135m``; ``mamba2-1.3b`` for Mamba2's) at full
width in bf16 with the port's init (seed 0, drawn on the CPU as
``chip_smoke.py`` draws it), converted to ``repro``'s tree with
``convert.lm_model_to_numpy``; the prompts are the first S (default 256)
of ``chip_smoke.py``'s B (default 4) x 2,048 tokens from
``default_rng(0)``; logits past the vocabulary (padding, -1e30 in every
path) are left out. Each path's last prefill logits
against the last of S decode steps, in repro's measure (max |a - b| /
max |b|, tests/test_models.py): the port's, repro's with its naive
attention (the default, p rounded to bf16 before PV) and with its flash
kernel (Pallas interpret; p stays f32, as in the port), and the paths
against each other. Prints one JSON line. Not a test: about two minutes
at the default size.
"""
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.models import transformer as T


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def main(B: int = 4, S: int = 256, arch: str = "smollm-135m") -> dict:
    spec = get_arch(arch)
    cfg = spec.lm
    model = spec.init_params(torch.Generator().manual_seed(0), "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, size=(4, 2048))[:B, :S]
    with torch.no_grad():
        full = spec.make_prefill()(model, {"tokens": torch.from_numpy(toks)}).float().numpy()
        cache = T.init_cache(cfg, B, S, "cpu")
        for i in range(S):
            dec, cache = T.decode_step(model, cfg, cache, torch.from_numpy(toks[:, i:i + 1]))
    V = cfg.vocab
    full, dec = full[:, :V], dec.float().numpy()[:, :V]

    params = jax.tree_util.tree_map(jnp.asarray, convert.lm_model_to_numpy(model))
    jspec = jax_get_arch(arch)
    jt = jnp.asarray(toks, jnp.int32)
    jfull = {}
    for flash in (False, True):
        jcfg = dataclasses.replace(jspec.lm, use_flash=flash)
        logits, _ = jax.jit(lambda p, t, c=jcfg: JT.forward(p, c, t))(params, jt)
        jfull[flash] = np.asarray(logits[:, -1, :V].astype(jnp.float32))
    jcache = JT.init_cache(jspec.lm, B, S)
    step = jax.jit(lambda p, c, t: JT.decode_step(p, jspec.lm, c, t))
    for i in range(S):
        jdec, jcache = step(params, jcache, jt[:, i:i + 1])
    jdec = np.asarray(jdec.reshape(B, -1)[:, :V].astype(jnp.float32))
    return {"arch": spec.arch_id, "dtype": cfg.dtype, "prompts": [B, S],
            "port_prefill_vs_decode": rel(dec, full),
            "repro_naive_prefill_vs_decode": rel(jdec, jfull[False]),
            "repro_flash_prefill_vs_decode": rel(jdec, jfull[True]),
            "repro_flash_vs_naive_prefill": rel(jfull[True], jfull[False]),
            "port_vs_repro_flash_prefill": rel(full, jfull[True]),
            "port_vs_repro_decode": rel(dec, jdec)}


if __name__ == "__main__":
    print(json.dumps(main(*map(int, sys.argv[1:3]), *sys.argv[3:4])), flush=True)
