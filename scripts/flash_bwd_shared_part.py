#!/usr/bin/env python3
"""The bf16 flash backward where queries or keys share a large part, on one
CUDA card (ROADMAP C9).

    python3 scripts/flash_bwd_shared_part.py

dQ sums dS K over keys whose dS row sums to zero, so a part every key
shares cancels exactly; dS rounded to bf16 once leaves it in at 2^-9 of
each term (dK likewise over queries). Whisper's decoder has such parts: each
position carries much the same cross-attention output. For the bf16
backward calls of Whisper-tiny's first training step (full width, the
port's seed-0 init, B 8 x 448 tokens over 1,500 frames, through
``repro_torch.launch.train``) and for seeded inputs with a shared query or
key part, it prints each gradient's row-scaled distance to
``attention_bwd_ref`` (``chip_smoke._row_rel``, the floor of
``chip_smoke.py``'s bound) for the kernel, its arithmetic as
``chip_smoke.bwd_kernel_emulation`` emulates it (dS split into two bf16
parts), the same with dS rounded once (the arithmetic before the split),
and the backward of ``scaled_dot_product_attention`` through autograd, one
JSON line a call, beside the bound (2^-6).
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import flash_attn as fa_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train as lm_train

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False

    def rel(got, want):
        return {n: cs._row_rel(g, w, cs.FLASH_BWD_ROW_FLOOR) for n, g, w in zip("qkv", got, want)}

    def report(source, q, k, v, o, lse, do, causal):
        plain = ref.attention_bwd_ref(q, k, v, o, lse, do, causal, None)
        leaves = [t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves, is_causal=causal, enable_gqa=True)
        lib = [g.transpose(1, 2) for g in torch.autograd.grad(lib_out, leaves,
                                                              do.transpose(1, 2))]
        print(json.dumps({
            "source": source, "shape": list(q.shape), "kv_heads": k.shape[2], "causal": causal,
            "bound": cs.FLASH_BWD_BF16_ROW_REL,
            "kernel": rel(fa_mod.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal, None),
                          plain),
            "emulation_split": rel(cs.bwd_kernel_emulation(q, k, v, o, lse, do, causal), plain),
            "emulation_rounded_once": rel(cs.bwd_kernel_emulation(q, k, v, o, lse, do, causal,
                                                                  ds_split=False), plain),
            "sdpa": rel(lib, plain)}), flush=True)

    kept: dict = {}
    restore = cs._keeping_first(ops, "flash_attention_bwd", lambda a: (
        tuple(a[0].shape), str(a[0].dtype), a[6]), kept)
    try:
        lm_train.run(lm_train.parser().parse_args(
            ["--arch", "whisper-tiny", "--batch", "8", "--seq", "448", "--steps", "1",
             "--seed", "0"]))
    finally:
        restore()
    for (_, dtype, causal), (q, k, v, o, lse, do, *_rest) in kept.items():
        if dtype == "torch.bfloat16":
            report("whisper-tiny training step 1", q, k, v, o, lse, do, causal)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for q_part, k_part in ((0.0, 8.0), (8.0, 0.0)):
        B, S, H, hd = 2, 448, 6, 64
        q, k = (torch.randn(B, S, H, hd, device="cuda", generator=gen)
                + part * torch.randn(1, 1, H, hd, device="cuda", generator=gen)
                for part in (q_part, k_part))
        v = torch.randn(B, S, H, hd, device="cuda", generator=gen)
        do = torch.randn(B, S, H, hd, device="cuda", generator=gen) * 1e-5
        q, k, v, do = (t.bfloat16() for t in (q, k, v, do))
        o, lse = fa_mod.flash_attention_cuda(q, k, v, True, None, with_lse=True)
        report(f"seeded, shared query part {q_part}, key part {k_part}", q, k, v, o, lse, do,
               True)


if __name__ == "__main__":
    main()
