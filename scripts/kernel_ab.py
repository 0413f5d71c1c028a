#!/usr/bin/env python3
"""The port's ``seg_aggr`` backward, ``row_adagrad`` and flash attention
(backward and forward) kernels against other checkouts', on one CUDA card.

    python3 scripts/kernel_ab.py --other DIR [--rounds 2]

DIR is a checkout of another commit (for example the parent, unpacked with
``git archive`` into a directory that ``.gitignore`` lists); its kernels
are built from its own sources into its own ``build/`` and named "other"
below. To compare a third tree, run the script again with it as DIR.

Flash: at the LM training call (smollm-135m: B 4, S 2,048, H 9, K 3, hd
64, causal) in f32 and in bf16, and at ``chip_smoke.py``'s causal f32
synthetic calls: qwen2-0.5b's layout on one batch row (B 1, S 512, H 14, K
2, hd 64) and B 2, S 256 and 200, H 4, K 2, hd 64; on seeded q, k, v and dO with this tree's forward's output
and LSE, the backward through each tree's ``g4r_flash_attn_bwd`` (scratch
sized by this tree's ``bwd_plan``, which covers the earlier layouts at
these calls), each held to ``attention_bwd_ref`` by ``chip_smoke.flash_bwd_ok``
and its re-run bitwise, timed in turns (other, this, this, other;
``--rounds`` times) beside SDPA's backward; then the forward through each
tree's ``g4r_flash_attn_fwd`` at the prefill call (bf16, no LSE), bitwise
this tree's, and at the f32 training calls with their LSE (smollm's, and
OLMoE-1B-7B's: B 4, S 2,048, H = K = 16, hd 128, causal), each tree's
output and LSE held to ``attention_fwd_ref`` (``chip_smoke.py``'s
FLASH_RTOL / FLASH_ATOL and FLASH_LSE_RTOL), every re-run bitwise, timed in
the same turns beside SDPA's forward and the bound.

Training kernels: at the training
paths' recorded shapes (the calls ``chip_smoke.py`` keeps: backward
[4096, 3, 64] and [512, 4, 64] on the host path, [2736, 3, 64] and
[342, 4, 64] on the fused one, each mask a relation's row-strided view;
``row_adagrad`` on a (28,000, 64) table at buckets 2,048 and 4,096 and a
(64, 64) one), on inputs made from a seed (the backward's g and mask
with the recorded calls' shares of all-zero rows and of rows with every
neighbour valid), it times in turns, other then
this tree, this tree, other (``--rounds`` times): each kernel through the
same C entry point; then this tree's backward in mode ``sum`` and on its
4-byte path; the plain version; the library call;
an empty kernel of one block and of one wave of 256-thread blocks; and
PyTorch's add on one element. Every time is ``chip_smoke.measure``'s
device time. Both trees' outputs are held to the plain version (the
backward bitwise, ``row_adagrad`` to 1e-5). One JSON line a shape on
standard output.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (N, F, D), and the shares of all-zero rows of g and of rows whose F mask
# bytes are all set that the recorded calls carry (the others have none set)
BWD_SHAPES = [(4096, 3, 64, 0.5, 0.25), (512, 4, 64, 0.0, 0.5), (2736, 3, 64, 0.74, 0.15),
              (342, 4, 64, 0.47, 0.3)]
ADAGRAD_SHAPES = [(28000, 64, 2048, 2006), (28000, 64, 4096, 3327), (64, 64, 64, 64)]


def _load_module(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="a checkout of a commit to compare with")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_ab: needs a CUDA card")
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke
    from repro_torch.kernels import build, ref, seg_aggr

    other = _load_module("other_build", os.path.join(
        os.path.abspath(args.other), "src", "repro_torch", "kernels", "build.py")).library()
    lib = build.library()
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    measure = chip_smoke.measure

    def emit(rec):
        print(json.dumps(rec), flush=True)

    def ms(fn, iters=200):
        return measure(fn, iters)["device_ms"]

    gen = torch.Generator(device="cuda").manual_seed(0)
    one = torch.zeros(1, device="cuda")
    emit({"what": "floors", "card": torch.cuda.get_device_name(0),
          "empty_one_block_ms": ms(lambda: lib.g4r_empty(1, 32, stream)),
          "empty_one_wave_ms": ms(lambda: lib.g4r_empty(sms * 8, 256, stream)),
          "torch_add_one_element_ms": ms(lambda: one.add_(1.0))})
    flash_ab(torch, other, lib, stream, args.rounds, emit)

    for n, f, d, zero_rows, valid_rows in BWD_SHAPES:
        g = torch.randn(n, d, device="cuda", generator=gen)
        g[torch.rand(n, device="cuda", generator=gen) < zero_rows] = 0.0
        full = (torch.rand(n, 2, 1, device="cuda", generator=gen) < valid_rows).expand(n, 2, f)
        mask = full.contiguous()[:, 1]
        want = {m: ref.seg_aggr_bwd_ref(g, mask, m) for m in ("mean", "sum")}
        mf = mask.float()
        w = mf / mf.sum(1, keepdim=True).clamp(min=1.0)  # chip_smoke.py's library yardstick

        def entry(which, mode="mean", gg=g):
            dx = torch.empty(n, f, d, device="cuda")
            err = which.g4r_seg_aggr_bwd_f32(gg.data_ptr(), mask.data_ptr(), dx.data_ptr(), n, f,
                                             d, mask.stride(0), seg_aggr.MODES[mode], stream)
            build.check(err, "seg_aggr backward")
            return dx

        for which in (other, lib):
            if not torch.equal(entry(which), want["mean"]):
                sys.exit(f"kernel_ab: a backward at {(n, f, d)} is not bitwise its plain version")
        turns = {"other": [], "this": []}
        for _ in range(args.rounds):
            for who in ("other", "this", "this", "other"):
                turns[who].append(ms(lambda: entry(other if who == "other" else lib)))
        base = torch.zeros(g.numel() + 1, device="cuda")
        g4 = base[1:].view(n, d)  # one float past 16 bytes: the 4-byte path
        g4.copy_(g)
        rec = {"what": "seg_aggr_bwd", "shape": [n, f, d], "mask_row_stride": mask.stride(0),
               "zero_rows": zero_rows, "valid_rows": valid_rows,
               "ms_other": turns["other"], "ms_this": turns["this"],
               "this_sum_ms": ms(lambda: entry(lib, "sum")),
               "this_4byte_ms": ms(lambda: entry(lib, "mean", g4)),
               "plain_ms": ms(lambda: ref.seg_aggr_bwd_ref(g, mask, "mean")),
               "library_ms": ms(lambda: g[:, None, :] * w[..., None])}
        if not (torch.equal(entry(lib, "sum"), want["sum"])
                and torch.equal(entry(lib, "mean", g4), want["mean"])):
            sys.exit(f"kernel_ab: sum or the 4-byte path at {(n, f, d)} is not bitwise")
        emit(rec)

    for n, d, bucket, real in ADAGRAD_SHAPES:
        table = torch.randn(n, d, device="cuda", generator=gen)
        accum = 0.1 + torch.rand(n, 1, device="cuda", generator=gen)
        rows = torch.randperm(n, device="cuda", generator=gen)[:real].sort().values
        ids = torch.cat([torch.full((bucket - real,), -1, device="cuda", dtype=torch.long), rows])
        grads = torch.randn(bucket, d, device="cuda", generator=gen)
        grads[: bucket - real] = 0.0

        def step(which, t, a):
            err = which.g4r_row_adagrad_f32(t.data_ptr(), a.data_ptr(), ids.data_ptr(),
                                            grads.data_ptr(), n, bucket, d, 0.05, 1e-8, stream)
            build.check(err, "row_adagrad")

        tp, ap = table.clone(), accum.clone()
        ref.row_adagrad_scatter_ref(tp, ap, ids, grads, 0.05, 1e-8)
        for which in (other, lib):
            t, a = table.clone(), accum.clone()
            step(which, t, a)
            if not (torch.allclose(t, tp, rtol=1e-5, atol=1e-6)
                    and torch.allclose(a, ap, rtol=1e-5, atol=1e-6)):
                sys.exit(f"kernel_ab: row_adagrad at {(n, d, bucket)} disagrees with its plain "
                         "version")
        t, a = table.clone(), accum.clone()
        turns = {"other": [], "this": []}
        for _ in range(args.rounds):
            for who in ("other", "this", "this", "other"):
                turns[who].append(ms(lambda: step(other if who == "other" else lib, t, a)))
        emit({"what": "row_adagrad", "shape": {"N": n, "D": d, "bucket": bucket, "real_ids": real},
              "ms_other": turns["other"], "ms_this": turns["this"],
              "plain_ms": ms(lambda: ref.row_adagrad_scatter_ref(t, a, ids, grads, 0.05, 1e-8),
                             50)})


def flash_ab(torch, other, lib, stream, rounds: int, emit) -> None:
    """The flash backward and forward of the other tree against this
    tree's, at the training and prefill calls (the module docstring)."""
    import ctypes
    import math

    import chip_smoke
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attn as fa

    trees = {"other": other, "this": lib}
    gen = torch.Generator(device="cuda").manual_seed(5)

    def turns(fn):
        out = {name: [] for name in trees}
        for _ in range(rounds):
            for name in ("other", "this", "this", "other"):
                out[name].append(chip_smoke.measure(lambda: fn(trees[name]), 10)["device_ms"])
        return out

    for (B, S, H, K, hd), dtype in (((4, 2048, 9, 3, 64), torch.float32),
                                    ((4, 2048, 9, 3, 64), torch.bfloat16),
                                    ((1, 512, 14, 2, 64), torch.float32),
                                    ((2, 256, 4, 2, 64), torch.float32),
                                    ((2, 200, 4, 2, 64), torch.float32)):
        flops = 10.0 * hd * (S * (S + 1) // 2) * B * H
        q = torch.randn(B, S, H, hd, device="cuda", generator=gen).to(dtype)
        k, v = (torch.randn(B, S, K, hd, device="cuda", generator=gen).to(dtype)
                for _ in range(2))
        do = (torch.randn(B, S, H, hd, device="cuda", generator=gen) / (B * S)).to(dtype)
        o, lse = fa.flash_attention_cuda(q, k, v, True, None, with_lse=True)
        scratch = torch.empty(fa.bwd_plan(dtype, B, S, S, H, K, hd)["scratch_floats"],
                              device="cuda")
        strides = (ctypes.c_longlong * 15)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                           *o.stride()[:3], *do.stride()[:3])
        grads = [torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)]

        def bwd(which):
            err = which.g4r_flash_attn_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                lse.data_ptr(), scratch.data_ptr(), *(g.data_ptr() for g in grads),
                fa._DTYPES[dtype], B, S, S, H, K, hd, strides, 1.0 / math.sqrt(hd), 1, 0, stream)
            build.check(err, "flash_attention backward")

        want = ref.attention_bwd_ref(q, k, v, o, lse, do, True, None, block_q=1024)
        got = {}
        for name, which in trees.items():
            bwd(which)
            first = [g.clone() for g in grads]
            bwd(which)
            if not all(torch.equal(a, b) for a, b in zip(first, grads)):
                sys.exit(f"kernel_ab: the {name} flash backward ({dtype}) is not bitwise on a re-run")
            if not all(chip_smoke.flash_bwd_ok(g, w) for g, w in zip(first, want)):
                sys.exit(f"kernel_ab: the {name} flash backward ({dtype}) disagrees with "
                         "attention_bwd_ref")
            got[name] = first
        leaves = [t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)]
        sdpa = torch.nn.functional.scaled_dot_product_attention(*leaves, is_causal=True,
                                                                 enable_gqa=True)
        g_out = do.transpose(1, 2)
        times = turns(bwd)
        emit({"what": "flash_bwd", "shape": {"B": B, "S": S, "H": H, "K": K, "hd": hd},
              "dtype": str(dtype).replace("torch.", ""), "causal": True,
              "ms": times, "flop": flops,
              "tflop_per_s": {n: flops / min(t) / 1e9 for n, t in times.items()},
              "sdpa_bwd_ms": chip_smoke.measure(lambda: torch.autograd.grad(
                  sdpa, leaves, g_out, retain_graph=True), 10)["device_ms"],
              "max_abs_vs_plain": {n: [(a.float() - w.float()).abs().max().item()
                                       for a, w in zip(g, want)] for n, g in got.items()}})
        del want, got, sdpa, leaves, scratch

    # the forward: bf16 at the prefill call, bitwise the other tree's (its kernel is the
    # same); f32 at the training calls of smollm and OLMoE (with the LSE), each tree held to
    # attention_fwd_ref, since a redesign of the f32 kernel changes its order of summation
    for (B, S, H, K, hd), dtype, with_lse in (((4, 2048, 9, 3, 64), torch.bfloat16, False),
                                              ((4, 2048, 9, 3, 64), torch.float32, True),
                                              ((4, 2048, 16, 16, 128), torch.float32, True)):
        q = torch.randn(B, S, H, hd, device="cuda", generator=gen).to(dtype)
        k, v = (torch.randn(B, S, K, hd, device="cuda", generator=gen).to(dtype)
                for _ in range(2))
        out = torch.empty_like(q)
        lse = torch.empty((B, H, S), device="cuda") if with_lse else None
        st = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])

        def fwd(which):
            err = which.g4r_flash_attn_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), fa._DTYPES[dtype], B, S, S, H, K, hd,
                *st, 1.0 / math.sqrt(hd), 1, 0, stream)
            build.check(err, "flash_attention")

        got = {}
        for name, which in trees.items():
            fwd(which)
            first = (out.clone(), None if lse is None else lse.clone())
            fwd(which)
            if not (torch.equal(out, first[0]) and (lse is None or torch.equal(lse, first[1]))):
                sys.exit(f"kernel_ab: the {name} flash forward ({dtype}) is not bitwise on a "
                         "re-run")
            got[name] = first
        errs = {}
        if dtype == torch.bfloat16:
            if not torch.equal(got["other"][0], got["this"][0]):
                sys.exit("kernel_ab: the other bf16 flash forward is not bitwise this tree's")
        else:
            want, want_lse = chip_smoke._flash_fwd_plain(torch, ref, q, k, v, True, None)
            for name, (o, m) in got.items():
                if not (torch.allclose(o, want, rtol=chip_smoke.FLASH_RTOL,
                                       atol=chip_smoke.FLASH_ATOL)
                        and torch.allclose(m, want_lse, rtol=chip_smoke.FLASH_LSE_RTOL,
                                           atol=chip_smoke.FLASH_LSE_ATOL)):
                    sys.exit(f"kernel_ab: the {name} f32 flash forward at {(B, S, H, K, hd)} "
                             "disagrees with attention_fwd_ref")
                errs[name] = {"o": (o - want).abs().max().item(),
                              "lse": (m - want_lse).abs().max().item()}
            del want, want_lse
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        flops = 4.0 * hd * (S * (S + 1) // 2) * B * H
        bf16 = dtype == torch.bfloat16
        peak = chip_smoke.BF16_FLOP_PER_S if bf16 else chip_smoke.FP32_FLOP_PER_S
        sdpa = chip_smoke.measure(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 10)["device_ms"]
        emit({"what": "flash_fwd", "shape": {"B": B, "S": S, "H": H, "K": K, "hd": hd},
              "dtype": str(dtype).replace("torch.", ""), "causal": True, "with_lse": with_lse,
              "rerun_bitwise": True, "bitwise_other": bf16, "max_abs_vs_plain": errs,
              "ms": turns(fwd), "sdpa_ms": sdpa, "bound_ms": flops / peak * 1e3})
        del got, q, k, v, qt, kt, vt, out, lse

if __name__ == "__main__":
    main()
