#!/usr/bin/env python3
"""The f32 flash forward's shapes (``F32Cfg`` in ``csrc/flash_attn.cu``:
threads and warps a row, rows and keys a thread, blocks an SM, P over K)
against each other, on one CUDA card.

    python3 scripts/flash_f32_variants.py [--rounds 2]

Builds ``csrc/flash_attn.cu`` once more, into ``build/flash_f32_variants/``,
with every shape of ``VARIANTS`` instantiated beside the ones the kernel
runs (``F32Fwd``), and a kernel of f32 FMAs alone, whose rate is the
card's sustained f32 peak; prints that rate, per shape its registers,
local memory and shared memory, and per head dim a training call (causal,
with the LSE):
smollm-135m's at hd 64 (B 4, S 2,048, H 9, K 3), OLMoE-1B-7B's at hd 128
(H = K = 16), and a stand-in at hd 32 (H 8, K 4), where no full-width model
sits. Each shape's output and LSE are held to ``attention_fwd_ref``
(``chip_smoke.py``'s FLASH_RTOL / FLASH_ATOL and FLASH_LSE_RTOL) and its
re-run bitwise; then all are timed in turns, in order and back
(``--rounds`` times), by ``chip_smoke.measure``'s device time. One JSON
line a head dim.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# hd -> (THREADS, KW, RQ, RK, MIN_BLOCKS, P_IN_K); the first is F32Fwd<hd>, the shape the
# kernel runs
VARIANTS = {
    64: [(128, 1, 8, 8, 2, False), (256, 2, 8, 8, 1, False), (128, 1, 4, 8, 2, False),
         (256, 2, 4, 4, 2, False)],
    128: [(256, 2, 8, 8, 1, True), (128, 1, 4, 8, 2, True), (256, 2, 4, 4, 2, True)],
    32: [(128, 1, 8, 8, 2, False), (256, 2, 8, 8, 1, False), (256, 2, 4, 4, 2, False)],
}
SHAPES = {64: (4, 2048, 9, 3), 128: (4, 2048, 16, 16), 32: (4, 2048, 8, 4)}


def _source() -> str:
    """A translation unit that includes the kernel's source and adds one
    launcher and one attributes entry over every variant."""
    rows = [(hd, v) for hd, vs in VARIANTS.items() for v in vs]
    cfg = ["F32Cfg<%d, %d, %d, %d, %d, %d, %s>" % (hd, *v[:5], "true" if v[5] else "false")
           for hd, v in rows]
    launch = "\n".join(
        f"    case {i}: return launch_f32<{hd}, {c}>(q, k, v, o, lse, b_rows, sq, skv, heads, "
        "group, st, scale, causal, window, (cudaStream_t)stream);"
        for i, ((hd, _), c) in enumerate(zip(rows, cfg)))
    attrs = "\n".join(
        f"    case {i}: return fill_attrs((const void*)flash_fwd_kernel<{hd}, {c}>, "
        f"{c}::SMEM, out);" for i, ((hd, _), c) in enumerate(zip(rows, cfg)))
    return f"""#include "flash_attn.cu"

extern "C" int g4r_variant_fwd(int which, const void* q, const void* k, const void* v, void* o,
                               float* lse, int b_rows, int sq, int skv, int heads, int group,
                               const long long* st, float scale, int causal, int window,
                               void* stream) {{
  switch (which) {{
{launch}
  }}
  return (int)cudaErrorInvalidValue;
}}

extern "C" int g4r_variant_attrs(int which, int* out) {{
  switch (which) {{
{attrs}
  }}
  return (int)cudaErrorInvalidValue;
}}

// the f32 FMA rate the card sustains: 16 independent chains a thread, no memory
// traffic but one store a thread
__global__ void __launch_bounds__(256) fma_peak_kernel(float* out, int iters) {{
  float a[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = threadIdx.x * 1e-3f + i;
  const float x = 0.999f, y = 1e-4f;
  for (int n = 0; n < iters; ++n) {{
#pragma unroll
    for (int i = 0; i < 16; ++i) a[i] = fmaf(a[i], x, y);
  }}
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) s += a[i];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}}

extern "C" int g4r_fma_peak(float* out, int blocks, int iters, void* stream) {{
  fma_peak_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}}
"""


def build_variants(build) -> ctypes.CDLL:
    out_dir = os.path.join(ROOT, "build", "flash_f32_variants")
    os.makedirs(out_dir, exist_ok=True)
    src, lib = os.path.join(out_dir, "variants.cu"), os.path.join(out_dir, "libvariants.so")
    with open(src, "w") as f:
        f.write(_source())
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(build.CSRC),
           "-shared", src, "-o", lib]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        sys.exit(f"flash_f32_variants: nvcc failed:\n{res.stdout}\n{res.stderr}")
    so = ctypes.CDLL(lib)
    so.g4r_variant_fwd.argtypes = [ctypes.c_int, *(ctypes.c_void_p,) * 5, *(ctypes.c_int,) * 5,
                                   ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p]
    so.g4r_variant_attrs.argtypes = [ctypes.c_int, ctypes.c_void_p]
    so.g4r_fma_peak.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return so


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("flash_f32_variants: needs a CUDA card")
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke
    from repro_torch.kernels import build, ref

    so = build_variants(build)
    stream = torch.cuda.current_stream().cuda_stream
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    # the sustained FMA rate: 8 blocks of 256 threads an SM, 16 chains of 4,096 FMAs each
    blocks, iters = 8 * torch.cuda.get_device_properties(0).multi_processor_count, 4096
    sink = torch.empty(blocks * 256, device="cuda")
    peak_ms = chip_smoke.measure(
        lambda: build.check(so.g4r_fma_peak(sink.data_ptr(), blocks, iters, stream), "fma peak"),
        20)["device_ms"]
    print(json.dumps({"what": "fma_peak", "card": smi, "blocks": blocks, "iters": iters,
                      "ms": peak_ms,
                      "tflop_per_s": 2.0 * 16 * iters * blocks * 256 / peak_ms / 1e9}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(6)
    which = 0
    for hd, variants in VARIANTS.items():
        B, S, H, K = SHAPES[hd]
        q = torch.randn(B, S, H, hd, device="cuda", generator=gen)
        k, v = (torch.randn(B, S, K, hd, device="cuda", generator=gen) for _ in range(2))
        out, lse = torch.empty_like(q), torch.empty((B, H, S), device="cuda")
        st = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                      *out.stride()[:3])
        want, want_lse = chip_smoke._flash_fwd_plain(torch, ref, q, k, v, True, None)
        ids = list(range(which, which + len(variants)))
        which += len(variants)

        def fwd(i):
            err = so.g4r_variant_fwd(i, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     out.data_ptr(), lse.data_ptr(), B, S, S, H, H // K, st,
                                     1.0 / math.sqrt(hd), 1, 0, stream)
            build.check(err, f"flash f32 variant {i}")

        recs = {}
        for i, var in zip(ids, variants):
            a = (ctypes.c_int * 3)()
            build.check(so.g4r_variant_attrs(i, a), "variant attributes")
            fwd(i)
            first = (out.clone(), lse.clone())
            fwd(i)
            torch.cuda.synchronize()
            name = "threads{} kw{} rq{} rk{} blocks{}{}".format(
                *var[:5], " p_in_k" if var[5] else "")
            ok = (torch.allclose(first[0], want, rtol=chip_smoke.FLASH_RTOL,
                                 atol=chip_smoke.FLASH_ATOL)
                  and torch.allclose(first[1], want_lse, rtol=chip_smoke.FLASH_LSE_RTOL,
                                     atol=chip_smoke.FLASH_LSE_ATOL))
            recs[name] = {"registers": a[0], "local_bytes": a[1], "shared_bytes": a[2],
                          "right": ok, "rerun_bitwise": torch.equal(first[0], out)
                          and torch.equal(first[1], lse),
                          "max_abs_err": (first[0] - want).abs().max().item(), "ms": []}
        order = list(zip(ids, recs))
        for _ in range(args.rounds):
            for i, name in order + order[::-1]:
                recs[name]["ms"].append(chip_smoke.measure(lambda: fwd(i), 10)["device_ms"])
        pairs = S * (S + 1) // 2
        flops = 4.0 * hd * pairs * B * H
        print(json.dumps({"what": "flash_f32_variants", "card": smi, "hd": hd,
                          "shape": {"B": B, "S": S, "H": H, "K": K, "causal": True},
                          "f32_core_bound_ms": flops / chip_smoke.FP32_FLOP_PER_S * 1e3,
                          "runs": f"F32Fwd<{hd}> is the first", "variants": recs}),
              flush=True)
        bad = [n for n, r in recs.items() if not (r["right"] and r["rerun_bitwise"])]
        if bad:
            sys.exit(f"flash_f32_variants: hd {hd}: {bad} disagree with attention_fwd_ref or "
                     "are not bitwise on a re-run")
        del q, k, v, out, lse, want, want_lse


if __name__ == "__main__":
    main()
