// In-batch softmax cross-entropy rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/inbatch_loss.py:inbatch_loss_rows_pallas
// (pallas_call at :55): (P, d) f32 sources and (P, d) f32 destinations give,
// per row i, logsumexp_j(src_i . dst_j / t) - src_i . dst_i / t over the
// P columns j (the in-batch negatives of paper section 3.6). The loss is the
// mean of the rows, taken by the caller.
//
// What bounds it on this card: operations. 2 * P * P * d FLOP in f32 FMA on
// the CUDA cores (no TF32: it would move near-tied logits by far more than
// the 1e-5 the port holds against XLA); at the training path's P = 512,
// d = 64 that is 33.6 MFLOP, 0.5 us at 67 TFLOP/s, while the inputs are
// 262 KB (0.08 us at 3.35 TB/s). Both are below the cost of a launch.
//
// How the design answers it:
//   - The TPU version keeps the whole (P, d) destination block resident in
//     VMEM next to each source tile. A block here has at most 227 KB of
//     shared memory, so a block owns kTS source rows and loops over tiles of
//     kTD destination rows staged through shared memory, keeping a running
//     max and sum per row (online log-sum-exp): the working set is
//     (kTS + kTD) rows of d, whatever P is.
//   - One warp per source row; lane j scores destination rows j and j + 32
//     of the tile: two independent FMA chains per lane, one warp max and
//     one warp sum per 64 columns. The tile is stored transposed with a
//     padded row (d rows of kTD + 1), so the coalesced global read, the
//     store and the lanes' reads are all free of bank conflicts, and the
//     source row is a warp broadcast. Each dot product runs over d in order
//     with fmaf.
//   - Columns at or past P (the ragged last tile) score -inf and add 0.
//   - The diagonal logit is taken from the tile that holds column i, by the
//     lane that owns it; a warp sum of one value and 31 zeros is exact.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTS = kWarps;    // source rows per block, one per warp
constexpr int kTD = 64;        // destination rows per tile, two per lane
constexpr int kTDS = kTD + 1;  // padded row of the transposed tile

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void inbatch_rows_kernel(const float* __restrict__ src,
                                    const float* __restrict__ dst,
                                    float* __restrict__ out, int p, int d,
                                    float temperature) {
  extern __shared__ float smem[];
  float* s_src = smem;             // (kTS, d)
  float* s_dst = smem + kTS * d;   // (d, kTD + 1): the tile, transposed
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row = blockIdx.x * kTS + warp;

  for (int i = tid; i < kTS * d; i += kThreads) {
    const int r = blockIdx.x * kTS + i / d;
    s_src[i] = (r < p) ? src[(long long)r * d + (i % d)] : 0.0f;
  }

  const float* srow = s_src + warp * d;
  float m = -INFINITY, s = 0.0f, diag = 0.0f;
  for (int t0 = 0; t0 < p; t0 += kTD) {
    __syncthreads();  // the previous tile is consumed (and s_src is staged)
    for (int i = tid; i < kTD * d; i += kThreads) {
      const int j = i / d, k = i % d;
      s_dst[k * kTDS + j] = (t0 + j < p) ? dst[(long long)(t0 + j) * d + k] : 0.0f;
    }
    __syncthreads();
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll 8
    for (int k = 0; k < d; ++k) {
      const float sv = srow[k];
      a0 = fmaf(sv, s_dst[k * kTDS + lane], a0);
      a1 = fmaf(sv, s_dst[k * kTDS + 32 + lane], a1);
    }
    const int c0 = t0 + lane, c1 = t0 + 32 + lane;
    const float l0 = (c0 < p) ? a0 / temperature : -INFINITY;
    const float l1 = (c1 < p) ? a1 / temperature : -INFINITY;
    if (c0 == row) diag = l0;
    if (c1 == row) diag = l1;
    const float new_m = fmaxf(m, warp_max(fmaxf(l0, l1)));
    const float e = ((c0 < p) ? expf(l0 - new_m) : 0.0f) + ((c1 < p) ? expf(l1 - new_m) : 0.0f);
    const float scale = (m == -INFINITY) ? 0.0f : expf(m - new_m);
    s = s * scale + warp_sum(e);
    m = new_m;
  }
  const float dg = warp_sum(diag);
  if (lane == 0 && row < p) out[row] = (logf(s) + m) - dg;
}

}  // namespace

// src, dst: (p, d) f32 contiguous; out: (p,) f32. Returns cudaGetLastError()
// after the launch; the caller raises on anything but 0.
extern "C" int g4r_inbatch_rows_f32(const float* src, const float* dst,
                                    float* out, int p, int d,
                                    float temperature, void* stream) {
  if (p <= 0) return (int)cudaGetLastError();
  if (d <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)kTS * d + (size_t)d * kTDS);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        inbatch_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (p + kTS - 1) / kTS;
  inbatch_rows_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      src, dst, out, p, d, temperature);
  return (int)cudaGetLastError();
}
