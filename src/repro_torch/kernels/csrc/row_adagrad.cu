// Row-wise AdaGrad applied in place to the rows a batch touched, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/row_adagrad.py:row_adagrad_scatter_pallas
// (pallas_call at :76): for every bucket slot b whose id is not PAD,
//     accum[id] += mean(g[b]^2);  table[id] -= lr * g[b] / (sqrt(accum[id]) + eps)
// on an (N, D) f32 table and its (N, 1) f32 accumulators, in place. Rows no
// slot names are not touched: the sparse step's O(unique ids) update (the
// paper's parameter-server push, section 3.6).
//
// What bounds it on this card: bytes. Each slot reads its gradient row and
// its table row and writes the table row back (12 * D bytes, plus the
// accumulator), with a handful of operations per element; at the training
// path's node bucket of 32,768 slots and D = 64 that is 25 MB, 7.5 us at
// 3.35 TB/s.
//
// How the design answers it, and the hazard it removes:
//   - One warp per slot: lanes walk the row's D columns (coalesced 128-byte
//     accesses), a warp sum gives mean(g^2), and lane 0 alone reads and
//     writes the accumulator, broadcasting the new value by shuffle.
//   - The Pallas version clamps PAD ids to row 0 and writes row 0 back
//     unchanged, which is right only because the TPU grid runs in order with
//     the PADs first, before row 0's real update. Blocks here run
//     concurrently, so a clamped PAD write could land after the real one and
//     undo it. PAD slots (id < 0) are therefore skipped, never clamped. Real
//     ids are distinct by construction (embedding.table.unique_pad_ids), so
//     no two warps write one row. Ids at or past N are dropped as well, the
//     way the plain version's scatter drops them.
//   - Built without --use_fast_math: sqrtf and the division stay IEEE.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps, one slot each
constexpr int kWarps = kThreads / 32;

__global__ void row_adagrad_kernel(float* __restrict__ table,
                                   float* __restrict__ accum,
                                   const long long* __restrict__ ids,
                                   const float* __restrict__ grads,
                                   long long n, long long bucket, int d,
                                   float lr, float eps) {
  const int lane = threadIdx.x % 32;
  const long long b = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (b >= bucket) return;
  const long long id = ids[b];
  if (id < 0 || id >= n) return;  // PAD slot (or out of range): skipped
  const float* g = grads + b * d;
  float* row = table + id * d;
  float sq = 0.0f;
  for (int c = lane; c < d; c += 32) sq += g[c] * g[c];
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  float acc = 0.0f;
  if (lane == 0) acc = accum[id] + sq / (float)d;
  acc = __shfl_sync(0xffffffffu, acc, 0);
  const float denom = sqrtf(acc) + eps;
  for (int c = lane; c < d; c += 32) row[c] = row[c] - lr * g[c] / denom;
  if (lane == 0) accum[id] = acc;
}

}  // namespace

// table (n, d) f32, accum (n, 1) f32, ids (bucket,) int64, grads (bucket, d)
// f32, all contiguous. Returns cudaGetLastError() after the launch.
extern "C" int g4r_row_adagrad_f32(float* table, float* accum,
                                   const long long* ids, const float* grads,
                                   long long n, long long bucket, int d,
                                   float lr, float eps, void* stream) {
  if (bucket <= 0) return (int)cudaGetLastError();
  if (d <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (bucket + kWarps - 1) / kWarps;
  row_adagrad_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      table, accum, ids, grads, n, bucket, d, lr, eps);
  return (int)cudaGetLastError();
}
