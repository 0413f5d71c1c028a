// IVF gather-then-score shortlist over int8 CSR inverted lists, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ivf.py:ivf_list_topk_pallas
// (pallas_call at :136). Per query and probe p: the list's rows start at
// starts[q, p] and number lengths[q, p] (at most lpad count); each row's
// score is (codes . q) * scale, the dot accumulated in f32 and the scale a
// separate multiply after it, as in the reference. Across all probes the
// S = shortlist best are kept, best first; on equal scores the lower flat
// index p * lpad + offset wins, and +0.0 ranks above -0.0 (lax.top_k's
// order). Slots no candidate fills are (-inf, -1). Output rows are packed
// row indices start + offset. The dot runs over d in order, one rounded
// product and one rounded sum a term (no fused multiply-add), as the plain
// version kernels/ref.py:ivf_list_scores computes it: the two agree
// bitwise, so near-tied scores rank alike in both.
//
// What bounds it on this card: bytes. Each candidate row is d int8 codes
// and one f32 scale, scored with 2d FLOP: at d = 32 that is 36 bytes for
// 64 FLOP, far below the f32 ridge of ~20 FLOP/byte, so the least time is
// the code and scale bytes over 3.35 TB/s. The selection (sorting and
// merging keys) runs in shared memory and L2 and is what this first
// version actually spends its time on.
//
// How the design answers the TPU version's assumptions:
//   - The TPU grid walks the probes of a query in order and folds each
//     probe's slice into a (1, S) output block revisited on every step,
//     with lax.top_k's first-occurrence rule giving the tie order. Blocks
//     here run in no order, so one block owns one query and loops over its
//     probes itself.
//   - Every candidate becomes one 64-bit key: the score's total-order bits
//     in the high half and the complement of its flat index in the low
//     half. Flat indices are unique within a query, so the keys are unique
//     and descending key order is exactly (score desc, flat index asc):
//     the top S is well defined and no merge grouping can change it. Key 0
//     is the empty slot.
//   - S is not bounded by shared memory: at nprobe == nlist it is the
//     whole probe budget nprobe * lpad (tens of thousands). So the running
//     list lives in a global (2, Q, S) workspace, double-buffered: each
//     chunk of up to kChunk rows of a list is scored into shared memory,
//     sorted there (bitonic), and merged with the running list by merge
//     path (each thread finds its split by binary search and writes its
//     own output range into the other buffer). A chunk whose best key is
//     below a full list's last is skipped.
//   - Only offsets below min(length, lpad) are read: the zero padding rows
//     the reference's fixed-width DMA needs are never touched. Rows may
//     repeat across probes (overlapping starts); nothing assumes they are
//     distinct. A row outside [0, rows) is a broken contract; it is
//     dropped, never read.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kChunk = 2048;  // rows scored and sorted at once (= kernels/ivf.py:CHUNK)

__device__ __forceinline__ unsigned int order_bits(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(unsigned int o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// Bitonic sort of n (a power of two) keys in shared memory, largest first,
// by the whole block.
__device__ void bitonic_desc(u64* s, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < n / 2; t += kThreads) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const u64 a = s[lo], b = s[hi];
        if ((a < b) == desc) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// The m largest of two descending key lists a (na) and b (nb), written
// descending to out. Keys are unique, so the merge needs no tie rule.
__device__ void merge_desc(const u64* a, int na, const u64* b, int nb,
                           u64* out, int m) {
  const int per = (m + kThreads - 1) / kThreads;
  const int i0 = min(m, (int)threadIdx.x * per);
  const int i1 = min(m, i0 + per);
  if (i0 >= i1) return;
  // how many of the first i0 outputs come from a
  int lo = max(0, i0 - nb), hi = min(i0, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] > b[i0 - 1 - mid]) lo = mid + 1; else hi = mid;
  }
  int ia = lo, ib = i0 - lo;
  for (int i = i0; i < i1; ++i) {
    const bool take_a = ib >= nb || (ia < na && a[ia] > b[ib]);
    out[i] = take_a ? a[ia++] : b[ib++];
  }
}

__device__ __forceinline__ float dot_row(const int8_t* __restrict__ row,
                                         const float* s_q, int d, bool vec) {
  float acc = 0.0f;
  if (vec) {  // 16-byte loads: d % 16 == 0 and a 16-byte aligned table
    const int4* r4 = reinterpret_cast<const int4*>(row);
    for (int t = 0; t < d / 16; ++t) {
      const int4 v = r4[t];
      const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const float c = (float)(signed char)(w[j] >> (8 * b));
          acc = __fadd_rn(acc, __fmul_rn(c, s_q[t * 16 + j * 4 + b]));
        }
      }
    }
  } else {
    for (int t = 0; t < d; ++t) acc = __fadd_rn(acc, __fmul_rn((float)row[t], s_q[t]));
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
ivf_list_topk_kernel(const float* __restrict__ q,
                     const int8_t* __restrict__ codes,
                     const float* __restrict__ scales,
                     const int* __restrict__ starts,
                     const int* __restrict__ lens, long long rows, int P, int d,
                     int lpad, int S, u64* __restrict__ ws_a,
                     u64* __restrict__ ws_b, float* __restrict__ out_s,
                     int* __restrict__ out_r) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* s_key = reinterpret_cast<u64*>(smem);              // (kChunk,)
  float* s_q = reinterpret_cast<float*>(s_key + kChunk);  // (d,)

  const int tid = threadIdx.x;
  const long long qi = blockIdx.x;
  for (int t = tid; t < d; t += kThreads) s_q[t] = q[qi * d + t];
  u64* cur = ws_a + qi * S;
  u64* nxt = ws_b + qi * S;
  int count = 0;  // keys in the running list, the same in every thread
  const bool vec =
      (d & 15) == 0 && (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  __syncthreads();

  for (int p = 0; p < P; ++p) {
    const long long start = starts[qi * P + p];
    const int len = min(max(lens[qi * P + p], 0), lpad);
    for (int c0 = 0; c0 < len; c0 += kChunk) {
      const int n = min(kChunk, len - c0);
      int npow = 1;
      while (npow < n) npow <<= 1;
      for (int j = tid; j < npow; j += kThreads) {
        u64 key = 0;
        const long long row = start + c0 + j;
        if (j < n && row >= 0 && row < rows) {
          const float score = __fmul_rn(dot_row(codes + row * d, s_q, d, vec), scales[row]);
          const unsigned int flat = (unsigned int)(p * lpad + c0 + j);
          key = ((u64)order_bits(score) << 32) | (u64)(~flat);
        }
        s_key[j] = key;
      }
      __syncthreads();
      bitonic_desc(s_key, npow);
      const int nb = min(n, S);
      const bool take = !(count == S && s_key[0] < cur[S - 1]);
      if (take) merge_desc(cur, count, s_key, nb, nxt, min(S, count + nb));
      __syncthreads();
      if (take) {
        u64* t = cur;
        cur = nxt;
        nxt = t;
        count = min(S, count + nb);
      }
    }
  }

  for (int j = tid; j < S; j += kThreads) {
    float sc = -INFINITY;
    int row = -1;
    const u64 key = j < count ? cur[j] : 0ull;
    if (key != 0ull) {
      const unsigned int flat = ~(unsigned int)(key & 0xffffffffull);
      const int p = (int)(flat / (unsigned int)lpad);
      sc = from_order_bits((unsigned int)(key >> 32));
      row = starts[qi * P + p] + (int)(flat - (unsigned int)p * lpad);
    }
    out_s[qi * S + j] = sc;
    out_r[qi * S + j] = row;
  }
}

}  // namespace

// q: (nq, d) f32; codes: (rows, d) int8; scales: (rows,) f32; starts and
// lens: (nq, P) int32; ws: (2, nq, S) 64-bit scratch; out_s, out_r: (nq, S).
// Returns cudaGetLastError() after the launch; the caller raises on
// anything but 0.
extern "C" int g4r_ivf_list_topk_i8(const float* q, const int8_t* codes,
                                    const float* scales, const int* starts,
                                    const int* lens, void* ws, float* out_s,
                                    int* out_r, int nq, int P, int d, int lpad,
                                    int S, long long rows, void* stream) {
  if (nq < 1 || P < 1 || d < 1 || lpad < 1 || S < 1 ||
      (long long)P * lpad > 0x7fffffffLL || S > P * lpad)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(u64) * kChunk + sizeof(float) * (size_t)d;
  cudaError_t err = cudaFuncSetAttribute(
      ivf_list_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  u64* ws_a = static_cast<u64*>(ws);
  u64* ws_b = ws_a + (size_t)nq * S;
  ivf_list_topk_kernel<<<nq, kThreads, smem, (cudaStream_t)stream>>>(
      q, codes, scales, starts, lens, rows, P, d, lpad, S, ws_a, ws_b, out_s,
      out_r);
  return (int)cudaGetLastError();
}
