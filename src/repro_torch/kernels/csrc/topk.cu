// Streaming inner-product top-k with exclusion lists, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/topk.py:chunked_topk_pallas
// (pallas_call at :109): (Q, d) f32 queries against (I, d) f32 items, each
// query with a (Q, E) list of excluded item ids (-1 = empty slot), give the
// k best (score, id) per query, best first. On equal scores the lower id
// wins; slots that no surviving item fills are (-inf, -1).
//
// What bounds it on this card: operations. 2*Q*I*d FLOP in f32 FMA on the
// CUDA cores (no TF32, no tensor cores: TF32 would reorder near-tied
// scores); at Q = 1024, I = 1e6, d = 64 that is 1.31e11 FLOP, about 2.0 ms
// at 67 TFLOP/s, while reading the table once is 256 MB, about 76 us.
//
// How the design answers it:
//   - The TPU version runs its grid in order and carries the running top-k
//     in an output block revisited on every item chunk. Blocks here run in
//     no order, so one block owns a tile of kTQ queries and loops over the
//     item chunks of its split itself, keeping the running lists in shared
//     memory. Each item chunk is staged through shared memory once per
//     query tile, so the table is read Q/kTQ times, not Q times.
//   - Scores are a register-blocked f32 product: each of 256 threads keeps
//     a 4 x 4 tile of accumulators and reads its operands as float4 from
//     transposed shared tiles (the query operand is a warp broadcast).
//   - Selection is a filter, not a sort per chunk: a warp owns a query and
//     appends only scores above the query's current k-th best to a buffer
//     (a ballot gives each lane its slot); the buffer is merged into the
//     list by a warp bitonic sort on (score desc, id asc) when it fills.
//     Items come in ascending id order inside a split, so a score equal to
//     the k-th best always loses and the filter may be strict. Exclusions
//     are checked only for such candidates, by binary search in the
//     query's sorted exclusion row.
//   - Too few query tiles cannot fill 132 SMs, so the items are cut into
//     contiguous splits, one block per (query tile, split); a second kernel
//     merges the splits' lists with the same (score desc, id asc) sort, so
//     the lower id still wins across splits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTQ = 32;        // queries per block
constexpr int kCH = 128;       // items per chunk
constexpr int kDT = 32;        // depth of one staged d-tile
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kQStride = kTQ + 4;  // padded rows of the transposed tiles
constexpr int kIStride = kCH + 4;
constexpr int kMaxK = 256;  // = kernels/topk.py:MAX_K

__device__ __forceinline__ bool better(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// Bitonic sort of n (a power of two) pairs, best first, by `nthreads`
// threads numbered from `t0`: one warp, or the whole block if kBlock.
template <bool kBlock>
__device__ void bitonic_sort(float* s, int* id, int n, int t0, int nthreads) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = t0; t < n / 2; t += nthreads) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool best_first = (lo & size) == 0;
        const float sl = s[lo], sh = s[hi];
        const int il = id[lo], ih = id[hi];
        if (better(sh, ih, sl, il) == best_first) {
          s[lo] = sh; s[hi] = sl;
          id[lo] = ih; id[hi] = il;
        }
      }
      if (kBlock) __syncthreads(); else __syncwarp();
    }
  }
}

__device__ __forceinline__ bool excluded(const int* row, int e, int id) {
  int lo = 0, hi = e;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row[mid] < id) lo = mid + 1; else hi = mid;
  }
  return lo < e && row[lo] == id;
}

// Merge the query's buffer [kp, 2kp) into its list [0, kp) and refill the
// buffer with (-inf, -1). Returns the new k-th best score.
__device__ float merge_list(float* s, int* id, int kp, int k, int lane) {
  bitonic_sort<false>(s, id, 2 * kp, lane, 32);
  for (int j = kp + lane; j < 2 * kp; j += 32) {
    s[j] = -INFINITY;
    id[j] = -1;
  }
  __syncwarp();
  return s[k - 1];
}

__global__ void __launch_bounds__(kThreads)
topk_kernel(const float* __restrict__ q, const float* __restrict__ items,
            const int* __restrict__ excl, int e, int nq, int ni, int d, int k,
            int kp, int split_len, float* __restrict__ out_s,
            int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_qt = reinterpret_cast<float*>(smem);        // (kDT, kQStride)
  float* s_it = s_qt + kDT * kQStride;                 // (kDT, kIStride)
  float* s_sc = s_it + kDT * kIStride;                 // (kTQ, kCH)
  float* l_s = s_sc + kTQ * kCH;                       // (kTQ, 2kp)
  int* l_i = reinterpret_cast<int*>(l_s + kTQ * 2 * kp);  // (kTQ, 2kp)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kTQ;
  const int split = blockIdx.y;
  const int start = split * split_len;
  const int end = min(start + split_len, ni);

  for (int j = tid; j < kTQ * 2 * kp; j += kThreads) {
    l_s[j] = -INFINITY;
    l_i[j] = -1;
  }
  __syncthreads();
  // per-query selection state, held by the warp that owns the query
  float thr[kTQ / kWarps];
  int cnt[kTQ / kWarps];
#pragma unroll
  for (int r = 0; r < kTQ / kWarps; ++r) {
    thr[r] = -INFINITY;
    cnt[r] = 0;
  }

  // tile loaders: a warp covers 8 consecutive d x 4 rows, so each row read
  // is one 32-byte sector and the transposed stores hit 32 distinct banks
  const int cl = lane & 7, rl = lane >> 3;
  const int ty = tid >> 5, tx = tid & 31;  // score tile: queries ty*4.., items tx*4..

  for (int base = start; base < end; base += kCH) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < d; k0 += kDT) {
#pragma unroll
      for (int cg = 0; cg < kDT / 8; ++cg) {
        const int c = cg * 8 + cl, r = warp * 4 + rl, qq = q0 + r;
        s_qt[c * kQStride + r] =
            (qq < nq && k0 + c < d) ? q[(long long)qq * d + k0 + c] : 0.0f;
      }
#pragma unroll
      for (int rg = 0; rg < kCH / 32; ++rg) {
#pragma unroll
        for (int cg = 0; cg < kDT / 8; ++cg) {
          const int c = cg * 8 + cl, r = rg * 32 + warp * 4 + rl;
          const int it = base + r;
          s_it[c * kIStride + r] = (it < end && k0 + c < d)
                                       ? items[(long long)it * d + k0 + c]
                                       : 0.0f;
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kDT; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(
            &s_qt[kk * kQStride + ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(
            &s_it[kk * kIStride + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float4*>(&s_sc[(ty * 4 + i) * kCH + tx * 4]) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    __syncthreads();

    // selection: warp `warp` owns queries warp, warp + kWarps, ...
#pragma unroll
    for (int r = 0; r < kTQ / kWarps; ++r) {
      const int ql = warp + r * kWarps;
      const int qg = q0 + ql;
      if (qg >= nq) continue;
      const int* ex = excl + (long long)qg * e;
      float* ls = l_s + ql * 2 * kp;
      int* li = l_i + ql * 2 * kp;
      for (int jb = 0; jb < kCH; jb += 32) {
        const int j = jb + lane;
        const int id = base + j;
        const float sc = s_sc[ql * kCH + j];
        bool pass = id < end && sc > thr[r];
        if (pass && e > 0) pass = !excluded(ex, e, id);
        unsigned ballot = __ballot_sync(0xffffffffu, pass);
        if (cnt[r] + __popc(ballot) > kp) {
          thr[r] = merge_list(ls, li, kp, k, lane);
          cnt[r] = 0;
          pass = pass && sc > thr[r];
          ballot = __ballot_sync(0xffffffffu, pass);
        }
        if (pass) {
          const int pos = kp + cnt[r] + __popc(ballot & ((1u << lane) - 1u));
          ls[pos] = sc;
          li[pos] = id;
        }
        cnt[r] += __popc(ballot);
        __syncwarp();
      }
    }
    __syncthreads();
  }

  // flush the buffers and write each query's k best
#pragma unroll
  for (int r = 0; r < kTQ / kWarps; ++r) {
    const int ql = warp + r * kWarps;
    const int qg = q0 + ql;
    if (qg >= nq) continue;
    float* ls = l_s + ql * 2 * kp;
    int* li = l_i + ql * 2 * kp;
    if (cnt[r] > 0) merge_list(ls, li, kp, k, lane);
    const long long row = (long long)split * nq + qg;
    for (int j = lane; j < k; j += 32) {
      out_s[row * k + j] = ls[j];
      out_i[row * k + j] = li[j];
    }
  }
}

// One block per query: sort the splits' lists together, keep the k best.
__global__ void topk_merge_kernel(const float* __restrict__ part_s,
                                  const int* __restrict__ part_i, int nq,
                                  int k, int splits, int n,
                                  float* __restrict__ out_s,
                                  int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s = reinterpret_cast<float*>(smem);
  int* id = reinterpret_cast<int*>(s + n);
  const int qg = blockIdx.x;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    if (j < splits * k) {
      const long long src = ((long long)(j / k) * nq + qg) * k + (j % k);
      s[j] = part_s[src];
      id[j] = part_i[src];
    } else {
      s[j] = -INFINITY;
      id[j] = -1;
    }
  }
  __syncthreads();
  bitonic_sort<true>(s, id, n, threadIdx.x, blockDim.x);
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    out_s[(long long)qg * k + j] = s[j];
    out_i[(long long)qg * k + j] = id[j];
  }
}

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace

// excl: (nq, e) int32, each row sorted ascending (-1 slots first); e may be
// 0. part_s/part_i: (splits, nq, k) scratch, used when splits > 1. Returns
// cudaGetLastError() after the launches; the caller raises on anything but 0.
extern "C" int g4r_topk_f32(const float* q, const float* items,
                            const int* excl, int e, float* part_s, int* part_i,
                            float* out_s, int* out_i, int nq, int ni, int d,
                            int k, int splits, int split_len, void* stream) {
  if (k < 1 || k > kMaxK || k > ni || splits < 1 || nq < 1 || d < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int kp = next_pow2(k < 32 ? 32 : k);
  const size_t smem = sizeof(float) * (kDT * kQStride + kDT * kIStride +
                                       kTQ * kCH) +
                      (sizeof(float) + sizeof(int)) * kTQ * 2 * kp;
  cudaError_t err = cudaFuncSetAttribute(
      topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nq + kTQ - 1) / kTQ, splits);
  float* ws = splits > 1 ? part_s : out_s;
  int* wi = splits > 1 ? part_i : out_i;
  topk_kernel<<<grid, kThreads, smem, st>>>(q, items, excl, e, nq, ni, d, k,
                                             kp, split_len, ws, wi);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int n = next_pow2(splits * k);
  const size_t msmem = (sizeof(float) + sizeof(int)) * (size_t)n;
  err = cudaFuncSetAttribute(topk_merge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)msmem);
  if (err != cudaSuccess) return (int)err;
  topk_merge_kernel<<<nq, kThreads, msmem, st>>>(part_s, part_i, nq, k, splits,
                                                 n, out_s, out_i);
  return (int)cudaGetLastError();
}
