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
// 262 KB (0.08 us at 3.35 TB/s). Both are below the cost of a launch, so at
// that size what counts is how soon the card is filled and how short each
// block's chain is.
//
// How the design answers it:
//   - The TPU version keeps the whole (P, d) destination block in VMEM next
//     to each source tile. Here the grid is (row tiles of kTR = 32 rows) x
//     (column splits), and the column splits of one row tile are one thread-
//     block cluster of at most 8 blocks (kernels/inbatch_loss.py:plan_columns):
//     128 blocks at P = 512, against 64 before.
//   - Staging: a block takes its source tile once and its split's
//     destination tiles (kTC = 64 rows, each a 32-float slice of d) through
//     cp.async copies into a ring of two stages, the next tile in flight
//     while this one is multiplied; 16-byte copies where d % 4 == 0 and the
//     rows are aligned, 4-byte ones otherwise, with zeros past d and P.
//     Every thread copies a fixed (row, 16-byte unit) pair, stepping by
//     rows, so the staging uses no run-time division. The 128-byte rows are
//     XOR-swizzled (unit j of row r at j ^ (r & 7)) so a warp's float4 reads
//     of 32 rows hit distinct banks.
//   - The product: warp w owns rows 8w .. 8w + 7 of the tile and lane l
//     columns l and l + 32: 16 logits as independent f32 FMA chains, each
//     summed over d in order with fmaf; the source rows are warp broadcasts.
//   - Per-row log-sum-exp: each lane keeps a running (max, sum) per row over
//     its columns, with the diagonal logit in the lane that holds column i
//     (0 elsewhere). A warp takes the row's max over its lanes, rescales
//     each lane's sum to it (one expf a lane) and adds the sums in a fixed
//     tree, then pushes the block's (max, sum, diagonal) per row into block
//     0's shared memory through distributed shared memory; after one
//     cluster barrier block 0 combines the splits in their order, subtracts
//     the diagonal and writes each row once. Columns at or past P score
//     -inf and add 0. The result is bitwise the same from run to run.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTR = 32;         // source rows per block
constexpr int kTC = 64;         // destination rows (columns) per tile
constexpr int kDT = 32;         // floats of d per staged slice (one 128-byte row)
constexpr int kRowBytes = kDT * 4;
constexpr int kThreads = 128;   // 4 warps, 8 source rows each
constexpr int kRowsPerWarp = kTR / (kThreads / 32);
constexpr int kStages = 2;
constexpr int kTileBytes = kTC * kRowBytes;
constexpr int kMaxCluster = 8;  // = kernels/inbatch_loss.py:MAX_CLUSTER
constexpr int kMaxDim = 768;    // = kernels/inbatch_loss.py:MAX_DIM
constexpr unsigned kFull = 0xffffffffu;

static_assert(kRowsPerWarp * (kThreads / 32) == kTR, "the warps share the row tile");

size_t smem_bytes(int d) {
  const int ndt = (d + kDT - 1) / kDT;
  return (size_t)ndt * kTR * kRowBytes + (size_t)kStages * kTileBytes +
         (size_t)kMaxCluster * 3 * kTR * 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// The address of `p` in the shared memory of the cluster's block `rank`.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows [row0, row0 + nrows) of the (p, d) matrix m, slice [k0, k0 + kDT),
// into nrows swizzled 128-byte rows at dst0; rows at or past p and floats
// at or past d are zeros. Thread tid copies unit tid & 7 of rows tid >> 3,
// + 16, ...
__device__ __forceinline__ void stage_rows(uint32_t dst0, const float* __restrict__ m,
                                           int row0, int nrows, int p, int d, int k0, bool vec,
                                           int tid) {
  const int j = tid & 7, col = k0 + 4 * j;
  const int nd = max(0, min(4, d - col));
  for (int r = tid >> 3; r < nrows; r += kThreads / 8) {
    const int g = row0 + r;
    const int nv = g < p ? nd : 0;
    const float* src = m + (long long)g * d + col;
    const uint32_t dst = dst0 + r * kRowBytes + ((j ^ (r & 7)) << 4);
    if (vec) {
      cp_async16(dst, nv ? src : m, 4u * nv);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) cp_async4(dst + 4 * u, u < nv ? src + u : m, u < nv ? 4u : 0u);
    }
  }
}

// (a minimum of one block an SM lets ptxas take the registers the 16
// accumulators and 8 source float4 need; without it, it spilled at 72)
__global__ void __launch_bounds__(kThreads, 1)
inbatch_rows_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                    float* __restrict__ out, int p, int d, int split_cols, int vec,
                    float temperature) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ndt = (d + kDT - 1) / kDT;
  unsigned char* s_src = smem;                             // ndt slices of (kTR, kDT)
  unsigned char* s_dst = smem + ndt * kTR * kRowBytes;     // kStages tiles of (kTC, kDT)
  // (kMaxCluster, 3, kTR): each split's (max, sum, diagonal) per row, in block 0
  float* part = reinterpret_cast<float*>(s_dst + kStages * kTileBytes);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * kTR;
  const int split = blockIdx.y, nsplit = gridDim.y;  // the cluster spans the splits
  const int c0 = split * split_cols;
  const int c1 = min(c0 + split_cols, p);
  const int ntile = c1 > c0 ? (c1 - c0 + kTC - 1) / kTC : 0;
  const int nt = ntile * ndt;  // (column tile, d slice) pairs, slice fastest
  const uint32_t src0 = smem_addr(s_src), dst0 = smem_addr(s_dst);
  // the first half of a cluster barrier: block 0 is known to run (and so
  // its shared memory to exist) once the second half returns
  if (nsplit > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  for (int j = 0; j < ndt; ++j)
    stage_rows(src0 + j * kTR * kRowBytes, src, r0, kTR, p, d, j * kDT, vec, tid);
  if (nt > 0) stage_rows(dst0, dst, c0, kTC, c1, d, 0, vec, tid);
  cp_async_commit();

  // warp: source rows 8 * warp + rr; lane: columns lane, lane + 32 of a tile
  float m[kRowsPerWarp], s[kRowsPerWarp], dg[kRowsPerWarp], acc[kRowsPerWarp][2];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = -INFINITY;
    s[rr] = dg[rr] = acc[rr][0] = acc[rr][1] = 0.0f;
  }
  const int sw = lane & 7;
  int ct = 0, j = 0;  // the pair of step t
  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt) {  // the next pair's tile into the other stage
      const int nj = j + 1 == ndt ? 0 : j + 1, nct = j + 1 == ndt ? ct + 1 : ct;
      stage_rows(dst0 + ((t + 1) & 1) * kTileBytes, dst, c0 + nct * kTC, kTC, c1, d,
                 nj * kDT, vec, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* tile = s_dst + (t & 1) * kTileBytes;
    const unsigned char* srow = s_src + j * kTR * kRowBytes + warp * kRowsPerWarp * kRowBytes;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float4 x0 = *reinterpret_cast<const float4*>(tile + lane * kRowBytes + ((u ^ sw) << 4));
      const float4 x1 =
          *reinterpret_cast<const float4*>(tile + (lane + 32) * kRowBytes + ((u ^ sw) << 4));
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int sr = warp * kRowsPerWarp + rr;  // the row in the tile, for its swizzle
        const float4 a = *reinterpret_cast<const float4*>(srow + rr * kRowBytes + ((u ^ (sr & 7)) << 4));
        acc[rr][0] = fmaf(a.x, x0.x, acc[rr][0]);
        acc[rr][0] = fmaf(a.y, x0.y, acc[rr][0]);
        acc[rr][0] = fmaf(a.z, x0.z, acc[rr][0]);
        acc[rr][0] = fmaf(a.w, x0.w, acc[rr][0]);
        acc[rr][1] = fmaf(a.x, x1.x, acc[rr][1]);
        acc[rr][1] = fmaf(a.y, x1.y, acc[rr][1]);
        acc[rr][1] = fmaf(a.z, x1.z, acc[rr][1]);
        acc[rr][1] = fmaf(a.w, x1.w, acc[rr][1]);
      }
    }
    if (j + 1 == ndt) {  // the tile's logits are complete
      const int col0 = c0 + ct * kTC + lane, col1 = col0 + 32;
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int row = r0 + warp * kRowsPerWarp + rr;
        const float l0 = col0 < c1 ? acc[rr][0] / temperature : -INFINITY;
        const float l1 = col1 < c1 ? acc[rr][1] / temperature : -INFINITY;
        if (col0 == row) dg[rr] = l0;
        if (col1 == row) dg[rr] = l1;
        const float mx = fmaxf(m[rr], fmaxf(l0, l1));
        if (mx != -INFINITY) {
          s[rr] = s[rr] * expf(m[rr] - mx) + expf(l0 - mx) + expf(l1 - mx);
          m[rr] = mx;
        }
        acc[rr][0] = acc[rr][1] = 0.0f;
      }
      ++ct;
      j = 0;
    } else {
      ++j;
    }
    __syncthreads();  // the stage is read before the next step refills it
  }

  // the block's partial per row, (max, sum of exp(logit - max), diagonal),
  // pushed into block 0's shared memory at slot `split`: the row's max over
  // the lanes, each lane's sum rescaled to it, then the sums added in a fixed
  // tree (lane 0's result is taken)
  if (nsplit > 1) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    float mx = m[rr];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    float ss = m[rr] == -INFINITY ? 0.0f : s[rr] * expf(m[rr] - mx), dd = dg[rr];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(kFull, ss, o);
      dd += __shfl_xor_sync(kFull, dd, o);  // one logit and zeros: exact
    }
    if (lane == 0) {
      const uint32_t slot = cluster_addr(part + (split * 3) * kTR + warp * kRowsPerWarp + rr, 0);
      st_cluster(slot, mx);
      st_cluster(slot + kTR * 4, ss);
      st_cluster(slot + 2 * kTR * 4, dd);
    }
  }
  // block 0 combines the splits in their order; the others may leave once
  // the cluster has arrived
  if (nsplit > 1) {
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;" ::: "memory");
  } else {
    __syncthreads();
  }
  if (split == 0 && tid < kTR && r0 + tid < p) {
    float mx = -INFINITY, ss = 0.0f, dd = 0.0f;
    for (int b = 0; b < nsplit; ++b) mx = fmaxf(mx, part[(b * 3) * kTR + tid]);
    for (int b = 0; b < nsplit; ++b) {
      const float mb = part[(b * 3) * kTR + tid];
      if (mb != -INFINITY) ss += part[(b * 3 + 1) * kTR + tid] * expf(mb - mx);
      dd += part[(b * 3 + 2) * kTR + tid];
    }
    out[r0 + tid] = (logf(ss) + mx) - dd;
  }
}

}  // namespace

// src, dst: (p, d) f32 contiguous; out: (p,) f32. The plan: column splits
// of `split_cols` columns (a multiple of 64), `splits` of them, one cluster
// per 32 rows. Returns cudaGetLastError() after the launch; the caller
// raises on anything but 0.
extern "C" int g4r_inbatch_rows_f32(const float* src, const float* dst, float* out, int p, int d,
                                    int splits, int split_cols, float temperature,
                                    void* stream) {
  if (p <= 0) return (int)cudaGetLastError();
  if (d <= 0 || d > kMaxDim || splits < 1 || splits > kMaxCluster || split_cols < 1 ||
      split_cols % kTC != 0 || (long long)splits * split_cols < p ||
      (long long)(splits - 1) * split_cols >= p)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      inbatch_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = d % 4 == 0 && (uintptr_t)src % 16 == 0 && (uintptr_t)dst % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p + kTR - 1) / kTR, splits, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, inbatch_rows_kernel, src, dst, out, p, d, split_cols, vec,
                           temperature);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// out[0..3] = registers a thread, local memory bytes (spills and stack),
// dynamic shared memory bytes at dim d, and resident blocks an SM.
extern "C" int g4r_inbatch_attrs(int d, int* out) {
  if (d <= 0 || d > kMaxDim) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      inbatch_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, (const void*)inbatch_rows_kernel);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, inbatch_rows_kernel, kThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem;
  out[3] = per_sm;
  return 0;
}
