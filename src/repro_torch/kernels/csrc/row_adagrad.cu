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
// What bounds it on this card: the chain of dependent steps. At the host
// training path's node table (N 28,000, D 64, bucket 2,048, nearly every
// slot a real id) a call moves about 1.6 MB: the ids and gradient rows read
// once, each real row's table row and accumulator read and written. That is
// 0.47 us at 3.35 TB/s, below what one launch takes, so the time is the
// launch and the dependent memory rounds after it.
//
// How the design answers it, and the hazard it removes:
//   - Two dependent rounds: a slot's id and its gradient row are loaded
//     together (the gradient's address does not depend on the id), then its
//     table row and accumulator together, issued before mean(g^2) is
//     reduced, so the reduction runs while they are in flight.
//   - 16-byte accesses: 16 lanes a row at D 64 (a lane owns 4 consecutive
//     columns, up to kCache vectors of them in registers), so a warp takes
//     two slots and each half-warp reduces its own slot by shuffles. Where
//     D % 4 != 0 or the table's or gradients' base is not 16-byte aligned,
//     the same kernel takes 4-byte elements, 32 lanes (one warp) a slot.
//   - The grid is the card's resident blocks at most, striding past them.
//   - The Pallas version clamps PAD ids to row 0 and writes row 0 back
//     unchanged, which is right only because the TPU grid runs in order with
//     the PADs first, before row 0's real update. Blocks here run
//     concurrently, so a clamped PAD write could land after the real one and
//     undo it. PAD slots (id < 0) are therefore skipped, never clamped. Real
//     ids are distinct by construction (embedding.table.unique_pad_ids), so
//     no two threads write one row. Ids at or past N are dropped as well, the
//     way the plain version's scatter drops them.
//   - Built without --use_fast_math: sqrtf and the division stay IEEE, and
//     the update is (lr * g) / denom subtracted, as the plain version rounds
//     it; only mean(g^2)'s order of summation differs from it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads a block
constexpr int kCache = 2;      // vectors of a row a lane keeps in registers

template <int V> struct Vec;
template <> struct Vec<4> {
  typedef float4 T;
  static __device__ __forceinline__ T load_ro(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ T load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store(float* p, T v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  static __device__ __forceinline__ float sq(T v) {
    return v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
  }
  template <class Op>
  static __device__ __forceinline__ T map(T a, T b, Op op) {
    return make_float4(op(a.x, b.x), op(a.y, b.y), op(a.z, b.z), op(a.w, b.w));
  }
};
template <> struct Vec<1> {
  typedef float T;
  static __device__ __forceinline__ T load_ro(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ T load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, T v) { *p = v; }
  static __device__ __forceinline__ float sq(T v) { return v * v; }
  template <class Op>
  static __device__ __forceinline__ T map(T a, T b, Op op) { return op(a, b); }
};

// V floats a lane moves at once: 4 (16 lanes a slot, two slots a warp) or 1
// (32 lanes, one slot a warp). The loop runs over warps, so both halves of a
// warp take every iteration and every shuffle has all 32 lanes.
template <int V>
__global__ void __launch_bounds__(kThreads)
row_adagrad_kernel(float* __restrict__ table, float* __restrict__ accum,
                   const long long* __restrict__ ids, const float* __restrict__ grads,
                   long long n, long long bucket, int d, float lr, float eps) {
  typedef Vec<V> W;
  typedef typename W::T T;
  constexpr int kLanes = V == 4 ? 16 : 32;  // lanes a slot
  constexpr int kSlotsWarp = 32 / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int dv = d / V;  // vectors a row
  const long long warps = (long long)gridDim.x * (kThreads / 32);
  for (long long w = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
       w * kSlotsWarp < bucket; w += warps) {
    const long long b = w * kSlotsWarp + (threadIdx.x % 32) / kLanes;
    const bool in = b < bucket;
    // round 1: the id and the gradient row
    const long long id = in ? __ldg(ids + b) : -1;
    const float* gr = grads + b * d;
    T gv[kCache];
#pragma unroll
    for (int k = 0; k < kCache; ++k) {
      const int c = lane + k * kLanes;
      if (in && c < dv) gv[k] = W::load_ro(gr + (long long)c * V);
    }
    // round 2, issued now: the table row and the accumulator (PAD slots and
    // ids past N load nothing and write nothing)
    const bool live = id >= 0 && id < n;
    float* row = table + (live ? id : 0) * d;
    T tv[kCache];
    float a0 = 0.0f;
    if (live) {
      a0 = accum[id];
#pragma unroll
      for (int k = 0; k < kCache; ++k) {
        const int c = lane + k * kLanes;
        if (c < dv) tv[k] = W::load(row + (long long)c * V);
      }
    }
    // mean(g^2) meanwhile: each lane's vectors, then the slot's lanes
    float sq = 0.0f;
#pragma unroll
    for (int k = 0; k < kCache; ++k) {
      const int c = lane + k * kLanes;
      if (in && c < dv) sq += W::sq(gv[k]);
    }
    for (int c = lane + kCache * kLanes; in && c < dv; c += kLanes)
      sq += W::sq(W::load_ro(gr + (long long)c * V));
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    if (live) {
      const float acc = a0 + sq / (float)d;
      const float denom = sqrtf(acc) + eps;
      const auto step = [&](float t, float gg) { return t - lr * gg / denom; };
#pragma unroll
      for (int k = 0; k < kCache; ++k) {
        const int c = lane + k * kLanes;
        if (c < dv) W::store(row + (long long)c * V, W::map(tv[k], gv[k], step));
      }
      for (int c = lane + kCache * kLanes; c < dv; c += kLanes)
        W::store(row + (long long)c * V,
                 W::map(W::load(row + (long long)c * V), W::load_ro(gr + (long long)c * V), step));
      if (lane == 0) accum[id] = acc;
    }
  }
}

// Resident blocks of an instantiation on the current card (the grid cap).
template <int V>
int blocks_resident() {
  static int cache[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, row_adagrad_kernel<V>, kThreads,
                                                      0) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    cache[dev] = per_sm * sms;
  }
  return cache[dev];
}

template <int V>
int launch(float* table, float* accum, const long long* ids, const float* grads, long long n,
           long long bucket, int d, float lr, float eps, cudaStream_t st) {
  const int resident = blocks_resident<V>();
  if (resident <= 0) {
    const cudaError_t err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorUnknown);
  }
  constexpr int kSlotsBlock = kThreads / 32 * (V == 4 ? 2 : 1);
  const long long need = (bucket + kSlotsBlock - 1) / kSlotsBlock;
  const unsigned grid = (unsigned)(need < resident ? need : resident);
  row_adagrad_kernel<V><<<grid, kThreads, 0, st>>>(table, accum, ids, grads, n, bucket, d, lr,
                                                   eps);
  return (int)cudaGetLastError();
}

}  // namespace

// table (n, d) f32, accum (n, 1) f32, ids (bucket,) int64, grads (bucket, d)
// f32, all contiguous. Takes the 16-byte path where d % 4 == 0 and the
// table's and gradients' bases are 16-byte aligned, else the 4-byte one.
// Returns cudaGetLastError() after the launch.
extern "C" int g4r_row_adagrad_f32(float* table, float* accum,
                                   const long long* ids, const float* grads,
                                   long long n, long long bucket, int d,
                                   float lr, float eps, void* stream) {
  if (bucket <= 0) return (int)cudaGetLastError();
  if (d <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (d % 4 == 0 && ((reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(grads)) &
                     15) == 0)
    return launch<4>(table, accum, ids, grads, n, bucket, d, lr, eps, st);
  return launch<1>(table, accum, ids, grads, n, bucket, d, lr, eps, st);
}

// The instantiation `vec` (1: 16-byte, 0: 4-byte): out[0..4] = registers a
// thread, local memory bytes (spills and stack), static shared memory
// bytes, resident blocks an SM, and the grid cap (the card's resident
// blocks).
extern "C" int g4r_row_adagrad_attrs(int vec, int* out) {
  cudaFuncAttributes a;
  const void* fn = vec ? (const void*)row_adagrad_kernel<4> : (const void*)row_adagrad_kernel<1>;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = vec ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, row_adagrad_kernel<4>,
                                                            kThreads, 0)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, row_adagrad_kernel<1>,
                                                            kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = per_sm;
  out[4] = vec ? blocks_resident<4>() : blocks_resident<1>();
  return 0;
}
