// Masked segment aggregation over the neighbour axis, and its backward, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/seg_aggr.py:seg_aggr_pallas
// (pallas_call at :63): an (N, F, D) f32 block of gathered neighbour
// features and an (N, F) bool mask give (N, D), in mode sum, mean (divided
// by max(count, 1)) or max (masked entries count as -1e30, rows with no
// valid entry give 0).
//
// What bounds it on this card: bytes. It does F adds per output and reads
// each input once, so at the serving path's largest call (N = 8192, F = 3,
// D = 64: 6.3 MB in, 2.1 MB out) the floor is about 2.5 us at 3.35 TB/s,
// and the training paths' calls (N 342 to 4096) are launch-sized: there
// the time is the chain of dependent steps from launch to the last store.
// The forward's design keeps that chain one load round long:
//   - a lane owns 4 consecutive columns of one row and reads them as one
//     16-byte load per neighbour (16 lanes cover a 64-float row, so a warp
//     reads two rows' 256 contiguous bytes a neighbour); every neighbour's
//     load of a group of up to kGroup issues before any sum;
//   - each lane reads its row's mask bytes itself, beside the x loads: no
//     shared-memory staging and no block barrier stand before them;
//   - the sum adds x * mask over F in order, j = 0 .. F-1, from 0 (mean
//     divides by max(count, 1) last; max starts at -1e30). The plain
//     version's (x * mask).sum(dim=1) (kernels/ref.py:seg_aggr_ref) adds in
//     the same order on the card for F <= 4 with D > 1, every main-path
//     call's shape, and there the two are bitwise equal; for F > 4 PyTorch
//     keeps four partial sums, and at D = 1 it reduces across threads, so
//     there they differ by rounding;
//   - the grid is the card's resident blocks at most (one wave at the
//     largest main-path call), and a block strides over the rows past it;
//   - x and the mask take a row stride, so the strided per-relation view
//     child[:, :, r] of the ego layout (core/hetero.py) is read in place,
//     with no copy; F and D must be dense (strides D and 1). Where D % 4 != 0,
//     or x's base or row stride is not 16-byte aligned, the same kernel
//     reads 4-byte elements, 32 lanes to a row (a second path, chosen by
//     shape).
// The TPU version padded N and D up to its (8, 256) tiles; here the ragged
// edge is masked by bounds checks and nothing is padded.
//
// The backward comes in two kernels: sum and mean from g and the mask
// alone (seg_aggr_bwd_kernel), and max, which also reads the forward's x to
// find each column's maximum (seg_aggr_max_bwd_kernel).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256; // threads a block
constexpr int kGroup = 4;     // forward: neighbour loads in flight a lane
constexpr int kMaskRegs = 4;  // backward: a row's mask bytes held in registers (F <= 4 on the paths)
constexpr float kNegInf = -1e30f;

template <int V> struct Vec;
template <> struct Vec<4> {
  typedef float4 T;
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void store(float* p, T v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  static __device__ __forceinline__ T fill(float a) { return make_float4(a, a, a, a); }
  template <class Op>
  static __device__ __forceinline__ T map(T a, T b, Op op) {
    return make_float4(op(a.x, b.x), op(a.y, b.y), op(a.z, b.z), op(a.w, b.w));
  }
};
template <> struct Vec<1> {
  typedef float T;
  static __device__ __forceinline__ T load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void store(float* p, T v) { *p = v; }
  static __device__ __forceinline__ T fill(float a) { return a; }
  template <class Op>
  static __device__ __forceinline__ T map(T a, T b, Op op) { return op(a, b); }
};

// V floats a lane loads at once: 4 (16-byte loads, 16 lanes a row) or 1
// (4-byte loads, 32 lanes a row).
template <int V>
__global__ void __launch_bounds__(kThreads)
seg_aggr_kernel(const float* __restrict__ x, const uint8_t* __restrict__ mask,
                float* __restrict__ out, long long n, int f, int d,
                long long x_row_stride, long long m_row_stride, int mode) {
  typedef Vec<V> W;
  typedef typename W::T T;
  constexpr int kLanes = V == 4 ? 16 : 32;  // lanes a row
  constexpr int kRowsPass = kThreads / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int dv = d / V;  // vectors a row
  for (long long row = (long long)blockIdx.x * kRowsPass + threadIdx.x / kLanes; row < n;
       row += (long long)gridDim.x * kRowsPass) {
    const uint8_t* mr = mask + row * m_row_stride;
    const float* xr = x + row * x_row_stride;
    float* o = out + row * (long long)d;
    for (int c = lane; c < dv; c += kLanes) {
      T acc = W::fill(mode == 2 ? kNegInf : 0.0f);
      float count = 0.0f;
      for (int j0 = 0; j0 < f; j0 += kGroup) {
        T v[kGroup];
        bool m[kGroup];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          if (j0 + j < f) {
            v[j] = W::load(xr + (long long)(j0 + j) * d + (long long)c * V);
            m[j] = mr[j0 + j] != 0;
          }
        }
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          if (j0 + j < f) {
            const float w = m[j] ? 1.0f : 0.0f;
            count += w;
            if (mode == 2) {  // masked entries are -1e30
              acc = W::map(acc, v[j], [&](float a, float b) { return fmaxf(a, m[j] ? b : kNegInf); });
            } else {  // x * mask, as the plain version computes it (0 * x for PAD slots)
              acc = W::map(acc, v[j], [&](float a, float b) { return __fadd_rn(a, __fmul_rn(b, w)); });
            }
          }
        }
      }
      T res = acc;
      if (mode == 1) {
        const float cnt = fmaxf(count, 1.0f);
        res = W::map(acc, acc, [&](float a, float) { return __fdiv_rn(a, cnt); });
      } else if (mode == 2 && count == 0.0f) {
        res = W::fill(0.0f);
      }
      W::store(o + (long long)c * V, res);
    }
  }
}

// Resident blocks an SM of the forward instantiation, per device (the grid
// is at most that many a card).
template <int V>
int fwd_blocks_per_sm() {
  static int cache[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, seg_aggr_kernel<V>, kThreads, 0) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    cache[dev] = per_sm * sms;
  }
  return cache[dev];
}

template <int V>
int launch_fwd(const float* x, const uint8_t* mask, float* out, long long n, int f, int d,
               long long xs, long long ms, int mode, cudaStream_t st) {
  const int resident = fwd_blocks_per_sm<V>();
  if (resident <= 0) {
    const cudaError_t err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorUnknown);
  }
  constexpr int kRowsPass = kThreads / (V == 4 ? 16 : 32);
  const long long need = (n + kRowsPass - 1) / kRowsPass;
  const unsigned grid = (unsigned)(need < resident ? need : resident);
  seg_aggr_kernel<V><<<grid, kThreads, 0, st>>>(x, mask, out, n, f, d, xs, ms, mode);
  return (int)cudaGetLastError();
}

// a / b rounded as __fdiv_rn, for a finite b > 0. A zero a is returned as
// it is (a / b is that same signed zero) and never reaches the division:
// the division's check sends a zero dividend down its slow-path call, and
// half the rows of the training paths' output gradients are zero.
__device__ __forceinline__ float div_nonzero(float a, float b) {
  const float q = __fdiv_rn(a != 0.0f ? a : 1.0f, b);
  return a != 0.0f ? q : a;
}

// Backward of sum and mean: dx[n, f, :] = g[n, :] * m[n, f] (sum) or
// (g[n, :] / max(count_n, 1)) * m[n, f] (mean), m = mask as 0 or 1, into a
// dense (N, F, D) block. Every call on the training paths is launch-sized
// (0.2 to 4 MB), so the time is the chain of dependent steps from launch to
// the last store, and the design keeps it one load round long:
//   - as in the forward, a lane owns 4 consecutive columns of one row
//     (V = 4: a 16-byte load of g and 16-byte stores, 16 lanes a 64-float
//     row; V = 1, the 4-byte path, 32 lanes a row) and stores its vector
//     for the F neighbours in series; row and lane come from the thread
//     index by shifts, so no integer division stands before the loads. (A
//     lane a (row, neighbour) pair, one store each, the library's shape of
//     work, was slower at every recorded shape: PERF.md section 6.)
//   - each lane reads the mask bytes it needs itself, in the same round as
//     its first g vector (up to kMaskRegs of them, held as bits of one
//     register, which keeps the IEEE division's slow-path call from
//     spilling): no shared-memory staging and no block barrier;
//   - the same two roundings as the plain version (kernels/ref.py:
//     seg_aggr_bwd_ref) in the same order, __fdiv_rn then __fmul_rn, with
//     no contraction: it is bitwise equal to it, and a multiply, not a
//     select, carries inf and NaN in g through as the plain version does.
//     The training paths' rows count all or none of their F neighbours, so
//     at F 4 every count is 1 or 4, a power of two, whose quotient is taken
//     as a product by the exact reciprocal, and zero rows of g skip the
//     division (div_nonzero): the same results without the division's
//     latency on the path;
//   - blocks of 64 to 256 threads, the largest that still cover every SM
//     (see launch_bwd), and the grid the card's resident blocks at most,
//     striding past them.
template <int V>
__global__ void __launch_bounds__(kThreads)
seg_aggr_bwd_kernel(const float* __restrict__ g, const uint8_t* __restrict__ mask,
                    float* __restrict__ dx, long long n, int f, int d,
                    long long m_row_stride, int mode) {
  typedef Vec<V> W;
  typedef typename W::T T;
  constexpr int kLanes = V == 4 ? 16 : 32;  // lanes a row
  const int rows_block = blockDim.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int dv = d / V;  // vectors a row
  for (long long row = (long long)blockIdx.x * rows_block + threadIdx.x / kLanes; row < n;
       row += (long long)gridDim.x * rows_block) {
    const uint8_t* mr = mask + row * m_row_stride;
    const float* gr = g + row * d;
    T gv = W::fill(0.0f);
    if (lane < dv) gv = W::load(gr + (long long)lane * V);  // issued beside the mask loads
    unsigned bits = 0;  // bit k: mask byte k is set
#pragma unroll
    for (int k = 0; k < kMaskRegs; ++k)
      if (k < f && mr[k] != 0) bits |= 1u << k;
    float cnt = 1.0f, rcp = 1.0f;
    bool pow2 = true;
    if (mode == 1) {
      float count = (float)__popc(bits);
      for (int k = kMaskRegs; k < f; ++k) count += mr[k] ? 1.0f : 0.0f;
      cnt = fmaxf(count, 1.0f);
      // a count that is a power of two divides as a product by its exact
      // reciprocal (the same correctly rounded quotient; negated exponent)
      pow2 = (__float_as_uint(cnt) & 0x007fffffu) == 0u;
      rcp = __uint_as_float(0x7f000000u - __float_as_uint(cnt));
    }
    for (int c = lane; c < dv; c += kLanes) {
      if (c != lane) gv = W::load(gr + (long long)c * V);
      T q = gv;
      if (mode == 1) {
        if (pow2)
          q = W::map(gv, gv, [&](float a, float) { return __fmul_rn(a, rcp); });
        else
          q = W::map(gv, gv, [&](float a, float) { return div_nonzero(a, cnt); });
      }
      float* o = dx + row * f * (long long)d + (long long)c * V;
#pragma unroll
      for (int k = 0; k < kMaskRegs; ++k) {
        if (k < f) {
          const float w = (bits >> k) & 1u ? 1.0f : 0.0f;
          W::store(o + (long long)k * d, W::map(q, q, [&](float a, float) { return __fmul_rn(a, w); }));
        }
      }
      for (int k = kMaskRegs; k < f; ++k) {
        const float w = mr[k] ? 1.0f : 0.0f;
        W::store(o + (long long)k * d, W::map(q, q, [&](float a, float) { return __fmul_rn(a, w); }));
      }
    }
  }
}

// V floats of one lane, addressable one by one.
template <int V> union Frag {
  typename Vec<V>::T v;
  float s[V];
};

// Backward of max: the gradient jax.grad takes of repro's
// seg_aggr_ref(x, mask, "max") (kernels/ref.py:seg_aggr_bwd_ref holds the
// same rule in plain ops). With neg = where(mask, x, -1e30) and out[n, d]
// the maximum of neg[n, :, d] over F:
//   - cnt[n, d] counts the F entries of neg equal to out, masked entries
//     included (a valid -1e30 beside masked slots shares its gradient with
//     them; a valid -inf loses to them and gets none);
//   - q = where(any valid, g, 0) / cnt, one IEEE division (div_nonzero:
//     __fdiv_rn, zero dividends returned as they are);
//   - dx[n, f, d] = mask ? q * (neg == out ? 1 : 0) : 0, the product
//     rounded as the plain version's (a non-maximal valid entry of a
//     negative q is -0, as in JAX).
// Values are compared exactly; NaN inputs are out of scope. A lane owns 4
// (or 1) consecutive columns of one row, as in the sum/mean backward, and
// walks F twice: the maximum and its tie count first (a running count,
// reset when a larger entry comes), then the F stores. The second pass
// reads x again from the cache; F <= 4 on every recorded path.
template <int V>
__global__ void __launch_bounds__(kThreads)
seg_aggr_max_bwd_kernel(const float* __restrict__ g, const float* __restrict__ x,
                        const uint8_t* __restrict__ mask, float* __restrict__ dx,
                        long long n, int f, int d, long long x_row_stride,
                        long long m_row_stride) {
  typedef Vec<V> W;
  constexpr int kLanes = V == 4 ? 16 : 32;  // lanes a row
  const int rows_block = blockDim.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int dv = d / V;  // vectors a row
  for (long long row = (long long)blockIdx.x * rows_block + threadIdx.x / kLanes; row < n;
       row += (long long)gridDim.x * rows_block) {
    const uint8_t* mr = mask + row * m_row_stride;
    const float* xr = x + row * x_row_stride;
    const float* gr = g + row * d;
    float* o = dx + row * f * (long long)d;
    bool any_valid = false;
    for (int k = 0; k < f; ++k) any_valid |= mr[k] != 0;
    for (int c = lane; c < dv; c += kLanes) {
      const long long col = (long long)c * V;
      float top[V], cnt[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        top[i] = -INFINITY;
        cnt[i] = 0.0f;
      }
      for (int j = 0; j < f; ++j) {
        const bool m = mr[j] != 0;
        Frag<V> a;
        a.v = W::load(xr + (long long)j * d + col);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float e = m ? a.s[i] : kNegInf;
          if (e > top[i]) {
            top[i] = e;
            cnt[i] = 1.0f;
          } else if (e == top[i]) {
            cnt[i] += 1.0f;
          }
        }
      }
      Frag<V> gv;
      gv.v = W::load(gr + col);
      float q[V];
#pragma unroll
      for (int i = 0; i < V; ++i) q[i] = div_nonzero(any_valid ? gv.s[i] : 0.0f, cnt[i]);
      for (int j = 0; j < f; ++j) {
        const bool m = mr[j] != 0;
        Frag<V> a, r;
        a.v = W::load(xr + (long long)j * d + col);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float e = m ? a.s[i] : kNegInf;
          r.s[i] = m ? __fmul_rn(q[i], e == top[i] ? 1.0f : 0.0f) : 0.0f;
        }
        W::store(o + (long long)j * d + col, r.v);
      }
    }
  }
}

// The backward kernel of V-float lanes: sum/mean, or max (kMax).
template <int V, bool kMax>
const void* bwd_kernel() {
  return kMax ? (const void*)seg_aggr_max_bwd_kernel<V> : (const void*)seg_aggr_bwd_kernel<V>;
}

// Resident blocks of `threads` threads of a backward instantiation, per
// device and block size (64, 128 or 256), and the card's SMs.
template <int V, bool kMax>
int bwd_resident(int threads, int* sms_out) {
  static int cache[64][3] = {{0}};
  static int sms_cache[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  const int slot = threads == 64 ? 0 : threads == 128 ? 1 : 2;
  if (cache[dev][slot] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bwd_kernel<V, kMax>(), threads,
                                                      0) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    cache[dev][slot] = per_sm * sms;
    sms_cache[dev] = sms;
  }
  if (sms_out) *sms_out = sms_cache[dev];
  return cache[dev][slot];
}

// Block size: the largest of 256, 128 and 64 threads whose blocks still
// cover every SM, so a launch-sized call spreads its stores over the card
// (a 256-thread block a 16-row slice would leave 110 of 132 SMs idle at
// the fused path's 342 rows); then at most one wave of resident blocks.
// Returns 0 or the error that kept the shape from being found.
template <int V, bool kMax>
int bwd_shape(long long n, int* threads_out, unsigned* grid_out) {
  constexpr int kLanes = V == 4 ? 16 : 32;
  int sms = 0;
  if (bwd_resident<V, kMax>(kThreads, &sms) <= 0) {
    const cudaError_t err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorUnknown);
  }
  int threads = kThreads;
  while (threads > 64 && n * kLanes <= (long long)(threads / 2) * sms) threads /= 2;
  const int resident = bwd_resident<V, kMax>(threads, nullptr);
  if (resident <= 0) {
    const cudaError_t err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorUnknown);
  }
  const long long per_block = threads / kLanes;
  const long long need = (n + per_block - 1) / per_block;
  *threads_out = threads;
  *grid_out = (unsigned)(need < resident ? need : resident);
  return 0;
}

template <int V>
int launch_bwd(const float* g, const uint8_t* mask, float* dx, long long n, int f, int d,
               long long ms, int mode, cudaStream_t st) {
  int threads = 0;
  unsigned grid = 0;
  const int err = bwd_shape<V, false>(n, &threads, &grid);
  if (err) return err;
  seg_aggr_bwd_kernel<V><<<grid, threads, 0, st>>>(g, mask, dx, n, f, d, ms, mode);
  return (int)cudaGetLastError();
}

template <int V>
int launch_max_bwd(const float* g, const float* x, const uint8_t* mask, float* dx, long long n,
                   int f, int d, long long xs, long long ms, cudaStream_t st) {
  int threads = 0;
  unsigned grid = 0;
  const int err = bwd_shape<V, true>(n, &threads, &grid);
  if (err) return err;
  seg_aggr_max_bwd_kernel<V><<<grid, threads, 0, st>>>(g, x, mask, dx, n, f, d, xs, ms);
  return (int)cudaGetLastError();
}

// out[0..4] of a backward instantiation, as g4r_seg_aggr_attrs reports the
// forward's (residency at 256-thread blocks).
template <int V, bool kMax>
int bwd_attrs(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, bwd_kernel<V, kMax>());
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bwd_kernel<V, kMax>(), kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = per_sm;
  out[4] = bwd_resident<V, kMax>(kThreads, nullptr);
  return 0;
}

}  // namespace

// mode: 0 = sum, 1 = mean, 2 = max. Takes the 16-byte path where D % 4 == 0
// and x's base and row stride are 16-byte aligned, else the 4-byte one.
// Returns cudaGetLastError() after the launch; the caller raises on
// anything but 0.
extern "C" int g4r_seg_aggr_f32(const float* x, const uint8_t* mask,
                                float* out, long long n, int f, int d,
                                long long x_row_stride, long long m_row_stride,
                                int mode, void* stream) {
  if (mode < 0 || mode > 2 || f < 0 || d < 0) return (int)cudaErrorInvalidValue;
  if (n <= 0 || d == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (d % 4 == 0 && x_row_stride % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0)
    return launch_fwd<4>(x, mask, out, n, f, d, x_row_stride, m_row_stride, mode, st);
  return launch_fwd<1>(x, mask, out, n, f, d, x_row_stride, m_row_stride, mode, st);
}

// The forward instantiation `vec` (1: 16-byte loads, 0: 4-byte loads):
// out[0..4] = registers a thread, local memory bytes (spills and stack),
// static shared memory bytes, resident blocks an SM, and the grid cap (the
// card's resident blocks).
extern "C" int g4r_seg_aggr_attrs(int vec, int* out) {
  cudaFuncAttributes a;
  const void* fn = vec ? (const void*)seg_aggr_kernel<4> : (const void*)seg_aggr_kernel<1>;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = vec ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, seg_aggr_kernel<4>, kThreads, 0)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, seg_aggr_kernel<1>, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = per_sm;
  out[4] = vec ? fwd_blocks_per_sm<4>() : fwd_blocks_per_sm<1>();
  return 0;
}

// Backward of mode 0 (sum) or 1 (mean); max has its own entry point below,
// since it reads x. g is (N, D) contiguous, dx (N, F, D) contiguous; the
// mask takes a row stride.
// Takes the 16-byte path where D % 4 == 0 and g's base is 16-byte aligned
// (dx is allocated by the wrapper), else the 4-byte one.
extern "C" int g4r_seg_aggr_bwd_f32(const float* g, const uint8_t* mask, float* dx,
                                    long long n, int f, int d, long long m_row_stride,
                                    int mode, void* stream) {
  if ((mode != 0 && mode != 1) || f < 0 || d < 0) return (int)cudaErrorInvalidValue;
  if (n <= 0 || f == 0 || d == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (d % 4 == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0)
    return launch_bwd<4>(g, mask, dx, n, f, d, m_row_stride, mode, st);
  return launch_bwd<1>(g, mask, dx, n, f, d, m_row_stride, mode, st);
}

// The sum/mean backward instantiation `vec` (1: 16-byte, 0: 4-byte), as
// g4r_seg_aggr_attrs reports the forward's (residency at 256-thread
// blocks).
extern "C" int g4r_seg_aggr_bwd_attrs(int vec, int* out) {
  return vec ? bwd_attrs<4, false>(out) : bwd_attrs<1, false>(out);
}

// Backward of max (mode 2): g (N, D) contiguous, x (N, F, D) the forward's
// input with a row stride (F and D dense), the mask with a row stride, dx
// (N, F, D) contiguous. Takes the 16-byte path where D % 4 == 0, g's and
// x's bases are 16-byte aligned and x's row stride is a multiple of 4
// floats, else the 4-byte one.
extern "C" int g4r_seg_aggr_max_bwd_f32(const float* g, const float* x, const uint8_t* mask,
                                        float* dx, long long n, int f, int d,
                                        long long x_row_stride, long long m_row_stride,
                                        void* stream) {
  if (f < 0 || d < 0) return (int)cudaErrorInvalidValue;
  if (n <= 0 || f == 0 || d == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (d % 4 == 0 && x_row_stride % 4 == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(x) & 15) == 0)
    return launch_max_bwd<4>(g, x, mask, dx, n, f, d, x_row_stride, m_row_stride, st);
  return launch_max_bwd<1>(g, x, mask, dx, n, f, d, x_row_stride, m_row_stride, st);
}

// The max backward instantiation `vec`, as g4r_seg_aggr_bwd_attrs.
extern "C" int g4r_seg_aggr_max_bwd_attrs(int vec, int* out) {
  return vec ? bwd_attrs<4, true>(out) : bwd_attrs<1, true>(out);
}

// Text of a cudaError_t, for the Python wrappers' exceptions.
extern "C" const char* g4r_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
