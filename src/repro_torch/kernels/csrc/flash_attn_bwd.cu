// The backward of causal / sliding-window GQA flash attention, for Hopper
// (sm_90a), f32 and bf16, on the CUDA cores.
//
// Replaces no TPU kernel: repro's Pallas flash kernel has no VJP
// (repro/kernels/ops.py:139, flash_attention), and repro trains the LM on its
// XLA path (repro/models/layers.py:205, chunked_gqa_attention under
// jax.checkpoint), whose gradient XLA derives. The port's attention is the
// flash kernel on CUDA (flash_attn.cu), so its gradient is a kernel too. For
// q (B, Sq, H, hd) and k, v (B, Skv, K, hd), read in the model's layout
// through their strides (innermost stride 1), the forward's output o, its row
// log-sum-exp lse (B, H, Sq) f32 and the output's gradient dO:
//     P  = exp(S * scale - lse)       inside the causal / window band, else 0
//     dV = P^T dO                     dP = dO V^T
//     D  = rowsum(dO o O)             dS = P o (dP - D)
//     dQ = dS K * scale               dK = dS^T Q * scale
// with S = Q K^T, scale = 1 / sqrt(hd), head h reading KV head h / G (G = H /
// K), and dK, dV summed over the G query heads of each KV head. Every sum is
// taken in f32; outputs are written in the inputs' dtype.
//
// Three kernels a call (FA2's split), each output element written by one
// thread and summed in a fixed order, so two runs are bitwise equal (no
// atomics; conformance runs under torch.use_deterministic_algorithms):
//   - flash_bwd_dot_kernel: D, one warp a (b, i, h) row, lanes over hd,
//     then a shuffle tree.
//   - flash_bwd_dkdv_kernel: one block of 256 threads a (64-key tile, KV
//     head, batch row). K and V stay in shared memory; the block loops over
//     the G query heads and, for each, over the 64-query tiles of the band
//     (tiles that see none of its keys are skipped: causal from the diagonal
//     on, a window up to k_last + window - 1), recomputes S^T and dP^T for
//     the (key, query) tile, writes P^T and dS^T to shared memory and adds
//     P^T dO and dS^T Q into registers: each thread holds 4 keys x hd / 16
//     columns of dK and of dV.
//   - flash_bwd_dq_kernel: one block a (64-query tile, head, batch row),
//     Q, dO, lse and D in shared memory, looping over the KV tiles of the
//     band as the forward does, dS through shared memory into dQ.
// Any Sq and Skv (query rows past Sq and keys past Skv are zeros and get P =
// 0), hd 32, 64 and 128. S and dP are recomputed in both tile kernels, 14 hd
// FLOP a (query, key) pair against the 10 hd the math needs.
//
// What bounds it on this card: operations. At the model's shapes a pair costs
// 10 hd FLOP against a few bytes read per key row, far above either dtype's
// FLOP/byte balance. This first version runs on the CUDA cores in f32 (its
// bound: the band's FLOP over 67 TFLOP/s; bf16 inputs are widened as they
// are loaded, and their bound is the tensor cores' 989 TFLOP/s, which it
// cannot approach). The design keeps its shared-memory traffic conflict-free:
// tiles are f32 rows padded to hd + 1 floats (the 16 lanes of a half-warp
// read 16 rows, 16 banks), P and dS rows to 68 floats (the two half-warps of
// a warp write 16 banks apart). A wgmma backward is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kPS = 68;        // row stride (floats) of the P and dS tiles

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;  // (B, H, Sq)
  float* dd;         // D: (B, H, Sq)
  void *dq, *dk, *dv;  // contiguous (B, Sq, H, hd), (B, Skv, K, hd), (B, Skv, K, hd)
  int sq, skv, heads, kv_heads, group;
  // (batch, seq, head) strides in elements of q, k, v, o and dO
  long long qs[3], ks[3], vs[3], os[3], ds[3];
  float scale;
  int causal, window;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// rows r0 .. r0 + 63 of one head (``base`` at its row 0, rows ``rs`` elements
// apart) into an f32 tile of rows padded to HD + 1; rows at or past n are 0
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* base, long long rs, int r0,
                                          int n) {
  for (int i = threadIdx.x; i < 64 * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    dst[r * (HD + 1) + d] = r0 + r < n ? to_f(base[(long long)(r0 + r) * rs + d]) : 0.f;
  }
}

// lse and D of rows q0 .. q0 + 63 of one (b, h) into shared memory
__device__ __forceinline__ void load_rows(float* slse, float* sdd, const BwdArgs& a, int b,
                                          int h, int q0) {
  if (threadIdx.x < kBQ) {
    const int i = q0 + threadIdx.x;
    const long long at = ((long long)b * a.heads + h) * a.sq + i;
    slse[threadIdx.x] = i < a.sq ? a.lse[at] : 0.f;
    sdd[threadIdx.x] = i < a.sq ? a.dd[at] : 0.f;
  }
}

__device__ __forceinline__ bool visible(const BwdArgs& a, int qpos, int kpos) {
  return qpos < a.sq && kpos < a.skv && !(a.causal && kpos > qpos) &&
         !(a.window > 0 && kpos <= qpos - a.window);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dot_kernel(BwdArgs a, long long rows) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;  // the whole warp: one row a warp
  const int lane = threadIdx.x & 31;
  const int h = (int)(row % a.heads);
  const int i = (int)((row / a.heads) % a.sq);
  const int b = (int)(row / ((long long)a.heads * a.sq));
  const T* orow = (const T*)a.o + b * a.os[0] + i * a.os[1] + h * a.os[2];
  const T* drow = (const T*)a.dout + b * a.ds[0] + i * a.ds[1] + h * a.ds[2];
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < HD; d += 32) acc = fmaf(to_f(drow[d]), to_f(orow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.dd[((long long)b * a.heads + h) * a.sq + i] = acc;
}

template <int HD>
constexpr int dkdv_smem_bytes() {
  return 4 * (4 * 64 * (HD + 1) + 2 * 64 * kPS + 2 * 64);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(BwdArgs a) {
  constexpr int RS = HD + 1;    // row stride of the K, V, Q and dO tiles
  constexpr int CPT = HD / 16;  // dK / dV columns per thread
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + kBK * RS;
  float* sqt = sv + kBK * RS;
  float* sdo = sqt + kBQ * RS;
  float* sp = sdo + kBQ * RS;  // P^T: (key, query)
  float* sds = sp + kBK * kPS;  // dS^T
  float* slse = sds + kBK * kPS;
  float* sdd = slse + kBQ;

  const int k0 = blockIdx.x * kBK, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  load_tile<T, HD>(sk, (const T*)a.k + b * a.ks[0] + kh * a.ks[2], a.ks[1], k0, a.skv);
  load_tile<T, HD>(sv, (const T*)a.v + b * a.vs[0] + kh * a.vs[2], a.vs[1], k0, a.skv);

  float dk[4][CPT], dv[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dk[i][c] = dv[i][c] = 0.f;

  // the query tiles some row of which sees a key of this tile
  int qt_lo = 0, qt_hi = (a.sq - 1) / kBQ;
  if (a.causal) qt_lo = k0 / kBQ;
  if (a.window > 0)  // the last query that sees the tile's last key
    qt_hi = (int)min((long long)qt_hi,
                     ((long long)min(k0 + kBK, a.skv) - 2 + a.window) / kBQ);

  for (int g = 0; g < a.group; ++g) {
    const int h = kh * a.group + g;
    const T* qb = (const T*)a.q + b * a.qs[0] + h * a.qs[2];
    const T* db = (const T*)a.dout + b * a.ds[0] + h * a.ds[2];
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // the previous tile's Q, dO, P and dS are consumed
      load_tile<T, HD>(sqt, qb, a.qs[1], q0, a.sq);
      load_tile<T, HD>(sdo, db, a.ds[1], q0, a.sq);
      load_rows(slse, sdd, a, b, h, q0);
      __syncthreads();

      // S^T and dP^T for keys ty*4 + i, queries tx + 16 j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float kr[4], vr[4], qr[4], dr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kr[i] = sk[(ty * 4 + i) * RS + d];
          vr[i] = sv[(ty * 4 + i) * RS + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qr[j] = sqt[(tx + 16 * j) * RS + d];
          dr[j] = sdo[(tx + 16 * j) * RS + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kr[i], qr[j], s[i][j]);
            dp[i][j] = fmaf(vr[i], dr[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          const float p = visible(a, q0 + r, k0 + ty * 4 + i)
                              ? expf(s[i][j] * a.scale - slse[r]) : 0.f;
          sp[(ty * 4 + i) * kPS + r] = p;
          sds[(ty * 4 + i) * kPS + r] = p * (dp[i][j] - sdd[r]);
        }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q over the tile's 64 queries, in order
#pragma unroll 4
      for (int r = 0; r < kBQ; ++r) {
        float pr[4], sr[4], dor[CPT], qr[CPT];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pr[i] = sp[(ty * 4 + i) * kPS + r];
          sr[i] = sds[(ty * 4 + i) * kPS + r];
        }
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          dor[c] = sdo[r * RS + tx + 16 * c];
          qr[c] = sqt[r * RS + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            dv[i][c] = fmaf(pr[i], dor[c], dv[i][c]);
            dk[i][c] = fmaf(sr[i], qr[c], dk[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty * 4 + i;
    if (kpos >= a.skv) continue;
    const long long at = (((long long)b * a.skv + kpos) * a.kv_heads + kh) * HD;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      ((T*)a.dk)[at + tx + 16 * c] = from_f<T>(dk[i][c] * a.scale);
      ((T*)a.dv)[at + tx + 16 * c] = from_f<T>(dv[i][c]);
    }
  }
}

template <int HD>
constexpr int dq_smem_bytes() {
  return 4 * (4 * 64 * (HD + 1) + 64 * kPS + 2 * 64);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(BwdArgs a) {
  constexpr int RS = HD + 1;
  constexpr int CPT = HD / 16;
  extern __shared__ float smem[];
  float* sqt = smem;
  float* sdo = sqt + kBQ * RS;
  float* sk = sdo + kBQ * RS;
  float* sv = sk + kBK * RS;
  float* sds = sv + kBK * RS;  // dS: (query, key)
  float* slse = sds + kBQ * kPS;
  float* sdd = slse + kBQ;

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / a.group;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  load_tile<T, HD>(sqt, (const T*)a.q + b * a.qs[0] + h * a.qs[2], a.qs[1], q0, a.sq);
  load_tile<T, HD>(sdo, (const T*)a.dout + b * a.ds[0] + h * a.ds[2], a.ds[1], q0, a.sq);
  load_rows(slse, sdd, a, b, h, q0);
  const T* kb = (const T*)a.k + b * a.ks[0] + kh * a.ks[2];
  const T* vb = (const T*)a.v + b * a.vs[0] + kh * a.vs[2];

  float dq[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dq[i][c] = 0.f;

  // the band of KV tiles some query of this tile can see (as the forward)
  const int q_last = min(q0 + kBQ, a.sq) - 1;
  int kt_hi = (a.skv - 1) / kBK;
  if (a.causal) kt_hi = min(kt_hi, q_last / kBK);
  int kt_lo = 0;
  if (a.window > 0) {
    const int lo = q0 - a.window + 1;
    kt_lo = lo > 0 ? lo / kBK : 0;
  }

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K, V and dS are consumed
    load_tile<T, HD>(sk, kb, a.ks[1], k0, a.skv);
    load_tile<T, HD>(sv, vb, a.vs[1], k0, a.skv);
    __syncthreads();

    // S and dP for queries ty*4 + i, keys tx + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qr[4], dr[4], kr[4], vr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qr[i] = sqt[(ty * 4 + i) * RS + d];
        dr[i] = sdo[(ty * 4 + i) * RS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kr[j] = sk[(tx + 16 * j) * RS + d];
        vr[j] = sv[(tx + 16 * j) * RS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
          dp[i][j] = fmaf(dr[i], vr[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = visible(a, q0 + r, k0 + tx + 16 * j)
                            ? expf(s[i][j] * a.scale - slse[r]) : 0.f;
        sds[r * kPS + tx + 16 * j] = p * (dp[i][j] - sdd[r]);
      }
    }
    __syncthreads();

    // dQ += dS K over the tile's 64 keys, in order
#pragma unroll 4
    for (int c0 = 0; c0 < kBK; ++c0) {
      float sr[4], kr[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) sr[i] = sds[(ty * 4 + i) * kPS + c0];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kr[c] = sk[c0 * RS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) dq[i][c] = fmaf(sr[i], kr[c], dq[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= a.sq) continue;
    const long long at = (((long long)b * a.sq + qpos) * a.heads + h) * HD;
#pragma unroll
    for (int c = 0; c < CPT; ++c) ((T*)a.dq)[at + tx + 16 * c] = from_f<T>(dq[i][c] * a.scale);
  }
}

template <typename T, int HD>
int launch_bwd(const BwdArgs& a, int b_rows, cudaStream_t stream) {
  constexpr int dkdv_smem = dkdv_smem_bytes<HD>(), dq_smem = dq_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)b_rows * a.sq * a.heads;
  const long long dot_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (dot_blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  flash_bwd_dot_kernel<T, HD><<<(unsigned)dot_blocks, kThreads, 0, stream>>>(a, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 kv_grid((unsigned)((a.skv + kBK - 1) / kBK), (unsigned)a.kv_heads, (unsigned)b_rows);
  flash_bwd_dkdv_kernel<T, HD><<<kv_grid, kThreads, dkdv_smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 q_grid((unsigned)((a.sq + kBQ - 1) / kBQ), (unsigned)a.heads, (unsigned)b_rows);
  flash_bwd_dq_kernel<T, HD><<<q_grid, kThreads, dq_smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const BwdArgs& a, int hd, int b_rows, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_bwd<T, 32>(a, b_rows, stream);
    case 64: return launch_bwd<T, 64>(a, b_rows, stream);
    case 128: return launch_bwd<T, 128>(a, b_rows, stream);
  }
  return (int)cudaErrorInvalidValue;
}

int fill_attrs(const void* fn, int smem, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = smem;
  return 0;
}

template <typename T, int HD>
int attrs_of(int which, int* out) {
  switch (which) {
    case 0: return fill_attrs((const void*)flash_bwd_dot_kernel<T, HD>, 0, out);
    case 1: return fill_attrs((const void*)flash_bwd_dkdv_kernel<T, HD>, dkdv_smem_bytes<HD>(),
                              out);
    case 2: return fill_attrs((const void*)flash_bwd_dq_kernel<T, HD>, dq_smem_bytes<HD>(), out);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int attrs_hd(int hd, int which, int* out) {
  switch (hd) {
    case 32: return attrs_of<T, 32>(which, out);
    case 64: return attrs_of<T, 64>(which, out);
    case 128: return attrs_of<T, 128>(which, out);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B, Sq, H, hd), k and v (B, Skv, K, hd), o and dout (B, Sq, H, hd), all of
// one dtype (0: f32, 1: bf16), innermost stride 1; ``strides`` holds the
// (batch, seq, head) strides in elements of q, k, v, o and dout, 15 in all.
// lse (B, H, Sq) f32 from the forward; dd a (B, H, Sq) f32 scratch for D;
// dq, dk, dv contiguous outputs in the inputs' dtype. window <= 0 means none.
// Three launches on ``stream``; returns cudaGetLastError() after them.
extern "C" int g4r_flash_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, const float* lse, float* dd, void* dq,
                                  void* dk, void* dv, int dtype, int b_rows, int sq, int skv,
                                  int heads, int kv_heads, int hd, const long long* strides,
                                  float scale, int causal, int window, void* stream) {
  if (b_rows <= 0 || sq <= 0 || heads <= 0) return (int)cudaGetLastError();
  if (kv_heads <= 0 || heads % kv_heads != 0 || skv <= 0) return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.lse = lse; a.dd = dd; a.dq = dq; a.dk = dk; a.dv = dv;
  a.sq = sq; a.skv = skv; a.heads = heads; a.kv_heads = kv_heads;
  a.group = heads / kv_heads;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
    a.ds[i] = strides[12 + i];
  }
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_hd<float>(a, hd, b_rows, s);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(a, hd, b_rows, s);
  return (int)cudaErrorInvalidValue;
}

// Registers, local memory (spills and stack) and dynamic shared memory of the
// backward's kernel ``which`` (0 the D pass, 1 dK/dV, 2 dQ) for (dtype, hd):
// out[0..2]. Returns a cudaError_t.
extern "C" int g4r_flash_attn_bwd_attrs(int dtype, int hd, int which, int* out) {
  if (dtype == 0) return attrs_hd<float>(hd, which, out);
  if (dtype == 1) return attrs_hd<__nv_bfloat16>(hd, which, out);
  return (int)cudaErrorInvalidValue;
}
