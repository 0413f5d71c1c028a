// Blockwise online-softmax (flash) attention, causal / sliding-window GQA,
// forward only, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attn.py:flash_attention_pallas
// (pallas_call at :103). q (B, Sq, H, hd) and k, v (B, Skv, K, hd), read in
// the model's layout through their strides (the innermost stride is 1), give
//     o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / G] * scale) v[b, j, h / G]
// with G = H / K, scale = 1 / sqrt(hd), key j masked (logit -1e30) unless
// j <= i (causal) and j > i - window (sliding window). The softmax is the
// Pallas kernel's online one in f32: m starts at -1e30, alpha =
// exp(m_prev - m_new), p stays f32 in the PV product, and the output is
// acc / max(l, 1e-30), written in q's dtype (f32 or bf16).
//
// Unlike the Pallas kernel, which asserts Sq % block_q == 0, any Sq and Skv
// work: query rows past Sq are computed and not stored, and keys past Skv
// get p = 0 (a logit of -inf, not -1e30, so a tile whose real keys are all
// masked behaves exactly as in the Pallas kernel).
//
// What bounds it on this card: operations. Attention at the model's shapes
// does 4 * hd FLOP per (query, key) pair in the band against 2 * hd * 2
// bytes (bf16) read per key row once, far above the 295 FLOP/byte where
// bf16 turns compute-bound; this first version runs the products on f32
// CUDA cores (67 TFLOP/s), so its bound is the band's FLOP over 67 TFLOP/s
// (the tensor cores' 989 TFLOP/s is the bound of a later wgmma version).
//
// How the design answers it, simply:
//   - One block of 256 threads per (64-query tile, head, batch row). It
//     loops over the 64-key tiles of its band in order, so the running max,
//     sum and accumulator never leave the block (the Pallas kernel carries
//     them in VMEM scratch across its sequential KV grid axis).
//   - KV tiles wholly outside the causal band or the window are never
//     loaded (the Pallas kernel's pl.when): the loop runs from the first
//     tile that reaches the window to the last tile at or below the tile's
//     last query, which is what keeps a window linear in S.
//   - The Q tile, the K tile (transposed) and the V tile are staged in
//     shared memory as f32, with padded rows so that the reads of the
//     register-tiled products hit distinct banks. Each thread owns a 4 x 4
//     block of the 64 x 64 score tile and a 4 x hd/16 block of the
//     accumulator; a query row's 16 threads sit in one half-warp, so the
//     row max and sum are shuffles. P goes through shared memory to the PV
//     product.
//   - Shared memory is 41 KB (hd 32), 66 KB (hd 64) or 115 KB (hd 128),
//     above the 48 KB default for the last two: the launcher raises the
//     limit with cudaFuncSetAttribute first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int HD>
constexpr int smem_floats() {
  // Q (kBQ x HD+1), K^T (HD x kBK+1), V (kBK x HD), P (kBQ x kBK+1)
  return kBQ * (HD + 1) + HD * (kBK + 1) + kBK * HD + kBQ * (kBK + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int sq, int skv,
                 int group, long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh, long long vsb,
                 long long vss, long long vsh, long long osb, long long oss,
                 long long osh, float scale, int causal, int window) {
  constexpr int QS = HD + 1;   // row stride of the Q tile
  constexpr int KS = kBK + 1;  // row stride of K^T and P
  constexpr int CPT = HD / 16; // accumulator columns per thread
  extern __shared__ float smem[];
  float* sq_t = smem;
  float* sk_t = sq_t + kBQ * QS;
  float* sv_t = sk_t + HD * KS;
  float* sp_t = sv_t + kBK * HD;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / group;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows ty*4 .. ty*4+3 of the tile
  const int tx = tid & 15;  // columns tx + 16*j

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kh * ksh;
  const T* vb = v + b * vsb + kh * vsh;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    const int qpos = q0 + r;
    sq_t[r * QS + d] = qpos < sq ? to_f32(qb[qpos * qss + d]) : 0.f;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  // the band of KV tiles some query of this tile can see
  const int q_last = min(q0 + kBQ, sq) - 1;
  int kt_hi = (skv - 1) / kBK;
  if (causal) kt_hi = min(kt_hi, q_last / kBK);
  int kt_lo = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;  // the lowest key any row can see
    kt_lo = lo > 0 ? lo / kBK : 0;
  }

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i - r * HD;
      const int kpos = k0 + r;
      const bool in = kpos < skv;
      sk_t[d * KS + r] = in ? to_f32(kb[kpos * kss + d]) : 0.f;
      sv_t[r * HD + d] = in ? to_f32(vb[kpos * vss + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qa[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sq_t[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sk_t[d * KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kpos >= skv) {
          x = -INFINITY;  // not a key: p = 0
        } else if ((causal && kpos > qpos) || (window > 0 && kpos <= qpos - window)) {
          x = kNegInf;
        }
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        sp_t[(ty * 4 + i) * KS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sp_t[(ty * 4 + i) * KS + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = sv_t[kk * HD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + b * osb + qpos * oss + h * osh;
#pragma unroll
    for (int c = 0; c < CPT; ++c) from_f32(orow + tx + 16 * c, acc[i][c] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int b_rows,
           int sq, int skv, int heads, int group, const long long* st, float scale,
           int causal, int window, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((sq + kBQ - 1) / kBQ), (unsigned)heads, (unsigned)b_rows);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, skv, group, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale,
      causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                int b_rows, int sq, int skv, int heads, int group, const long long* st,
                float scale, int causal, int window, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, b_rows, sq, skv, heads, group, st, scale, causal,
                           window, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, b_rows, sq, skv, heads, group, st, scale, causal,
                           window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, b_rows, sq, skv, heads, group, st, scale, causal,
                            window, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, H, hd), k and v (B, Skv, K, hd), o (B, Sq, H, hd), all of one
// dtype (0: f32, 1: bf16), innermost stride 1; strides in elements for the
// (batch, sequence, head) axes of q, k, v and o. window <= 0 means none.
// Returns cudaGetLastError() after the launch.
extern "C" int g4r_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                  int dtype, int b_rows, int sq, int skv, int heads,
                                  int kv_heads, int hd, long long qsb, long long qss,
                                  long long qsh, long long ksb, long long kss,
                                  long long ksh, long long vsb, long long vss,
                                  long long vsh, long long osb, long long oss,
                                  long long osh, float scale, int causal, int window,
                                  void* stream) {
  if (b_rows <= 0 || sq <= 0 || heads <= 0) return (int)cudaGetLastError();
  if (kv_heads <= 0 || heads % kv_heads != 0 || skv <= 0) return (int)cudaErrorInvalidValue;
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh};
  const int group = heads / kv_heads;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, b_rows, sq, skv, heads, group, st, scale,
                              causal, window, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, b_rows, sq, skv, heads, group, st,
                                      scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
