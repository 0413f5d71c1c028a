// Blockwise online-softmax (flash) attention, causal / sliding-window GQA,
// the forward, for Hopper (sm_90a); the backward is flash_attn_bwd.cu, and
// the Hopper building blocks both use (mbarriers, TMA, wgmma) hopper.cuh.
//
// Replaces the TPU kernel repro/kernels/flash_attn.py:flash_attention_pallas
// (pallas_call at :103). q (B, Sq, H, hd) and k, v (B, Skv, K, hd), read in
// the model's layout through their strides (the innermost stride is 1), give
//     o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / G] * scale) v[b, j, h / G]
// with G = H / K, scale = 1 / sqrt(hd), key j masked (logit -1e30) unless
// j <= i (causal) and j > i - window (sliding window). The softmax is the
// Pallas kernel's online one in f32: m starts at -1e30, alpha =
// exp(m_prev - m_new), and the output is acc / max(l, 1e-30), written in q's
// dtype. Unlike the Pallas kernel, which asserts Sq % block_q == 0, any Sq and
// Skv work: query rows past Sq are computed and not stored, and keys past Skv
// get p = 0 (a logit of -inf, not -1e30, so a tile whose real keys are all
// masked behaves exactly as in the Pallas kernel: p = 1, wiped later by
// alpha = 0). KV tiles wholly outside the causal band or the window are never
// loaded (the Pallas kernel's pl.when), which keeps a window linear in S.
// Where the caller passes an lse pointer (the training forward), each stored
// row also writes its log-sum-exp, lse[b, h, i] = m + log l in natural
// units, one f32 a row, which the backward's P = exp(s * scale - lse) needs;
// the prefill passes null and stores nothing more.
//
// What bounds it on this card: operations. Attention at the model's shapes
// does 4 * hd FLOP per (query, key) pair in the band against 2 * hd * 2 bytes
// (bf16) read per key row once, far above the 295 FLOP/byte where bf16 turns
// compute-bound. Two kernels, chosen by dtype:
//
// bf16: flash_fwd_kernel_wgmma, on the tensor cores (bound: the band's FLOP
// over 989 TFLOP/s).
//   - S = Q K^T and O += P V run as wgmma.mma_async m64nNk16, bf16 inputs, f32
//     accumulators (bf16 x bf16 products are exact in f32, so S differs from
//     the f32 kernel's only in summation order). Q and K are K-major as they
//     lie in (S, hd) rows; V's tile is MN-major for the PV product, which the
//     descriptor's transpose bit takes, so nothing is transposed in memory.
//   - Tiles arrive by TMA (cp.async.bulk.tensor, 4-d maps over (hd, heads, S,
//     B) in elements, encoded on the host per call and passed
//     __grid_constant__) into 128-byte-swizzled shared rows, the layout the
//     wgmma descriptors name: one 64-column bf16 panel is one 128-byte row, hd
//     128 takes two panels and hd 32 one panel whose columns 32-63 TMA fills
//     with zeros (the QK product skips them; the PV product's extra columns
//     are not stored). TMA needs 16-byte strides and base addresses: the
//     wrapper checks both and raises before the launch; there is no fallback.
//   - A block is 128 query rows of one (head, batch row): two consumer
//     warpgroups of 64 rows and a producer. One lane of the producer's first
//     warp keeps the next K/V tile (128 keys) in flight in a ring of two
//     stages, with a full and an empty mbarrier per stage, while the
//     consumers multiply the current one. Q comes once, on its own mbarrier.
//   - P stays in registers: after the row max, exp2 and rescale, the f32 S
//     accumulator is rounded to bf16 in place and fed as the register A
//     operand of the PV wgmma (the accumulator's fragment layout is the A
//     fragment's: no shared-memory round trip, no __syncthreads). The row sum
//     l accumulates the f32 p, kept per thread and summed over the row's quad
//     once at the end. The softmax runs in the log2 domain (logits times
//     scale * log2 e, exp2), which is exp() rounded differently.
//   - Only tiles that straddle the diagonal, the window's edge or Skv
//     evaluate the mask. Query tiles are issued longest band first (blockIdx.z
//     counts down along Sq), so the causal triangle leaves no tail of idle
//     SMs.
//   - Registers are the limit. A consumer thread holds 64 f32 of S, 32 (hd
//     32, 64) or 64 (hd 128) of O and 32 of the bf16 P fragment. With a lone
//     producer warp (288 threads) ptxas still capped a thread at 168
//     registers, the share of 384 threads (384 x 168 = 64,512 of 65,536): at
//     hd 128 that serialised the wgmmas or spilled. So the producer is a
//     warpgroup whose setmaxnreg.dec gives back all but 24
//     registers a thread, and the consumers' setmaxnreg.inc takes them, 240
//     a thread (256 x 240 + 128 x 24 = 64,512). nvcc -Xptxas -v: 168 at
//     entry, no spills, for every head dim; chip_smoke.py prints registers
//     and local memory per instantiation and fails on a spill.
//   - Shared memory: Q 16 KB a panel, each of the 2 stages 2 x 16 KB a
//     panel, 1 KB for alignment: 81 KB at hd 32 and 64, 161 KB at hd 128,
//     above the 48 KB default, so the launcher raises the limit with
//     cudaFuncSetAttribute first.
//
// f32: flash_fwd_kernel<HD>, on the CUDA cores (bound: the band's FLOP over
// 67 TFLOP/s; a kernel of FMAs alone sustains 60.7 on an H100 at 700 W,
// scripts/flash_f32_variants.py). f32 FMAs only: the tensor cores cannot keep
// the f32 contract (TF32 off, rtol 1e-5 against the plain version). The first
// version (one 4-byte shared load for every 2 FMAs, a scalar transpose of K,
// synchronous loads, the mask on every tile, the shortest band first) ran at
// 28 % of the bound; this one is laid out as the backward's f32 tiles
// (flash_attn_bwd.cu), with register tiles twice as large:
//   - 16-byte shared operands. Q, K and V tiles stay hd-contiguous in shared
//     memory, rows padded to hd + 4 floats (8 consecutive rows on 8 distinct
//     4-bank groups); S = Q K^T reads Q and K rows as float4 along hd, P V
//     reads P as float4 along the key axis (rows padded to keys + 8) and V
//     rows as float4 (float2 at hd 32) along the columns. A warp's lanes
//     cover 4 rows x 8 keys (or column vectors), so each load touches 4 or 8
//     distinct rows, conflict-free.
//   - 8 x 8 register tiles: a thread holds 8 query rows x 8 keys of S and
//     its 8 rows x hd / TK columns of O, so a shared float feeds 4 FMAs (the
//     SM's shared memory delivers 32 floats a clock against 128 FMA lanes).
//     On an H100 at smollm's training call (hd 64) 4 x 4 tiles read 0.635
//     ms, 8 x 8 0.573.
//   - The row's threads in one warp where they fit (F32Cfg's KW). At hd 32
//     and 64 a block is 4 warps, each 4 x 8 lanes over its own 32 rows, 128
//     rows x 64-key tiles: the row max and sum are 3 shuffles, P goes from a
//     warp to itself (no barrier), and two blocks share an SM (254
//     registers; 106,496 and 73,728 bytes), the softmax of one between the
//     products of the other: 0.539 ms against 0.573 for one 8-warp block,
//     whose warps all meet at every barrier. At hd 128 a row's 8 x 16
//     columns of O would take too many registers, so two warps share
//     128-key tiles (maxima and sums exchanged through shared memory, a
//     named barrier a warp pair) in one 8-warp block of 254 registers, P
//     written over the K tile it came from (Q, K and V take 203,776 bytes):
//     1.753 ms against 1.864 for 4-warp blocks of 4 x 8 tiles, two an SM.
//   - cp.async tiles, 16 bytes a copy (the wrapper copies an f32 operand
//     whose base or strides are off 16 bytes), into one K and one V buffer:
//     V comes during Q K^T and, where P has its own buffer, the next K tile
//     during P V. A second K/V buffer, tried where it fit, gained nothing.
//   - Longest band first: query tiles on blockIdx.z counting down along Sq,
//     as the bf16 kernel's; only tiles that straddle the diagonal, the
//     window's edge or Skv evaluate the mask.
//   - The softmax in the log2 domain: Q is scaled by scale log2 e once in
//     shared memory, exponentials by ex2.approx.ftz (results under 2^-126
//     flushed: 1 instruction against exp2f's 4); the masked logit is -1e30
//     log2 e, so the LSE, (m + log2 l) ln 2, leaves in natural units. Each
//     thread keeps its keys' share of the row sum until the end.
//   - Each output element and LSE is written by one thread and summed in a
//     fixed order: no atomics, re-runs bitwise.
// At the training calls (H100 80GB HBM3, 700 W, scripts/kernel_ab.py in turns
// with the first version): smollm's B 4 x S 2,048, H 9, K 3, hd 64 1.04 ->
// 0.539 ms (bound 0.289, SDPA 3.04); OLMoE's H = K = 16, hd 128 3.16 -> 1.741
// (bound 1.026, SDPA 1.686). chip_smoke.py fails on a spill of any
// instantiation.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ------------------------------------------------------------- f32 kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// the masked logit, -1e30 in natural units, in the log2 domain: so m + log l
// of a row whose keys are all masked is -1e30 in natural units, as the plain
// version's
constexpr float kNegInfLog2 = kNegInf * kLog2e;

// ``blocks`` blocks of ``bytes`` of shared memory fit an SM (228 KB, 1 KB of
// it reserved a block)
constexpr bool fits_sm(int blocks, int bytes) { return blocks * (bytes + 1024) <= 233472; }

// The f32 kernel's shape. A warp's 32 lanes cover 4 row groups x 8 key
// groups, so that each shared-memory load touches 4 or 8 distinct rows; KW
// warps (1 or 2) side by side, a set, cover TK = 8 KW key groups of the same
// row groups, and the block's THREADS / 32 / KW sets cover TR = 4 sets row
// groups. A thread holds RQ rows (qg + TR i) and RK keys (kg + TK j) of S,
// and the same rows x HD / TK columns of O; a block takes BQ = TR RQ query
// rows and tiles of BK = TK RK keys, one K and one V buffer. MIN_BLOCKS
// blocks an SM (__launch_bounds__); P_IN_K: the P tile written over the K
// tile it was computed from (its keys are done with by then), which saves
// the P tile's shared memory.
template <int HD_, int THREADS_, int KW_, int RQ_, int RK_, int MIN_BLOCKS_, bool P_IN_K_>
struct F32Cfg {
  static constexpr int HD = HD_, THREADS = THREADS_, KW = KW_, RQ = RQ_, RK = RK_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr bool P_IN_K = P_IN_K_;
  static constexpr int SETS = THREADS / 32 / KW;
  static constexpr int TR = 4 * SETS, TK = 8 * KW;  // row groups, key groups
  static constexpr int BQ = TR * RQ;          // query rows a block
  static constexpr int BK = TK * RK;          // keys a K/V tile
  static constexpr int RS = HD + 4;           // row stride (floats) of the Q, K and V tiles
  static constexpr int KV = BK * RS;          // floats of one K (or V) tile
  // row stride of the P tile: 8 past a multiple of 32 banks, so that the
  // scalar stores of a warp's 4 rows x 8 keys hit 32 banks; 4 past where P
  // must fit in a K tile of stride RS (the stores then meet 2-way conflicts)
  static constexpr int PS = P_IN_K && BK + 8 > RS ? BK + 4 : BK + 8;
  static constexpr int CPT = HD / TK;           // columns of O a thread
  static constexpr int VW = CPT >= 4 ? 4 : 2;   // columns of one V load and one O store
  static constexpr int NV = CPT / VW;           // vectors of columns a thread
  // floats: Q, K, V, P (unless in K), the sets' exchange (BQ x 2)
  static constexpr int P_OFF = BQ * RS + 2 * KV;
  static constexpr int X_OFF = P_OFF + (P_IN_K ? 0 : BQ * PS);
  static constexpr int SMEM = 4 * (X_OFF + (KW == 2 ? 2 * BQ : 0));
  static_assert(KW == 1 || KW == 2, "a row's keys in one warp or two");
  static_assert(THREADS % (32 * KW) == 0 && CPT % VW == 0, "threads do not tile the block");
  static_assert(!P_IN_K || BQ * PS <= KV, "the P tile does not fit in a K tile");
  static_assert(fits_sm(MIN_BLOCKS, SMEM), "MIN_BLOCKS blocks do not fit an SM");
};

// The shape each head dim runs (scripts/flash_f32_variants.py times the others)
template <int HD>
struct F32Fwd;
template <>
struct F32Fwd<32> : F32Cfg<32, 128, 1, 8, 8, 2, false> {};
template <>
struct F32Fwd<64> : F32Cfg<64, 128, 1, 8, 8, 2, false> {};
template <>
struct F32Fwd<128> : F32Cfg<128, 256, 2, 8, 8, 1, true> {};

// rows r0 .. r0 + n_rows - 1 of one head (``base`` at its row 0, rows ``rs``
// floats apart) into a tile of rows RS floats apart by 16-byte cp.async
// copies (the wrapper hands over operands whose base and strides are 16-byte
// multiples), rows at or past n zeros
template <class C>
__device__ __forceinline__ void rows_async(float* dst, const float* base, long long rs, int r0,
                                           int n, int n_rows) {
  for (int i = threadIdx.x; i < n_rows * C::HD / 4; i += C::THREADS) {
    const int r = i / (C::HD / 4), d = 4 * (i - r * (C::HD / 4));
    const bool in = r0 + r < n;
    cp_async16(smem_addr(dst + r * C::RS + d), in ? base + (long long)(r0 + r) * rs + d : base,
               in);
  }
}

// 2^x on the special-function unit, results under 2^-126 flushed to 0 (exp2f
// spends three more instructions a call to keep them)
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the warps of one set, which hold the same query rows
template <class C>
__device__ __forceinline__ void set_sync(int set) {
  if constexpr (C::KW == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + set), "n"(32 * C::KW) : "memory");
  }
}

// s[i][j] = q_i . k_j over hd for the rows ``qg`` + TR i of the Q tile and
// the keys ``kg`` + TK j of the K tile, four columns a load
template <class C>
__device__ __forceinline__ void qk_f32(float (&s)[C::RQ][C::RK], const float* sq,
                                       const float* sk, int qg, int kg) {
#pragma unroll
  for (int i = 0; i < C::RQ; ++i)
#pragma unroll
    for (int j = 0; j < C::RK; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < C::HD; d += 4) {
    float4 x[C::RQ], y[C::RK];
#pragma unroll
    for (int i = 0; i < C::RQ; ++i)
      x[i] = *reinterpret_cast<const float4*>(sq + (qg + C::TR * i) * C::RS + d);
#pragma unroll
    for (int j = 0; j < C::RK; ++j)
      y[j] = *reinterpret_cast<const float4*>(sk + (kg + C::TK * j) * C::RS + d);
#pragma unroll
    for (int i = 0; i < C::RQ; ++i)
#pragma unroll
      for (int j = 0; j < C::RK; ++j) {
        s[i][j] = fmaf(x[i].x, y[j].x, s[i][j]);
        s[i][j] = fmaf(x[i].y, y[j].y, s[i][j]);
        s[i][j] = fmaf(x[i].z, y[j].z, s[i][j]);
        s[i][j] = fmaf(x[i].w, y[j].w, s[i][j]);
      }
  }
}

// acc[i][c] += sum over the tile's BK keys, in order, of p[row i][key] v[key][col c]
// for the rows ``qg`` + TR i and the columns (kg + TK m) VW + e; P read four
// keys a load, V one vector of VW columns a load
template <class C>
__device__ __forceinline__ void pv_f32(float (&acc)[C::RQ][C::CPT], const float* sp,
                                       const float* sv, int qg, int kg) {
#pragma unroll 2
  for (int kk = 0; kk < C::BK; kk += 4) {
    float4 p4[C::RQ];
#pragma unroll
    for (int i = 0; i < C::RQ; ++i)
      p4[i] = *reinterpret_cast<const float4*>(sp + (qg + C::TR * i) * C::PS + kk);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float vv[C::CPT];
      const float* vrow = sv + (kk + e) * C::RS;
#pragma unroll
      for (int m = 0; m < C::NV; ++m) {
        if constexpr (C::VW == 4) {
          const float4 x = *reinterpret_cast<const float4*>(vrow + (kg + C::TK * m) * 4);
          vv[4 * m] = x.x; vv[4 * m + 1] = x.y; vv[4 * m + 2] = x.z; vv[4 * m + 3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(vrow + (kg + C::TK * m) * 2);
          vv[2 * m] = x.x; vv[2 * m + 1] = x.y;
        }
      }
#pragma unroll
      for (int i = 0; i < C::RQ; ++i) {
        const float p = e == 0 ? p4[i].x : e == 1 ? p4[i].y : e == 2 ? p4[i].z : p4[i].w;
#pragma unroll
        for (int c = 0; c < C::CPT; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }
}

template <int HD, class C = F32Fwd<HD>>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int sq, int skv,
                 int group, long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh, long long vsb,
                 long long vss, long long vsh, long long osb, long long oss,
                 long long osh, float* __restrict__ lse, float scale_log2, int causal,
                 int window) {
  static_assert(C::HD == HD, "a shape for another head dim");
  constexpr int RQ = C::RQ, RK = C::RK, CPT = C::CPT, BQ = C::BQ, BK = C::BK;
  constexpr int TR = C::TR, TK = C::TK;
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;
  float* sk = s_q + BQ * C::RS;  // K, and P where P_IN_K
  float* sv = sk + C::KV;
  float* s_x = smem + C::X_OFF;  // KW 2: (row, warp of the set) row maxima, then row sums

  const int h = blockIdx.x, b = blockIdx.y, kh = h / group;
  const int q0 = ((int)gridDim.z - 1 - (int)blockIdx.z) * BQ;  // longest band first
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // S: rows qg + TR i, keys kg + TK j; O: rows qg + TR i, columns (kg + TK m) VW + e;
  // the TK threads of a row are the lanes of the set's warps that share lane >> 3
  const int set = warp / C::KW, kw = warp % C::KW;
  const int qg = set * 4 + (lane >> 3), kg = kw * 8 + (lane & 7);

  const float* kb = k + b * ksb + kh * ksh;
  const float* vb = v + b * vsb + kh * vsh;

  // the band of KV tiles some query of this tile can see
  const int q_last = min(q0 + BQ, sq) - 1;
  int kt_hi = (skv - 1) / BK;
  if (causal) kt_hi = min(kt_hi, q_last / BK);
  int kt_lo = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;  // the lowest key any row can see
    kt_lo = lo > 0 ? lo / BK : 0;
  }

  rows_async<C>(s_q, q + b * qsb + h * qsh, qss, q0, sq, BQ);
  if (!C::P_IN_K) rows_async<C>(sk, kb, kss, kt_lo * BK, skv, BK);
  cp_async_commit();
  // Q times scale log2 e, once: each thread scales what it copied (the loop's
  // first barrier shows it to the others), so S comes in the log2 domain
  cp_async_wait<0>();
  for (int i = tid; i < BQ * C::HD / 4; i += C::THREADS) {
    const int r = i / (C::HD / 4), d = 4 * (i - r * (C::HD / 4));  // as rows_async copied it
    float4* x = reinterpret_cast<float4*>(s_q + r * C::RS + d);
    *x = make_float4(x->x * scale_log2, x->y * scale_log2, x->z * scale_log2, x->w * scale_log2);
  }

  float m[RQ], l[RQ], acc[RQ][CPT];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInfLog2;
    l[i] = 0.f;  // this thread's keys' share of the row sum
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // tile kt - 1 (its P and V, and K where P was written over it) is done with
    if (C::P_IN_K) {
      rows_async<C>(sk, kb, kss, k0, skv, BK);
      cp_async_commit();
    }  // else K came during tile kt - 1's P V
    rows_async<C>(sv, vb, vss, k0, skv, BK);  // in flight during Q K^T
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // Q and K are in

    float s[RQ][RK];
    qk_f32<C>(s, s_q, sk, qg, kg);

    // logits in the log2 domain; the mask only on tiles that straddle the
    // diagonal, the window's edge or Skv
    const bool edge = (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && k0 <= q0 + BQ - 1 - window) || k0 + BK > skv;
    float mt[RQ];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      mt[i] = -INFINITY;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        float x = s[i][j];
        if (edge) {
          const int kpos = k0 + kg + TK * j, qpos = q0 + qg + TR * i;
          if (kpos >= skv) {
            x = -INFINITY;  // not a key: p = 0
          } else if ((causal && kpos > qpos) || (window > 0 && kpos <= qpos - window)) {
            x = kNegInfLog2;
          }
        }
        s[i][j] = x;
        mt[i] = fmaxf(mt[i], x);
      }
      // over the 8 lanes of the warp that hold the row
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 4));
      if (C::KW == 2 && (lane & 7) == 0) s_x[(qg + TR * i) * 2 + kw] = mt[i];
    }
    // V is in, every warp is done with K and (KW 2) the set's two warps
    // exchange their maxima
    cp_async_wait<0>();
    __syncthreads();
    if constexpr (!C::P_IN_K) {  // the next tile's K comes during this tile's P V
      if (kt < kt_hi) rows_async<C>(sk, kb, kss, k0 + BK, skv, BK);
      cp_async_commit();
    }
    float* sp = C::P_IN_K ? sk : smem + C::P_OFF;
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = qg + TR * i;
      const float m_new = fmaxf(m[i], C::KW == 2 ? fmaxf(s_x[2 * r], s_x[2 * r + 1]) : mt[i]);
      const float alpha = ex2_ftz(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p = ex2_ftz(s[i][j] - m_new);
        l[i] += p;
        sp[r * C::PS + kg + TK * j] = p;
      }
    }
    set_sync<C>(set);  // the set's P rows are written
    pv_f32<C>(acc, sp, sv, qg, kg);
  }
  cp_async_wait<0>();

  // the row sums: over the 8 lanes, then the set's two warps, in a fixed
  // order (the other warp read the last tile's maxima before the last
  // set_sync)
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 4);
    if (C::KW == 2 && (lane & 7) == 0) s_x[(qg + TR * i) * 2 + kw] = l[i];
  }
  if constexpr (C::KW == 2) set_sync<C>(set);
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = qg + TR * i, qpos = q0 + r;
    if (qpos >= sq) continue;
    const float den = fmaxf(C::KW == 2 ? s_x[2 * r] + s_x[2 * r + 1] : l[i], 1e-30f);
    float* orow = o + b * osb + qpos * oss + h * osh;
#pragma unroll
    for (int mv = 0; mv < C::NV; ++mv) {
      const int col = (kg + TK * mv) * C::VW;
      if constexpr (C::VW == 4) {
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(acc[i][4 * mv] / den, acc[i][4 * mv + 1] / den,
                        acc[i][4 * mv + 2] / den, acc[i][4 * mv + 3] / den);
      } else {
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(acc[i][2 * mv] / den, acc[i][2 * mv + 1] / den);
      }
    }
    // every thread of the row holds its m and summed l: one store a row
    if (lse != nullptr && kw == 0 && (lane & 7) == 0)
      lse[((long long)b * gridDim.x + h) * sq + qpos] = (m[i] + log2f(den)) * kLn2;
  }
}

template <int HD, class C = F32Fwd<HD>>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int b_rows,
               int sq, int skv, int heads, int group, const long long* st, float scale,
               int causal, int window, cudaStream_t stream) {
  const long long n_qt = (sq + C::BQ - 1) / C::BQ;
  if (n_qt > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<HD, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)heads, (unsigned)b_rows, (unsigned)n_qt);
  flash_fwd_kernel<HD, C><<<grid, C::THREADS, C::SMEM, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, sq, skv, group, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], lse,
      scale * kLog2e, causal, window);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ bf16 kernel
constexpr int kWBQ = 128;        // query rows per block: two consumer warpgroups of 64
constexpr int kWBK = 128;        // keys per K/V tile
constexpr int kConsumers = 256;  // two warpgroups
constexpr int kWThreads = kConsumers + 128;  // and the producer's warpgroup
// registers a thread after setmaxnreg: the consumers take what the
// producer's warpgroup gives back (256 x 240 + 128 x 24 = 384 x 168)
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;

template <int HD>
struct WgmmaShape {
  static constexpr int NP = (HD + kPanel - 1) / kPanel;  // panels of a row
  static constexpr int KSTEPS = HD / 16;                 // k16 steps of Q K^T
  static constexpr int Q_PANEL = kWBQ * kRowBytes;
  static constexpr int KV_PANEL = kWBK * kRowBytes;
  static constexpr int Q_BYTES = NP * Q_PANEL;
  static constexpr int KV_BYTES = NP * KV_PANEL;  // one K (or V) tile
  static constexpr int STAGES = 2;  // K/V ring depth
  // byte offsets from the first 1,024-byte boundary of shared memory: Q, the
  // STAGES K tiles, the STAGES V tiles, then the mbarriers (q, full[STAGES],
  // empty[STAGES])
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_BYTES = 8 * (1 + 2 * STAGES);
  // 1 KB of slack to align the swizzled tiles to 1,024 bytes
  static constexpr int SMEM = 1024 + BAR_OFF + BAR_BYTES;
};

// where WgmmaShape<HD>'s tiles and barriers lie in the block's shared memory
template <int HD>
struct WgmmaSmem {
  uint32_t q, k, v, bar_q, bar_full, bar_empty;
  __device__ __forceinline__ explicit WgmmaSmem(const void* raw);
};

template <int HD>
__device__ __forceinline__ WgmmaSmem<HD>::WgmmaSmem(const void* raw) {
  using W = WgmmaShape<HD>;
  q = (smem_addr(raw) + 1023u) & ~1023u;
  k = q + W::K_OFF;
  v = q + W::V_OFF;
  bar_q = q + W::BAR_OFF;
  bar_full = bar_q + 8;
  bar_empty = bar_full + 8 * W::STAGES;
}

// S (64 x 128 keys, f32 accumulator) = Q (64 rows at ``qa``) . K^T (the
// tile at ``kb``), over hd in k16 steps: step kk reads panel kk / 4 at byte
// 32 * (kk % 4) of each swizzled row
template <int HD>
__device__ __forceinline__ void qk_tile(float* s, uint32_t qa, uint32_t kb) {
  using W = WgmmaShape<HD>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < W::KSTEPS; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss_n128(s, sw128_desc(qa + (kk / 4) * W::Q_PANEL + off, 16, 1024),
                  sw128_desc(kb + (kk / 4) * W::KV_PANEL + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs<64>(s);
}

// O (64 x 64 NP, f32) += P (64 x 128 keys, f32 in ``s``, rounded to bf16
// here) . V (the MN-major tile at ``vb``, its panels KV_PANEL bytes apart):
// the k16 step t reads key rows 16t .. 16t+15. The accumulator's fragment
// for keys 16t .. 16t+15 is the A fragment of that step: registers {8t,
// 8t+1}, {8t+2, 8t+3}, {8t+4, 8t+5}, {8t+6, 8t+7} hold (row r, keys c, c+1),
// (r+8, c, c+1), (r, c+8, c+9), (r+8, c+8, c+9) in both layouts, with r =
// lane / 4 and c = 2 * (lane % 4). Every fragment is written before the
// fence and kept until the wait, as wgmma requires.
template <int HD>
__device__ __forceinline__ void pv_tile(float* acc, const float* s, uint32_t vb) {
  using W = WgmmaShape<HD>;
  uint32_t a[kWBK / 16][4];
#pragma unroll
  for (int t = 0; t < kWBK / 16; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[t][i] = pack_bf16(s[8 * t + 2 * i], s[8 * t + 2 * i + 1]);
  fence_regs<kWBK / 4>(&a[0][0]);
  fence_regs<W::NP * 32>(acc);
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < kWBK / 16; ++t)
    wgmma_rs<W::NP * kPanel>(acc, a[t],
                             sw128_desc(vb + t * 16 * kRowBytes, W::KV_PANEL, 1024));
  wgmma_commit();
  wgmma_wait_all();
  fence_regs<kWBK / 4>(&a[0][0]);
  fence_regs<W::NP * 32>(acc);
}

template <int HD>
__global__ void __launch_bounds__(kWThreads, 1)
flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                       int sq, int skv, int group, long long osb, long long oss,
                       long long osh, float* __restrict__ lse, float scale_log2, int causal,
                       int window) {
  using W = WgmmaShape<HD>;
  extern __shared__ uint8_t smem_raw[];
  const WgmmaSmem<HD> sm(smem_raw);
  const uint32_t s_q = sm.q, s_k = sm.k, s_v = sm.v;
  const uint32_t bar_q = sm.bar_q, bar_full = sm.bar_full, bar_empty = sm.bar_empty;

  const int h = blockIdx.x, b = blockIdx.y, kh = h / group;
  const int q0 = ((int)gridDim.z - 1 - (int)blockIdx.z) * kWBQ;  // longest band first
  // the band of KV tiles some query of this block can see
  const int q_last = min(q0 + kWBQ, sq) - 1;
  int kt_hi = (skv - 1) / kWBK;
  if (causal) kt_hi = min(kt_hi, q_last / kWBK);
  int kt_lo = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;  // the lowest key any row can see
    kt_lo = lo > 0 ? lo / kWBK : 0;
  }
  const int n_kt = kt_hi - kt_lo + 1;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < W::STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer: one lane of its first warp issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid == kConsumers) {
      mbar_expect_tx(bar_q, W::Q_BYTES);
      for (int p = 0; p < W::NP; ++p)
        tma_load_4d(s_q + p * W::Q_PANEL, &tq, bar_q, p * kPanel, h, q0, b);
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % W::STAGES;
        mbar_wait(bar_empty + 8 * s, ((i / W::STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * W::KV_BYTES);
        const int k0 = (kt_lo + i) * kWBK;
        for (int p = 0; p < W::NP; ++p) {
          tma_load_4d(s_k + s * W::KV_BYTES + p * W::KV_PANEL, &tk, bar_full + 8 * s,
                      p * kPanel, kh, k0, b);
          tma_load_4d(s_v + s * W::KV_BYTES + p * W::KV_PANEL, &tv, bar_full + 8 * s,
                      p * kPanel, kh, k0, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: 64 query rows; this thread holds rows r0 and r0 + 8
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = q0 + 64 * wg + 16 * warp + lane / 4;
  const int c0 = 2 * (lane % 4);
  const int wg_lo = q0 + 64 * wg, wg_hi = wg_lo + 63;  // the warpgroup's rows

  float acc[W::NP * 32];  // column 8j + c0 + (i & 1) of rows r0, r0 + 8 in acc[4j + i]
#pragma unroll
  for (int i = 0; i < W::NP * 32; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const uint32_t qa = s_q + wg * 64 * kRowBytes;

  mbar_wait(bar_q, 0);
  for (int i = 0; i < n_kt; ++i) {
    const int s = i % W::STAGES;
    const int k0 = (kt_lo + i) * kWBK;
    mbar_wait(bar_full + 8 * s, (i / W::STAGES) & 1);
    float sc[64];
    qk_tile<HD>(sc, qa, s_k + s * W::KV_BYTES);

    // the mask, on tiles that straddle the diagonal, the window's edge or Skv
    const bool edge = (causal && k0 + kWBK - 1 > wg_lo) ||
                      (window > 0 && k0 <= wg_hi - window) || k0 + kWBK > skv;
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e] * scale_log2;
        if (edge) {
          const int kpos = k0 + 8 * j + c0 + (e & 1);
          const int qpos = r0 + 8 * (e >> 1);
          if (kpos >= skv) {
            x = -INFINITY;  // not a key: p = 0
          } else if ((causal && kpos > qpos) || (window > 0 && kpos <= qpos - window)) {
            x = kNegInf;
          }
        }
        sc[4 * j + e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m[r], mt[r]);
      const float alpha = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int j = 0; j < W::NP * 8; ++j) {
        acc[4 * j + 2 * r] *= alpha;
        acc[4 * j + 2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[4 * j + e] - m[e >> 1]);
        l[e >> 1] += p;
        sc[4 * j + e] = p;
      }
    pv_tile<HD>(acc, sc, s_v + s * W::KV_BYTES);
    mbar_arrive(bar_empty + 8 * s);  // this thread is done with the stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = r0 + 8 * r;
    if (qpos >= sq) continue;
    __nv_bfloat16* orow = o + b * osb + qpos * oss + h * osh;
#pragma unroll
    for (int j = 0; j < W::NP * 8; ++j) {
      const int col = 8 * j + c0;
      if (col < HD)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            acc[4 * j + 2 * r] / l[r], acc[4 * j + 2 * r + 1] / l[r]);
    }
    // the quad holds the row's m (log2 units) and summed l: one store a row
    if (lse != nullptr && (lane & 3) == 0)
      lse[((long long)b * gridDim.x + h) * sq + qpos] =
          (m[r] + log2f(l[r])) * 0.6931471805599453f;
  }
}

// One S tile and one PV step, the kernel's own building blocks, for the
// tests: q (64, 64), k and v (128, 64) contiguous bf16 -> s (64, 128) =
// q k^T and o (64, 64) = bf16(s) v, both f32 and contiguous. Shared memory
// is laid out as flash_fwd_kernel_wgmma<64>'s (WgmmaSmem): q fills the first
// consumer warpgroup's 64 rows of Q, k and v stage 0 of the ring.
__global__ void __launch_bounds__(128)
flash_wgmma_probe_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, float* s_out, float* o_out) {
  using W = WgmmaShape<64>;
  extern __shared__ uint8_t smem_raw[];
  const WgmmaSmem<64> sm(smem_raw);
  const uint32_t s_q = sm.q, s_k = sm.k, s_v = sm.v, bar = sm.bar_q;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 64 * kRowBytes + 2 * W::KV_BYTES);
    tma_load_4d(s_q, &tq, bar, 0, 0, 0, 0);
    tma_load_4d(s_k, &tk, bar, 0, 0, 0, 0);
    tma_load_4d(s_v, &tv, bar, 0, 0, 0, 0);
  }
  mbar_wait(bar, 0);
  float sc[64], acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  qk_tile<64>(sc, s_q, s_k);
  const int warp = tid / 32, lane = tid % 32;
  const int r = 16 * warp + lane / 4, c = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s_out[(r + 8 * (e >> 1)) * 128 + 8 * j + c + (e & 1)] = sc[4 * j + e];
  pv_tile<64>(acc, sc, s_v);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o_out[(r + 8 * (e >> 1)) * 64 + 8 * j + c + (e & 1)] = acc[4 * j + e];
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int b_rows,
                int sq, int skv, int heads, int kv_heads, const long long* st, float scale,
                int causal, int window, cudaStream_t stream) {
  using W = WgmmaShape<HD>;
  const long long n_qt = (sq + kWBQ - 1) / kWBQ;
  if (n_qt > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, HD, heads, sq, b_rows, st[0], st[1], st[2], kWBQ);
  if (!err) err = encode(&tk, k, HD, kv_heads, skv, b_rows, st[3], st[4], st[5], kWBK);
  if (!err) err = encode(&tv, v, HD, kv_heads, skv, b_rows, st[6], st[7], st[8], kWBK);
  if (err) return err;
  cudaError_t cerr = cudaFuncSetAttribute(flash_fwd_kernel_wgmma<HD>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, W::SMEM);
  if (cerr != cudaSuccess) return (int)cerr;
  const dim3 grid((unsigned)heads, (unsigned)b_rows, (unsigned)n_qt);
  flash_fwd_kernel_wgmma<HD><<<grid, kWThreads, W::SMEM, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, sq, skv, heads / kv_heads, st[9], st[10], st[11], lse,
      scale * 1.4426950408889634f, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, hd), k and v (B, Skv, K, hd), o (B, Sq, H, hd), all of one
// dtype (0: f32, 1: bf16), innermost stride 1; strides in elements for the
// (batch, sequence, head) axes of q, k, v and o (bf16: multiples of 8, with
// 16-byte aligned bases, for TMA; f32: multiples of 4, with 16-byte aligned
// bases, for the tile copies and o's 16-byte stores). lse, when not null, is
// a contiguous (B, H, Sq) f32 output. window <= 0 means none. Returns
// cudaGetLastError() after the launch.
extern "C" int g4r_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                  float* lse, int dtype, int b_rows, int sq, int skv, int heads,
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
  if (dtype == 0) {
    switch (hd) {
      case 32: return launch_f32<32>(q, k, v, o, lse, b_rows, sq, skv, heads, group, st, scale,
                                     causal, window, s);
      case 64: return launch_f32<64>(q, k, v, o, lse, b_rows, sq, skv, heads, group, st, scale,
                                     causal, window, s);
      case 128: return launch_f32<128>(q, k, v, o, lse, b_rows, sq, skv, heads, group, st, scale,
                                       causal, window, s);
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 32: return launch_bf16<32>(q, k, v, o, lse, b_rows, sq, skv, heads, kv_heads, st,
                                      scale, causal, window, s);
      case 64: return launch_bf16<64>(q, k, v, o, lse, b_rows, sq, skv, heads, kv_heads, st,
                                      scale, causal, window, s);
      case 128: return launch_bf16<128>(q, k, v, o, lse, b_rows, sq, skv, heads, kv_heads, st,
                                        scale, causal, window, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// The building blocks of the bf16 kernel on one tile (flash_wgmma_probe_kernel).
extern "C" int g4r_flash_wgmma_probe(const void* q, const void* k, const void* v, float* s_out,
                                     float* o_out, void* stream) {
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, 64, 1, 64, 1, 64 * 64, 64, 64, 64);
  if (!err) err = encode(&tk, k, 64, 1, 128, 1, 128 * 64, 64, 64, kWBK);
  if (!err) err = encode(&tv, v, 64, 1, 128, 1, 128 * 64, 64, 64, kWBK);
  if (err) return err;
  constexpr int smem = WgmmaShape<64>::SMEM;
  cudaError_t cerr = cudaFuncSetAttribute(flash_wgmma_probe_kernel,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return (int)cerr;
  flash_wgmma_probe_kernel<<<1, 128, smem, (cudaStream_t)stream>>>(tq, tk, tv, s_out, o_out);
  return (int)cudaGetLastError();
}

namespace {

int fill_attrs(const void* fn, int smem, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = smem;
  return 0;
}

// the instantiation for (dtype, hd) with the shared memory its launcher asks for
template <int HD>
int attrs_of(int dtype, int* out) {
  if (dtype == 0) return fill_attrs((const void*)flash_fwd_kernel<HD>, F32Fwd<HD>::SMEM, out);
  if (dtype == 1)
    return fill_attrs((const void*)flash_fwd_kernel_wgmma<HD>, WgmmaShape<HD>::SMEM, out);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Registers, local memory (spills and stack) and dynamic shared memory of
// the flash kernel for (dtype, hd): out[0..2]. Returns a cudaError_t.
extern "C" int g4r_flash_attn_attrs(int dtype, int hd, int* out) {
  switch (hd) {
    case 32: return attrs_of<32>(dtype, out);
    case 64: return attrs_of<64>(dtype, out);
    case 128: return attrs_of<128>(dtype, out);
  }
  return (int)cudaErrorInvalidValue;
}
