// The backward of causal / sliding-window GQA flash attention, for Hopper
// (sm_90a): bf16 on the tensor cores (wgmma), f32 on the CUDA cores.
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
// FA2's split in three kernels a call (two where neither G nor the plan's
// splits exceed 1), each output element written by one thread and summed in
// a fixed order, so two runs are bitwise equal (no atomics; conformance
// runs under torch.use_deterministic_algorithms):
//   - flash_bwd_dot_kernel: D, one warp a (b, h, i) row, lanes over hd, then
//     a shuffle tree; it also copies lse (times log2 e for bf16) into rows
//     padded to a multiple of 128, zeros past Sq, so that the tile kernels
//     read a tile's lse and D as one aligned copy with no bounds check.
//   - the tile kernel (flash_bwd_tiles_*), dK/dV and dQ blocks in one
//     launch (dkdv_block): where B H tiles is under the card's block slots,
//     as at qwen2-0.5b's G 7 on one batch row of 512 tokens (112 tiles of
//     each kind for 132 SMs), the two kinds run side by side, and elsewhere
//     the dQ blocks fill the dK/dV blocks' last wave.
//     - dK/dV: a (key tile, query head, batch row), looping over the query
//       tiles of the band (tiles that see none of its keys are skipped:
//       causal from the diagonal on, a window up to k_last + window - 1).
//       A query head, not a KV head, balances the grid: a KV head's block
//       did G times the work, 3 to 96 query tiles at the training call (B
//       4, S 2,048, H 9, K 3), and its heaviest block alone took 1.33x an
//       even split. Key tiles are issued longest band first (their rank
//       counts along Skv, whose first tiles see the most queries under the
//       causal mask).
//     - dQ: a (query tile, query head, batch row), looping over the KV
//       tiles of the band as the forward does, longest band first.
//     - A grid too small for the card (plan_of) gives each tile ``splits``
//       blocks, split c taking tiles c, c + splits, ... of the band.
//   - flash_bwd_sum_kernel, where G splits > 1: the tile blocks write f32
//     partials (dK and dV a (query head, split), 2 x (G splits, B, Skv, K,
//     hd); dQ a split, (splits, B, Sq, H, hd)), and it adds each element's
//     partials in order and writes dK, dV and dQ (at the training call, G
//     3 and no split: 38 MB read once). Else the tile blocks write them.
// S and dP are computed in both tile kernels: 14 hd FLOP a (query, key)
// pair against the 10 hd the math needs, the price of a dQ with no atomics.
// Only tiles that straddle the diagonal, the window's edge, Sq or Skv
// evaluate the mask. Any Sq and Skv, hd 32, 64 and 128.
//
// What bounds it on this card: operations. At the model's shapes a pair costs
// 10 hd FLOP against a few bytes read per key row, far above either dtype's
// FLOP/byte balance.
//
// bf16: flash_bwd_tiles_wgmma (dkdv_wgmma and dq_wgmma), on the tensor cores
// (bound: the band's FLOP over 989 TFLOP/s), built from the forward's parts
// (hopper.cuh): tiles by TMA into 128-byte-swizzled panels, a producer
// warpgroup keeping a two-stage mbarrier ring full while two consumer
// warpgroups multiply, setmaxnreg giving the consumers 240 registers.
//   - dK/dV: a block owns 128 keys (64 a consumer warpgroup) of one query
//     head. K and V come once; each 64-query tile brings Q, dO and the
//     tile's lse and D (two bulk copies). S^T = K Q^T and dP^T = V dO^T are
//     shared-shared wgmmas (K, Q, V, dO all K-major in their (row, hd)
//     layout). P^T = exp2(S^T scale log2 e - lse log2 e) and dS^T = P^T o
//     (dP^T - D) are computed on the f32 accumulators, rounded to bf16 in
//     place and fed as the register A operand of dV += P^T dO and dK += dS^T
//     Q (dS^T as two bf16 parts, below), with dO and Q MN-major there (the
//     descriptor's transpose bit, as the forward's PV takes V): no
//     shared-memory round trip for P or dS.
//   - dQ: a block owns 128 query rows (64 a warpgroup); Q and dO come once,
//     64-key K/V tiles through the ring. S = Q K^T and dP = dO V^T shared-
//     shared, dS split in registers and fed to dQ += dS K, K MN-major.
//   - A warpgroup whose 64 keys (or rows) see none of a tile skips its
//     products for it. Registers: at hd 128 a dK/dV thread holds 128 f32 of
//     dK and dV and 64 of S^T and dP^T; chip_smoke.py fails on a spill.
//   - P is rounded to bf16 before its product (the plain version keeps it
//     f32); dS goes in as hi = bf16(dS) and lo = bf16(dS - hi), two products
//     into one accumulator, about 16 bits of it. A row of dQ sums dS K over
//     keys where sum_j dS_ij = 0: keys that share a large common part (as
//     Whisper's decoder's do, each position carrying much the same
//     cross-attention output) cancel it exactly, and dS rounded once to 8
//     bits left that part in at 2^-9 of each term, up to 3.9x chip_smoke.py's
//     row-scaled bound on such rows; dK's rows likewise. The split costs a
//     third product a tile in either kernel; in the dK/dV one the low part
//     waits in shared memory (16 KB a block) while dV's and the high part's
//     products run, since at hd 128 all three fragment sets beside the 128
//     accumulators spilled. tests/test_torch_flash.py and
//     chip_smoke.py emulate this arithmetic (bwd_kernel_emulation).
//
// f32: flash_bwd_tiles_f32 (dkdv_f32 and dq_f32), on the CUDA cores (bound:
// the band's FLOP over 67 TFLOP/s), f32 FMAs only (no TF32: the f32 contract,
// 1e-4 against the plain version). 256 threads, 64 x 64 tiles. What held
// the first version back was shared memory: one 4-byte load for every 2
// FMAs, and an SM's shared memory delivers 32 lanes x 4 bytes a clock
// against four warp FMA instructions, so FMA issue stalled near half its
// peak. Here every operand is a 16-byte load (float4 along hd for S and dP,
// along the key or column axis for the products), and a warp's threads are
// laid out 4 x 8 over the tile so that each load touches 4 or 8 distinct
// rows: one shared-memory wavefront for 8 (S, dP) or 16 (products) FMAs a
// thread. Rows are padded to hd + 4 floats (16-byte aligned, 8 consecutive
// rows on 8 distinct 4-bank groups: conflict-free), the P^T / dS^T / dS
// tiles to 68. Tiles come by cp.async, 16 bytes a copy (the wrapper copies
// an f32 operand whose base or strides are off 16 bytes). With one block
// an SM the kernels stalled on latency more than on any unit: at hd <= 64
// two blocks an SM (128 registers a thread) ran faster on an H100 than one
// block with the next tile copied into a second buffer during the
// products, so the second buffer is kept only where two blocks' shared
// memory still fits (F32Tiles: hd 32; at hd 128, one block an SM, for dQ).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kTile = 64;       // f32 tiles: query and key rows
constexpr int kThreads = 256;   // f32 tile kernels, the D and sum passes
constexpr int kRowPad = 128;    // lse and D rows padded to a multiple of this
constexpr int kPS = kTile + 4;  // row stride (floats) of the P^T, dS^T and dS tiles
constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;  // (B, H, Sq)
  float* lse_pad;    // (B, H, sq_pad): lse (bf16: times log2 e), 0 past Sq
  float* dd;         // (B, H, sq_pad): D, 0 past Sq
  // where G splits > 1: partial dK, dV of each (query head, split), 2 x (G
  // splits, B, Skv, K, hd) f32
  float* part;
  float* qpart;        // splits > 1: partial dQ of each split, (splits, B, Sq, H, hd) f32
  void *dq, *dk, *dv;  // contiguous (B, Sq, H, hd), (B, Skv, K, hd), (B, Skv, K, hd)
  int b_rows, sq, sq_pad, skv, heads, kv_heads, group;
  // blocks a (tile, query head, batch row), each taking every splits-th
  // tile of the band
  int splits;
  // (batch, seq, head) strides in elements of q, k, v, o and dO
  long long qs[3], ks[3], vs[3], os[3], ds[3];
  float scale;
  int causal, window;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ bool visible(const BwdArgs& a, int qpos, int kpos) {
  return qpos < a.sq && kpos < a.skv && !(a.causal && kpos > qpos) &&
         !(a.window > 0 && kpos <= qpos - a.window);
}

// where a block's partial (or final) dK and dV row starts: element (b, kpos,
// kh, 0) of (B, Skv, K, hd)
__device__ __forceinline__ long long kv_row(const BwdArgs& a, int b, int kpos, int kh, int hd) {
  return (((long long)b * a.skv + kpos) * a.kv_heads + kh) * hd;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dot_kernel(BwdArgs a, long long rows) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;  // the whole warp: one row a warp
  const int lane = threadIdx.x & 31;
  const int i = (int)(row % a.sq_pad);
  const long long bh = row / a.sq_pad;
  float acc = 0.f;
  if (i < a.sq) {
    const int h = (int)(bh % a.heads), b = (int)(bh / a.heads);
    const T* orow = (const T*)a.o + b * a.os[0] + i * a.os[1] + h * a.os[2];
    const T* drow = (const T*)a.dout + b * a.ds[0] + i * a.ds[1] + h * a.ds[2];
#pragma unroll
    for (int d = lane; d < HD; d += 32) acc = fmaf(to_f(drow[d]), to_f(orow[d]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) {
    constexpr float unit = sizeof(T) == 2 ? kLog2e : 1.f;  // bf16 kernels work in log2 units
    a.dd[row] = acc;
    a.lse_pad[row] = i < a.sq ? a.lse[bh * a.sq + i] * unit : 0.f;
  }
}

// dK and dV from their G splits partials (where G splits > 1) and dQ from
// its splits partials (where splits > 1), each element summed in f32 in
// order (query head g, then split c: slot g splits + c), written in the
// inputs' dtype; four elements a thread. n_kv and n_q: elements of dK and
// of dQ.
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_sum_kernel(BwdArgs a, long long n_kv,
                                                                 long long n_q) {
  const int pk = a.group * a.splits;
  const long long k4 = pk > 1 ? n_kv / 4 : 0, q4 = a.splits > 1 ? n_q / 4 : 0;
  const float4* p = reinterpret_cast<const float4*>(a.part);
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < k4;
       i += (long long)gridDim.x * kThreads) {
    float4 sk = p[i], sv = p[pk * k4 + i];
    for (int t = 1; t < pk; ++t) {
      const float4 x = p[t * k4 + i], y = p[(pk + t) * k4 + i];
      sk.x += x.x; sk.y += x.y; sk.z += x.z; sk.w += x.w;
      sv.x += y.x; sv.y += y.y; sv.z += y.z; sv.w += y.w;
    }
    const float kf[4] = {sk.x, sk.y, sk.z, sk.w}, vf[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (sizeof(T) == 2) {
        ((__nv_bfloat16*)a.dk)[4 * i + e] = __float2bfloat16_rn(kf[e] * a.scale);
        ((__nv_bfloat16*)a.dv)[4 * i + e] = __float2bfloat16_rn(vf[e]);
      } else {
        ((float*)a.dk)[4 * i + e] = kf[e] * a.scale;
        ((float*)a.dv)[4 * i + e] = vf[e];
      }
    }
  }
  const float4* pq = reinterpret_cast<const float4*>(a.qpart);
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < q4;
       i += (long long)gridDim.x * kThreads) {
    float4 sq = pq[i];
    for (int t = 1; t < a.splits; ++t) {
      const float4 x = pq[t * q4 + i];
      sq.x += x.x; sq.y += x.y; sq.z += x.z; sq.w += x.w;
    }
    const float qf[4] = {sq.x, sq.y, sq.z, sq.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (sizeof(T) == 2) {
        ((__nv_bfloat16*)a.dq)[4 * i + e] = __float2bfloat16_rn(qf[e] * a.scale);
      } else {
        ((float*)a.dq)[4 * i + e] = qf[e] * a.scale;
      }
    }
  }
}

// ------------------------------------------------------------- f32 kernels
// a split's share of a band of n tiles: split c of ``splits`` takes tiles
// c, c + splits, ... of it
__device__ __forceinline__ int split_tiles(int n, int c, int splits) {
  return n > c ? (n - c + splits - 1) / splits : 0;
}

// this block's split (dkdv_block), from blockIdx.z read afresh by an asm
// volatile, which the compiler neither merges with another read nor keeps
// live: a tile loop holds no register for it (the f32 tile kernel at hd 64
// uses all of its 128)
__device__ __forceinline__ int split_of(const BwdArgs& a) {
  unsigned z;
  asm volatile("mov.u32 %0, %%ctaid.z;" : "=r"(z));
  return (int)(z % (unsigned)a.splits);
}

// ``blocks`` blocks of ``floats`` floats of shared memory fit an SM (228 KB,
// 1 KB of it reserved a block)
constexpr bool fits_sm(int blocks, int floats) { return blocks * (4 * floats + 1024) <= 233472; }

template <int HD>
struct F32Tiles {
  static constexpr int RS = HD + 4;   // row stride (floats) of the Q, dO, K and V tiles
  static constexpr int TILE = kTile * RS;
  static constexpr int VW = HD >= 64 ? 4 : 2;  // columns of one vector in the products
  static constexpr int NV = HD / 16 / VW;      // vectors of columns a thread
  static constexpr int CPT = HD / 16;          // columns a thread
  // Blocks an SM: two where their registers fit (128 a thread, hd <= 64),
  // since the kernels stall on latency more than on any unit; a second
  // buffer for the next tile where the blocks' shared memory still fits
  // (each block also holds 1 KB of the SM's 228 KB), else one. So hd 32
  // runs two blocks of two stages, hd 64 two blocks of one (the second
  // block's loads overlap the first's products), hd 128 one block, dQ's of
  // two stages and dK/dV's of one (two would take 233 KB).
  static constexpr int MIN_BLOCKS = HD <= 64 ? 2 : 1;
  // dK/dV: K, V; DKDV_STAGES x (Q, dO, lse, D); P^T, dS^T
  static constexpr int DKDV_STAGE = 2 * TILE + 2 * kTile;
  static constexpr int DKDV_STAGES =
      fits_sm(MIN_BLOCKS, 2 * TILE + 2 * DKDV_STAGE + 2 * kTile * kPS) ? 2 : 1;
  static constexpr int DKDV_BYTES = 4 * (2 * TILE + DKDV_STAGES * DKDV_STAGE + 2 * kTile * kPS);
  // dQ: Q, dO; DQ_STAGES x (K, V); dS
  static constexpr int DQ_STAGES = fits_sm(MIN_BLOCKS, 2 * TILE + 4 * TILE + kTile * kPS) ? 2 : 1;
  static constexpr int DQ_BYTES = 4 * (2 * TILE + DQ_STAGES * 2 * TILE + kTile * kPS);
};

// rows r0 .. r0 + 63 of one head (``base`` at its row 0, rows ``rs`` floats
// apart) into a tile of rows padded to HD + 4 by 16-byte cp.async copies
// (the wrapper hands over f32 operands whose base and strides are 16-byte
// multiples), rows at or past n zeros
template <int HD>
__device__ __forceinline__ void tile_async(float* dst, const float* base, long long rs, int r0,
                                           int n) {
  constexpr int RS = F32Tiles<HD>::RS;
  for (int i = threadIdx.x; i < kTile * HD / 4; i += kThreads) {
    const int r = i / (HD / 4), d = 4 * (i - r * (HD / 4));
    const bool in = r0 + r < n;
    cp_async16(smem_addr(dst + r * RS + d), in ? base + (long long)(r0 + r) * rs + d : base, in);
  }
}

// ``NV`` vectors of VW floats of row ``row`` at columns (c + 16 m) VW, m < NV
template <int HD>
__device__ __forceinline__ void load_cols(float* out, const float* row, int c) {
  using F = F32Tiles<HD>;
#pragma unroll
  for (int m = 0; m < F::NV; ++m) {
    if constexpr (F::VW == 4) {
      const float4 x = *reinterpret_cast<const float4*>(row + (c + 16 * m) * 4);
      out[4 * m] = x.x; out[4 * m + 1] = x.y; out[4 * m + 2] = x.z; out[4 * m + 3] = x.w;
    } else {
      const float2 x = *reinterpret_cast<const float2*>(row + (c + 16 * m) * 2);
      out[2 * m] = x.x; out[2 * m + 1] = x.y;
    }
  }
}

template <int HD>
__device__ __forceinline__ int col_of(int c, int j) {  // the thread's column j of CPT
  using F = F32Tiles<HD>;
  return (c + 16 * (j / F::VW)) * F::VW + j % F::VW;
}

// acc[i][j] += a_i . b_j over hd for the 4 rows ``ra`` + 16 i of ``ta`` and
// the 4 rows ``rb`` + 16 j of ``tb`` (tiles of stride RS), 4 columns a load
template <int HD>
__device__ __forceinline__ void dot_tiles(float (&acc)[4][4], const float* ta, int ra,
                                          const float* tb, int rb) {
  constexpr int RS = F32Tiles<HD>::RS;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = *reinterpret_cast<const float4*>(ta + (ra + 16 * i) * RS + d);
      y[i] = *reinterpret_cast<const float4*>(tb + (rb + 16 * i) * RS + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}

// a dK/dV block: keys k0 .. k0 + 63 of query head blockIdx.x
template <int HD>
__device__ __forceinline__ void dkdv_f32(const BwdArgs& a, float* smem, int k0) {
  using F = F32Tiles<HD>;
  constexpr int RS = F::RS, ST = F::DKDV_STAGES, CPT = F::CPT;
  float* sk = smem;
  float* sv = sk + F::TILE;
  float* stages = sv + F::TILE;  // stage s: Q, dO, lse, D at stages + s * DKDV_STAGE
  float* sp = stages + ST * F::DKDV_STAGE;  // P^T as (query, key)
  float* sds = sp + kTile * kPS;            // dS^T as (query, key)

  const int h = blockIdx.x, b = blockIdx.y;
  const int kh = h / a.group, g = h - kh * a.group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // S^T and dP^T: keys kg + 16 i, queries qg + 16 j (a warp: 4 x 8 of them);
  // dK and dV: keys 4 kg + i, columns col_of(qg, c)
  const int kg = (warp >> 1) * 4 + (lane >> 3), qg = (warp & 1) * 8 + (lane & 7);

  // the query tiles some row of which sees a key of this tile
  int qt_lo = 0, qt_hi = (a.sq - 1) / kTile;
  if (a.causal) qt_lo = k0 / kTile;
  if (a.window > 0)  // the last query that sees the tile's last key
    qt_hi = (int)min((long long)qt_hi,
                     ((long long)min(k0 + kTile, a.skv) - 2 + a.window) / kTile);
  // this split's query tiles: qt0, qt0 + splits, ... to qt_hi (a loop over
  // the tile index with the constant-bank stride holds one register less
  // than a counter; this kernel at hd 64 uses all of its 128)
  const int qt0 = qt_lo + split_of(a);

  const float* qb = (const float*)a.q + b * a.qs[0] + h * a.qs[2];
  const float* db = (const float*)a.dout + b * a.ds[0] + h * a.ds[2];
  const long long rows = ((long long)b * a.heads + h) * a.sq_pad;
  auto load_stage = [&](int qt, int stage) {
    float* st = stages + stage * F::DKDV_STAGE;
    const int q0 = qt * kTile;
    tile_async<HD>(st, qb, a.qs[1], q0, a.sq);
    tile_async<HD>(st + F::TILE, db, a.ds[1], q0, a.sq);
    if (tid < 2 * kTile)  // lse then D: rows padded past Sq, no bound to check
      cp_async4(smem_addr(st + 2 * F::TILE + tid),
                (tid < kTile ? a.lse_pad : a.dd) + rows + q0 + (tid & (kTile - 1)), true);
  };
  tile_async<HD>(sk, (const float*)a.k + b * a.ks[0] + kh * a.ks[2], a.ks[1], k0, a.skv);
  tile_async<HD>(sv, (const float*)a.v + b * a.vs[0] + kh * a.vs[2], a.vs[1], k0, a.skv);
  if (ST == 2 && qt0 <= qt_hi) load_stage(qt0, 0);
  cp_async_commit();

  float dk[4][CPT], dv[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int qt = qt0, it = 0; qt <= qt_hi; qt += a.splits, ++it) {
    __syncthreads();  // every read of the stage the next copy overwrites is done
    if (ST == 1) {
      load_stage(qt, 0);
    } else if (qt + a.splits <= qt_hi) {
      load_stage(qt + a.splits, (it + 1) % ST);
    }
    cp_async_commit();
    if (ST == 2) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sqt = stages + (it % ST) * F::DKDV_STAGE;
    const float* sdo = sqt + F::TILE;
    const float* slse = sdo + F::TILE;
    const float* sdd = slse + kTile;
    const int q0 = qt * kTile;

    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
    dot_tiles<HD>(st, sk, kg, sqt, qg);
    dot_tiles<HD>(dpt, sv, kg, sdo, qg);
    const bool edge = (a.causal && k0 + kTile - 1 > q0) ||
                      (a.window > 0 && k0 <= q0 + kTile - 1 - a.window) ||
                      q0 + kTile > a.sq || k0 + kTile > a.skv;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = qg + 16 * j, c = kg + 16 * i;
        float p = expf(st[i][j] * a.scale - slse[r]);
        if (edge && !visible(a, q0 + r, k0 + c)) p = 0.f;
        sp[r * kPS + c] = p;
        sds[r * kPS + c] = p * (dpt[i][j] - sdd[r]);
      }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q over the tile's 64 queries, in order
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      const float4 p4 = *reinterpret_cast<const float4*>(sp + r * kPS + 4 * kg);
      const float4 s4 = *reinterpret_cast<const float4*>(sds + r * kPS + 4 * kg);
      const float pr[4] = {p4.x, p4.y, p4.z, p4.w}, sr[4] = {s4.x, s4.y, s4.z, s4.w};
      float dor[CPT], qr[CPT];
      load_cols<HD>(dor, sdo + r * RS, qg);
      load_cols<HD>(qr, sqt + r * RS, qg);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          dv[i][c] = fmaf(pr[i], dor[c], dv[i][c]);
          dk[i][c] = fmaf(sr[i], qr[c], dk[i][c]);
        }
    }
  }
  cp_async_wait<0>();

  // G splits > 1: this block's partials go to slot g splits + split of pk
  const long long n = (long long)a.b_rows * a.skv * a.kv_heads * HD;
  const int pk = a.group * a.splits, slot = g * a.splits + split_of(a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + 4 * kg + i;
    if (kpos >= a.skv) continue;
    const long long at = kv_row(a, b, kpos, kh, HD);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = col_of<HD>(qg, c);
      if (pk == 1) {
        ((float*)a.dk)[at + col] = dk[i][c] * a.scale;
        ((float*)a.dv)[at + col] = dv[i][c];
      } else {
        a.part[slot * n + at + col] = dk[i][c];
        a.part[(pk + slot) * n + at + col] = dv[i][c];
      }
    }
  }
}

// a dQ block: query rows q0 .. q0 + 63 of query head blockIdx.x
template <int HD>
__device__ __forceinline__ void dq_f32(const BwdArgs& a, float* smem, int q0) {
  using F = F32Tiles<HD>;
  constexpr int RS = F::RS, ST = F::DQ_STAGES, CPT = F::CPT;
  float* sqt = smem;
  float* sdo = sqt + F::TILE;
  float* stages = sdo + F::TILE;  // stage s: K, V at stages + 2 s TILE
  float* sds = stages + ST * 2 * F::TILE;  // dS as (key, query)

  const int h = blockIdx.x, b = blockIdx.y;
  const int kh = h / a.group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // S and dP: queries qg + 16 i, keys kg + 16 j (a warp: 4 x 8 of them);
  // dQ: queries 4 qg + i, columns col_of(kg, c)
  const int qg = (warp >> 1) * 4 + (lane >> 3), kg = (warp & 1) * 8 + (lane & 7);

  const long long rows = ((long long)b * a.heads + h) * a.sq_pad + q0;
  float lse[4], dd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse[i] = a.lse_pad[rows + qg + 16 * i];
    dd[i] = a.dd[rows + qg + 16 * i];
  }

  // the band of KV tiles some query of this tile can see (as the forward)
  const int q_last = min(q0 + kTile, a.sq) - 1;
  int kt_hi = (a.skv - 1) / kTile;
  if (a.causal) kt_hi = min(kt_hi, q_last / kTile);
  int kt_lo = 0;
  if (a.window > 0) {
    const int lo = q0 - a.window + 1;
    kt_lo = lo > 0 ? lo / kTile : 0;
  }
  // this split's KV tiles: kt0, kt0 + splits, ... to kt_hi (as dkdv_f32)
  const int kt0 = kt_lo + split_of(a);

  const float* kb = (const float*)a.k + b * a.ks[0] + kh * a.ks[2];
  const float* vb = (const float*)a.v + b * a.vs[0] + kh * a.vs[2];
  auto load_stage = [&](int kt, int stage) {
    float* st = stages + stage * 2 * F::TILE;
    const int k0 = kt * kTile;
    tile_async<HD>(st, kb, a.ks[1], k0, a.skv);
    tile_async<HD>(st + F::TILE, vb, a.vs[1], k0, a.skv);
  };
  tile_async<HD>(sqt, (const float*)a.q + b * a.qs[0] + h * a.qs[2], a.qs[1], q0, a.sq);
  tile_async<HD>(sdo, (const float*)a.dout + b * a.ds[0] + h * a.ds[2], a.ds[1], q0, a.sq);
  if (ST == 2 && kt0 <= kt_hi) load_stage(kt0, 0);
  cp_async_commit();

  float dq[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dq[i][c] = 0.f;

  for (int kt = kt0, it = 0; kt <= kt_hi; kt += a.splits, ++it) {
    __syncthreads();  // every read of the stage the next copy overwrites is done
    if (ST == 1) {
      load_stage(kt, 0);
    } else if (kt + a.splits <= kt_hi) {
      load_stage(kt + a.splits, (it + 1) % ST);
    }
    cp_async_commit();
    if (ST == 2) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sk = stages + (it % ST) * 2 * F::TILE;
    const float* sv = sk + F::TILE;
    const int k0 = kt * kTile;

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    dot_tiles<HD>(s, sqt, qg, sk, kg);
    dot_tiles<HD>(dp, sdo, qg, sv, kg);
    const bool edge = (a.causal && k0 + kTile - 1 > q0) ||
                      (a.window > 0 && k0 <= q0 + kTile - 1 - a.window) ||
                      k0 + kTile > a.skv || q0 + kTile > a.sq;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = qg + 16 * i, c = kg + 16 * j;
        float p = expf(s[i][j] * a.scale - lse[i]);
        if (edge && !visible(a, q0 + r, k0 + c)) p = 0.f;
        sds[c * kPS + r] = p * (dp[i][j] - dd[i]);
      }
    __syncthreads();

    // dQ += dS K over the tile's 64 keys, in order
#pragma unroll 4
    for (int c0 = 0; c0 < kTile; ++c0) {
      const float4 s4 = *reinterpret_cast<const float4*>(sds + c0 * kPS + 4 * qg);
      const float sr[4] = {s4.x, s4.y, s4.z, s4.w};
      float kr[CPT];
      load_cols<HD>(kr, sk + c0 * RS, kg);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) dq[i][c] = fmaf(sr[i], kr[c], dq[i][c]);
    }
  }
  cp_async_wait<0>();

  // splits > 1: this block's partial goes to its split's part of qpart
  float* out = a.splits == 1 ? (float*)a.dq
                             : a.qpart + split_of(a) * ((long long)a.b_rows * a.sq * a.heads * HD);
  const float mul = a.splits == 1 ? a.scale : 1.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * qg + i;
    if (qpos >= a.sq) continue;
    const long long at = (((long long)b * a.sq + qpos) * a.heads + h) * HD;
#pragma unroll
    for (int c = 0; c < CPT; ++c) out[at + col_of<HD>(kg, c)] = dq[i][c] * mul;
  }
}

// blockIdx.z of the tile kernels: nk dK/dV tiles (key tiles) and nq dQ
// tiles (query tiles) in one grid, so that either kind fills the SMs the
// other leaves idle, each tile's ``splits`` blocks side by side (split =
// z % splits, split_of). The tiles alternate, dK/dV's r-th key tile beside dQ's r-th
// longest query tile (the last), so each wave holds both kinds, longest
// band first; past 2 min(nk, nq) come the rest of the more numerous kind.
// True for a dK/dV block, with its tile's rank r.
__device__ __forceinline__ bool dkdv_block(int nk, int nq, int splits, int* r) {
  const int z = (int)blockIdx.z / splits, m = min(nk, nq);
  if (z < 2 * m) {
    *r = z >> 1;
    return !(z & 1);
  }
  *r = z - m;
  return nk > nq;
}

// f32 dK/dV and dQ blocks, one launch (dkdv_block)
template <int HD>
__global__ void __launch_bounds__(kThreads, F32Tiles<HD>::MIN_BLOCKS)
flash_bwd_tiles_f32(BwdArgs a, int nk, int nq) {
  extern __shared__ __align__(16) float smem[];
  int r;
  if (dkdv_block(nk, nq, a.splits, &r)) {
    dkdv_f32<HD>(a, smem, r * kTile);
  } else {
    dq_f32<HD>(a, smem, (nq - 1 - r) * kTile);
  }
}

// ------------------------------------------------------------ bf16 kernels
constexpr int kWKeys = 128;     // dK/dV: keys a block, two consumer warpgroups of 64
constexpr int kWQ = 64;         // dK/dV: queries a tile
constexpr int kWRows = 128;     // dQ: query rows a block, two consumer warpgroups of 64
constexpr int kWKv = 64;        // dQ: keys a tile
constexpr int kConsumers = 256;
constexpr int kWThreads = kConsumers + 128;  // and the producer's warpgroup
// as the forward: the producer's warpgroup gives back all but 24 registers a
// thread, the consumers take 240 (256 x 240 + 128 x 24 = 384 x 168)
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;
constexpr int kStages = 2;      // ring depth: Q / dO tiles (dK/dV), K / V tiles (dQ)

template <int HD>
struct BwdWgmma {
  static constexpr int NP = (HD + kPanel - 1) / kPanel;  // 64-column panels of a row
  static constexpr int KSTEPS = HD / 16;                 // k16 steps over hd
  // dK/dV, byte offsets from the first 1,024-byte boundary: K, V (128 rows),
  // kStages x Q, kStages x dO (64 rows), kStages x (lse, D) rows, barriers
  // (kv, full[kStages], empty[kStages])
  static constexpr int KV_PANEL = kWKeys * kRowBytes;
  static constexpr int KV_BYTES = NP * KV_PANEL;
  static constexpr int QT_PANEL = kWQ * kRowBytes;
  static constexpr int QT_BYTES = NP * QT_PANEL;
  static constexpr int ROW_BYTES = kWQ * 4;  // a tile's lse or D
  static constexpr int DKDV_Q = 2 * KV_BYTES;
  static constexpr int DKDV_DO = DKDV_Q + kStages * QT_BYTES;
  static constexpr int DKDV_ROWS = DKDV_DO + kStages * QT_BYTES;
  static constexpr int DKDV_BAR = DKDV_ROWS + kStages * 2 * ROW_BYTES;
  // each consumer thread's 16 words of dS^T's low bf16 parts, parked while
  // the tile's first products run (word i of thread t at i * kConsumers + t)
  static constexpr int DKDV_LO = (DKDV_BAR + 8 * (1 + 2 * kStages) + 15) / 16 * 16;
  static constexpr int DKDV_SMEM = 1024 + DKDV_LO + 16 * 4 * kConsumers;
  // dQ: Q, dO (128 rows), kStages x K, kStages x V (64 rows), barriers (q,
  // full[kStages], empty[kStages])
  static constexpr int RQ_PANEL = kWRows * kRowBytes;
  static constexpr int RQ_BYTES = NP * RQ_PANEL;
  static constexpr int KT_PANEL = kWKv * kRowBytes;
  static constexpr int KT_BYTES = NP * KT_PANEL;
  static constexpr int DQ_DO = RQ_BYTES;
  static constexpr int DQ_K = 2 * RQ_BYTES;
  static constexpr int DQ_V = DQ_K + kStages * KT_BYTES;
  static constexpr int DQ_BAR = DQ_V + kStages * KT_BYTES;
  static constexpr int DQ_SMEM = 1024 + DQ_BAR + 8 * (1 + 2 * kStages);
};

__device__ __forceinline__ void init_ring(uint32_t bar_once, uint32_t bar_full,
                                          uint32_t bar_empty) {
  mbar_init(bar_once, 1);
  for (int s = 0; s < kStages; ++s) {
    mbar_init(bar_full + 8 * s, 1);
    mbar_init(bar_empty + 8 * s, kConsumers);
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// D (64 x 64, f32) = A (64 rows at ``a``, K-major, panels ``pa`` bytes
// apart) . B^T (64 rows at ``b``, K-major, panels ``pb`` bytes apart) over
// hd in k16 steps (step kk: panel kk / 4, byte 32 (kk % 4) of each row)
template <int HD>
__device__ __forceinline__ void ss_tile(float* d, uint32_t a, uint32_t pa, uint32_t b,
                                        uint32_t pb) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss_n64(d, sw128_desc(a + (kk / 4) * pa + off, 16, 1024),
                 sw128_desc(b + (kk / 4) * pb + off, 16, 1024), kk > 0);
  }
}

// the f32 64 x 64 accumulator ``x`` as the four k16 A fragments of a
// product over its columns (flash_attn.cu's pv_tile: the two layouts agree)
__device__ __forceinline__ void pack_frags(uint32_t (&f)[4][4], const float* x) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) f[t][i] = pack_bf16(x[8 * t + 2 * i], x[8 * t + 2 * i + 1]);
}

// ``x`` as two bf16 fragment sets, hi = bf16(x) and lo = bf16(x - hi): a
// product over hi and then lo sees x to about 16 bits
__device__ __forceinline__ void pack_split_frags(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                                                 const float* x) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = x[8 * t + 2 * i], b = x[8 * t + 2 * i + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      const float2 hf = __bfloat1622float2(h);
      hi[t][i] = *reinterpret_cast<const uint32_t*>(&h);
      lo[t][i] = pack_bf16(a - hf.x, b - hf.y);
    }
}

// D (64 x 64 NP) += A (64 x 64, four register fragments) . B (64 rows at
// ``b``, MN-major, panels ``pb`` bytes apart)
template <int HD>
__device__ __forceinline__ void rs_tile(float* d, const uint32_t (&f)[4][4], uint32_t b,
                                        uint32_t pb) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
    wgmma_rs<BwdWgmma<HD>::NP * kPanel>(d, f[t], sw128_desc(b + t * 16 * kRowBytes, pb, 1024));
}

// a dK/dV block: keys k0 .. k0 + 127 of query head blockIdx.x; Q and dO by
// 64-row tiles, K and V by 128-row ones
template <int HD>
__device__ __forceinline__ void dkdv_wgmma(const CUtensorMap& tq, const CUtensorMap& tk,
                                           const CUtensorMap& tv, const CUtensorMap& tdo,
                                           const BwdArgs& a, float scale_log2,
                                           uint8_t* smem_raw, int k0) {
  using W = BwdWgmma<HD>;
  constexpr int NA = W::NP * 32;  // accumulator floats a thread of dK (or dV)
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t s_k = base, s_v = base + W::KV_BYTES, s_q = base + W::DKDV_Q,
                 s_do = base + W::DKDV_DO, s_rows = base + W::DKDV_ROWS;
  const uint32_t bar_kv = base + W::DKDV_BAR, bar_full = bar_kv + 8,
                 bar_empty = bar_full + 8 * kStages;
  const float* rows_f = reinterpret_cast<const float*>(smem_raw + (s_rows - raw));
  uint32_t* lo_park = reinterpret_cast<uint32_t*>(smem_raw + (base + W::DKDV_LO - raw));

  const int h = blockIdx.x, b = blockIdx.y;
  const int kh = h / a.group, g = h - kh * a.group;
  // the query tiles some row of which sees a key of this block
  int qt_lo = 0, qt_hi = (a.sq - 1) / kWQ;
  if (a.causal) qt_lo = k0 / kWQ;
  if (a.window > 0)
    qt_hi = (int)min((long long)qt_hi,
                     ((long long)min(k0 + kWKeys, a.skv) - 2 + a.window) / kWQ);
  const int split = split_of(a);
  const int n_qt = split_tiles(qt_hi - qt_lo + 1, split, a.splits), qt0 = qt_lo + split;

  const int tid = threadIdx.x;
  if (tid == 0) init_ring(bar_kv, bar_full, bar_empty);
  __syncthreads();

  if (tid >= kConsumers) {  // the producer: one lane of its first warp issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid == kConsumers) {
      mbar_expect_tx(bar_kv, 2 * W::KV_BYTES);
      for (int p = 0; p < W::NP; ++p) {
        tma_load_4d(s_k + p * W::KV_PANEL, &tk, bar_kv, p * kPanel, kh, k0, b);
        tma_load_4d(s_v + p * W::KV_PANEL, &tv, bar_kv, p * kPanel, kh, k0, b);
      }
      const long long rows = ((long long)b * a.heads + h) * a.sq_pad;
      for (int i = 0; i < n_qt; ++i) {
        const int s = i % kStages;
        mbar_wait(bar_empty + 8 * s, ((i / kStages) & 1) ^ 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * W::QT_BYTES + 2 * W::ROW_BYTES);
        const int q0 = (qt0 + i * a.splits) * kWQ;
        for (int p = 0; p < W::NP; ++p) {
          tma_load_4d(s_q + s * W::QT_BYTES + p * W::QT_PANEL, &tq, full, p * kPanel, h, q0, b);
          tma_load_4d(s_do + s * W::QT_BYTES + p * W::QT_PANEL, &tdo, full, p * kPanel, h, q0,
                      b);
        }
        bulk_load(s_rows + s * 2 * W::ROW_BYTES, a.lse_pad + rows + q0, W::ROW_BYTES, full);
        bulk_load(s_rows + s * 2 * W::ROW_BYTES + W::ROW_BYTES, a.dd + rows + q0, W::ROW_BYTES,
                  full);
      }
    }
    return;
  }

  // a consumer warpgroup: 64 keys; this thread holds keys kr and kr + 8
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int kw_lo = k0 + 64 * wg, kw_hi = kw_lo + 63;  // the warpgroup's keys
  const int kr = kw_lo + 16 * warp + lane / 4;
  const int c0 = 2 * (lane % 4);
  // column 8j + c0 + (e & 1) of key rows kr, kr + 8 (e >> 1) in dk[4j + e]
  float dk[NA], dv[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dk[i] = dv[i] = 0.f;
  const uint32_t ka = s_k + wg * 64 * kRowBytes, va = s_v + wg * 64 * kRowBytes;

  mbar_wait(bar_kv, 0);
  for (int i = 0; i < n_qt; ++i) {
    const int s = i % kStages;
    const int q0 = (qt0 + i * a.splits) * kWQ;
    mbar_wait(bar_full + 8 * s, (i / kStages) & 1);
    // a warpgroup none of whose keys this tile sees skips it
    const bool none = (a.causal && kw_lo > q0 + kWQ - 1) ||
                      (a.window > 0 && kw_hi <= q0 - a.window);
    if (!none) {
      const uint32_t qt = s_q + s * W::QT_BYTES, dot = s_do + s * W::QT_BYTES;
      const float* lse = rows_f + s * 2 * kWQ;
      const float* dd = lse + kWQ;
      float st[32], dpt[32];  // S^T and dP^T: (key, query)
      wgmma_fence();
      ss_tile<HD>(st, ka, W::KV_PANEL, qt, W::QT_PANEL);
      ss_tile<HD>(dpt, va, W::KV_PANEL, dot, W::QT_PANEL);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<32>(st);
      fence_regs<32>(dpt);

      const bool edge = (a.causal && kw_hi > q0) ||
                        (a.window > 0 && kw_lo <= q0 + kWQ - 1 - a.window) ||
                        q0 + kWQ > a.sq || kw_hi >= a.skv;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + c0 + (e & 1);
          float p = exp2f(fmaf(st[4 * j + e], scale_log2, -lse[col]));
          if (edge && !visible(a, q0 + col, kr + 8 * (e >> 1))) p = 0.f;
          st[4 * j + e] = p;
          dpt[4 * j + e] = p * (dpt[4 * j + e] - dd[col]);
        }
      // dV += P^T dO and dK += hi(dS^T) Q first, then dK += lo(dS^T) Q: at hd
      // 128 the 128 accumulators, three fragment sets and the descriptors of
      // one group overflow the consumers' registers, so lo waits in shared
      // memory (each thread its own words: no barrier)
      uint32_t fp[4][4], fds[4][4];
      {
        uint32_t fdl[4][4];
        pack_frags(fp, st);
        pack_split_frags(fds, fdl, dpt);
#pragma unroll
        for (int w = 0; w < 16; ++w) lo_park[w * kConsumers + tid] = (&fdl[0][0])[w];
      }
      fence_regs<16>(&fp[0][0]);
      fence_regs<16>(&fds[0][0]);
      fence_regs<NA>(dv);
      fence_regs<NA>(dk);
      wgmma_fence();
      rs_tile<HD>(dv, fp, dot, W::QT_PANEL);
      rs_tile<HD>(dk, fds, qt, W::QT_PANEL);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<16>(&fp[0][0]);
      fence_regs<16>(&fds[0][0]);
      fence_regs<NA>(dv);
      fence_regs<NA>(dk);
      uint32_t fdl[4][4];
#pragma unroll
      for (int w = 0; w < 16; ++w) (&fdl[0][0])[w] = lo_park[w * kConsumers + tid];
      fence_regs<16>(&fdl[0][0]);
      wgmma_fence();
      rs_tile<HD>(dk, fdl, qt, W::QT_PANEL);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<16>(&fdl[0][0]);
      fence_regs<NA>(dk);
    }
    mbar_arrive(bar_empty + 8 * s);  // this thread is done with the stage
  }

  // G splits > 1: this block's partials go to slot g splits + split of pk
  const long long n = (long long)a.b_rows * a.skv * a.kv_heads * HD;
  const int pk = a.group * a.splits, slot = g * a.splits + split_of(a);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = kr + 8 * r;
    if (kpos >= a.skv) continue;
    const long long at = kv_row(a, b, kpos, kh, HD);
#pragma unroll
    for (int j = 0; j < W::NP * 8; ++j) {
      const int col = 8 * j + c0;
      if (col >= HD) continue;
      const float k_lo = dk[4 * j + 2 * r], k_hi = dk[4 * j + 2 * r + 1];
      const float v_lo = dv[4 * j + 2 * r], v_hi = dv[4 * j + 2 * r + 1];
      if (pk == 1) {
        *reinterpret_cast<__nv_bfloat162*>((__nv_bfloat16*)a.dk + at + col) =
            __floats2bfloat162_rn(k_lo * a.scale, k_hi * a.scale);
        *reinterpret_cast<__nv_bfloat162*>((__nv_bfloat16*)a.dv + at + col) =
            __floats2bfloat162_rn(v_lo, v_hi);
      } else {
        *reinterpret_cast<float2*>(a.part + slot * n + at + col) = make_float2(k_lo, k_hi);
        *reinterpret_cast<float2*>(a.part + (pk + slot) * n + at + col) =
            make_float2(v_lo, v_hi);
      }
    }
  }
}

// a dQ block: query rows q0 .. q0 + 127 of query head blockIdx.x; Q and dO
// by 128-row tiles, K and V by 64-row ones
template <int HD>
__device__ __forceinline__ void dq_wgmma(const CUtensorMap& tq, const CUtensorMap& tk,
                                         const CUtensorMap& tv, const CUtensorMap& tdo,
                                         const BwdArgs& a, float scale_log2, uint8_t* smem_raw,
                                         int q0) {
  using W = BwdWgmma<HD>;
  constexpr int NA = W::NP * 32;
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base, s_do = base + W::DQ_DO, s_k = base + W::DQ_K, s_v = base + W::DQ_V;
  const uint32_t bar_q = base + W::DQ_BAR, bar_full = bar_q + 8,
                 bar_empty = bar_full + 8 * kStages;

  const int h = blockIdx.x, b = blockIdx.y, kh = h / a.group;
  // the band of KV tiles some query of this block can see
  const int q_last = min(q0 + kWRows, a.sq) - 1;
  int kt_hi = (a.skv - 1) / kWKv;
  if (a.causal) kt_hi = min(kt_hi, q_last / kWKv);
  int kt_lo = 0;
  if (a.window > 0) {
    const int lo = q0 - a.window + 1;
    kt_lo = lo > 0 ? lo / kWKv : 0;
  }
  const int split = split_of(a);
  const int n_kt = split_tiles(kt_hi - kt_lo + 1, split, a.splits), kt0 = kt_lo + split;

  const int tid = threadIdx.x;
  if (tid == 0) init_ring(bar_q, bar_full, bar_empty);
  __syncthreads();

  if (tid >= kConsumers) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid == kConsumers) {
      mbar_expect_tx(bar_q, 2 * W::RQ_BYTES);
      for (int p = 0; p < W::NP; ++p) {
        tma_load_4d(s_q + p * W::RQ_PANEL, &tq, bar_q, p * kPanel, h, q0, b);
        tma_load_4d(s_do + p * W::RQ_PANEL, &tdo, bar_q, p * kPanel, h, q0, b);
      }
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % kStages;
        mbar_wait(bar_empty + 8 * s, ((i / kStages) & 1) ^ 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * W::KT_BYTES);
        const int k0 = (kt0 + i * a.splits) * kWKv;
        for (int p = 0; p < W::NP; ++p) {
          tma_load_4d(s_k + s * W::KT_BYTES + p * W::KT_PANEL, &tk, full, p * kPanel, kh, k0, b);
          tma_load_4d(s_v + s * W::KT_BYTES + p * W::KT_PANEL, &tv, full, p * kPanel, kh, k0, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: 64 query rows; this thread holds rows r0 and r0 + 8
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int wg_lo = q0 + 64 * wg, wg_hi = wg_lo + 63;
  const int r0 = wg_lo + 16 * warp + lane / 4;
  const int c0 = 2 * (lane % 4);
  const long long rows = ((long long)b * a.heads + h) * a.sq_pad;
  // rows past Sq read the padding (zeros); the pad covers every block's 128 rows
  const float lse[2] = {a.lse_pad[rows + r0], a.lse_pad[rows + r0 + 8]};
  const float dd[2] = {a.dd[rows + r0], a.dd[rows + r0 + 8]};
  float dq[NA];  // column 8j + c0 + (e & 1) of rows r0, r0 + 8 (e >> 1) in dq[4j + e]
#pragma unroll
  for (int i = 0; i < NA; ++i) dq[i] = 0.f;
  const uint32_t qa = s_q + wg * 64 * kRowBytes, da = s_do + wg * 64 * kRowBytes;

  mbar_wait(bar_q, 0);
  for (int i = 0; i < n_kt; ++i) {
    const int s = i % kStages;
    const int k0 = (kt0 + i * a.splits) * kWKv;
    mbar_wait(bar_full + 8 * s, (i / kStages) & 1);
    // a warpgroup none of whose rows sees a key of this tile skips it
    const bool none = (a.causal && k0 > wg_hi) ||
                      (a.window > 0 && k0 + kWKv - 1 <= wg_lo - a.window);
    if (!none) {
      const uint32_t kt = s_k + s * W::KT_BYTES, vt = s_v + s * W::KT_BYTES;
      float sc[32], dp[32];  // S and dP: (query, key)
      wgmma_fence();
      ss_tile<HD>(sc, qa, W::RQ_PANEL, kt, W::KT_PANEL);
      ss_tile<HD>(dp, da, W::RQ_PANEL, vt, W::KT_PANEL);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<32>(sc);
      fence_regs<32>(dp);

      const bool edge = (a.causal && k0 + kWKv - 1 > wg_lo) ||
                        (a.window > 0 && k0 <= wg_hi - a.window) || k0 + kWKv > a.skv ||
                        wg_hi >= a.sq;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(sc[4 * j + e], scale_log2, -lse[e >> 1]));
          if (edge && !visible(a, r0 + 8 * (e >> 1), k0 + 8 * j + c0 + (e & 1))) p = 0.f;
          dp[4 * j + e] = p * (dp[4 * j + e] - dd[e >> 1]);
        }
      uint32_t fds[4][4], fdl[4][4];
      pack_split_frags(fds, fdl, dp);
      fence_regs<16>(&fds[0][0]);
      fence_regs<16>(&fdl[0][0]);
      fence_regs<NA>(dq);
      wgmma_fence();
      rs_tile<HD>(dq, fds, kt, W::KT_PANEL);
      rs_tile<HD>(dq, fdl, kt, W::KT_PANEL);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<16>(&fds[0][0]);
      fence_regs<16>(&fdl[0][0]);
      fence_regs<NA>(dq);
    }
    mbar_arrive(bar_empty + 8 * s);
  }

  // splits > 1: this block's partial (f32) goes to its split's part of qpart
  float* qp = a.splits == 1 ? nullptr
                            : a.qpart + split_of(a) * ((long long)a.b_rows * a.sq * a.heads * HD);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = r0 + 8 * r;
    if (qpos >= a.sq) continue;
    const long long at = (((long long)b * a.sq + qpos) * a.heads + h) * HD;
#pragma unroll
    for (int j = 0; j < W::NP * 8; ++j) {
      const int col = 8 * j + c0;
      if (col >= HD) continue;
      if (a.splits == 1) {
        *reinterpret_cast<__nv_bfloat162*>((__nv_bfloat16*)a.dq + at + col) =
            __floats2bfloat162_rn(dq[4 * j + 2 * r] * a.scale, dq[4 * j + 2 * r + 1] * a.scale);
      } else {
        *reinterpret_cast<float2*>(qp + at + col) =
            make_float2(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
      }
    }
  }
}

// bf16 dK/dV and dQ blocks, one launch (dkdv_block); the tensor maps cover
// (B, S, heads, hd), Q and dO by 64 rows (dK/dV) and 128 (dQ), K and V the
// other way round
template <int HD>
__global__ void __launch_bounds__(kWThreads, 1)
flash_bwd_tiles_wgmma(const __grid_constant__ CUtensorMap tq64,
                      const __grid_constant__ CUtensorMap tdo64,
                      const __grid_constant__ CUtensorMap tk128,
                      const __grid_constant__ CUtensorMap tv128,
                      const __grid_constant__ CUtensorMap tq128,
                      const __grid_constant__ CUtensorMap tdo128,
                      const __grid_constant__ CUtensorMap tk64,
                      const __grid_constant__ CUtensorMap tv64, BwdArgs a, float scale_log2,
                      int nk, int nq) {
  extern __shared__ uint8_t smem_raw[];
  int r;
  if (dkdv_block(nk, nq, a.splits, &r)) {
    dkdv_wgmma<HD>(tq64, tk128, tv128, tdo64, a, scale_log2, smem_raw, r * kWKeys);
  } else {
    dq_wgmma<HD>(tq128, tk64, tv64, tdo128, a, scale_log2, smem_raw, (nq - 1 - r) * kWRows);
  }
}

// ---------------------------------------------------------------- launches
constexpr int kMaxSplits = 8;

// The backward's plan for a call on the current card: blocks a tile
// (splits), the f32 scratch the C entry carves and its launches. A grid
// whose blocks fill under half the card's block slots takes twice the
// blocks, each with every other tile of its band, and again while that
// holds (at most kMaxSplits, at most the band's 64-row tiles): a band's
// tiles run one after another in a block, so a small grid (B 2, S 256, H 4:
// 64 blocks of 4 tiles for 264 slots at hd 64) is bound by one block's
// latency.
struct Plan {
  int splits;
  long long scratch;  // floats
  int launches;
};

int plan_of(bool bf16, int b_rows, int sq, int skv, int heads, int kv_heads, int hd, Plan* p) {
  int per_sm;  // blocks an SM of the tile kernel
  switch (hd) {
    case 32: per_sm = bf16 ? 1 : F32Tiles<32>::MIN_BLOCKS; break;
    case 64: per_sm = bf16 ? 1 : F32Tiles<64>::MIN_BLOCKS; break;
    case 128: per_sm = bf16 ? 1 : F32Tiles<128>::MIN_BLOCKS; break;
    default: return (int)cudaErrorInvalidValue;
  }
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int keys = bf16 ? kWKeys : kTile, rows = bf16 ? kWRows : kTile;
  const long long blocks = ((long long)(skv + keys - 1) / keys + (sq + rows - 1) / rows) *
                           heads * b_rows;
  const int band = ((sq > skv ? sq : skv) + 63) / 64;  // the longest band, in 64-row tiles
  int splits = 1;
  const long long slots = (long long)sms * per_sm;
  while (splits < kMaxSplits && 2 * splits <= band && 2 * splits * blocks <= slots) splits *= 2;
  const long long sq_pad = ((long long)sq + kRowPad - 1) / kRowPad * kRowPad;
  const long long pk = (long long)(heads / kv_heads) * splits;
  p->splits = splits;
  p->scratch = 2 * b_rows * heads * sq_pad +
               (pk > 1 ? 2 * pk * b_rows * skv * kv_heads * hd : 0) +
               (splits > 1 ? (long long)splits * b_rows * sq * heads * hd : 0);
  p->launches = pk > 1 ? 3 : 2;
  return 0;
}

// the tile kernels' grid: nk dK/dV tiles of ``keys`` keys and nq dQ tiles
// of ``rows`` query rows, splits blocks each, along z
int grid_z(const BwdArgs& a, int keys, int rows, int* nk, int* nq) {
  const long long k = ((long long)a.skv + keys - 1) / keys, q = ((long long)a.sq + rows - 1) / rows;
  if ((k + q) * a.splits > 65535) return (int)cudaErrorInvalidValue;
  *nk = (int)k;
  *nq = (int)q;
  return 0;
}

template <int HD>
int launch_f32(const BwdArgs& a, cudaStream_t stream) {
  using F = F32Tiles<HD>;
  constexpr int smem = F::DKDV_BYTES > F::DQ_BYTES ? F::DKDV_BYTES : F::DQ_BYTES;
  int nk, nq;
  const int e = grid_z(a, kTile, kTile, &nk, &nq);
  if (e) return e;
  const cudaError_t err = cudaFuncSetAttribute(flash_bwd_tiles_f32<HD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_tiles_f32<HD><<<dim3(a.heads, a.b_rows, (nk + nq) * a.splits), kThreads, smem,
                            stream>>>(a, nk, nq);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bf16(const BwdArgs& a, cudaStream_t stream) {
  using W = BwdWgmma<HD>;
  constexpr int smem = W::DKDV_SMEM > W::DQ_SMEM ? W::DKDV_SMEM : W::DQ_SMEM;
  int nk, nq;
  int e = grid_z(a, kWKeys, kWRows, &nk, &nq);
  CUtensorMap tq64, tdo64, tk128, tv128, tq128, tdo128, tk64, tv64;
  const long long* qs = a.qs;
  if (!e) e = encode(&tq64, a.q, HD, a.heads, a.sq, a.b_rows, qs[0], qs[1], qs[2], kWQ);
  if (!e) e = encode(&tdo64, a.dout, HD, a.heads, a.sq, a.b_rows, a.ds[0], a.ds[1], a.ds[2], kWQ);
  if (!e) e = encode(&tk128, a.k, HD, a.kv_heads, a.skv, a.b_rows, a.ks[0], a.ks[1], a.ks[2],
                     kWKeys);
  if (!e) e = encode(&tv128, a.v, HD, a.kv_heads, a.skv, a.b_rows, a.vs[0], a.vs[1], a.vs[2],
                     kWKeys);
  if (!e) e = encode(&tq128, a.q, HD, a.heads, a.sq, a.b_rows, qs[0], qs[1], qs[2], kWRows);
  if (!e) e = encode(&tdo128, a.dout, HD, a.heads, a.sq, a.b_rows, a.ds[0], a.ds[1], a.ds[2],
                     kWRows);
  if (!e) e = encode(&tk64, a.k, HD, a.kv_heads, a.skv, a.b_rows, a.ks[0], a.ks[1], a.ks[2], kWKv);
  if (!e) e = encode(&tv64, a.v, HD, a.kv_heads, a.skv, a.b_rows, a.vs[0], a.vs[1], a.vs[2], kWKv);
  if (e) return e;
  const cudaError_t err = cudaFuncSetAttribute(flash_bwd_tiles_wgmma<HD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_tiles_wgmma<HD><<<dim3(a.heads, a.b_rows, (nk + nq) * a.splits), kWThreads, smem,
                              stream>>>(
      tq64, tdo64, tk128, tv128, tq128, tdo128, tk64, tv64, a, a.scale * kLog2e, nk, nq);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  const long long rows = (long long)a.b_rows * a.heads * a.sq_pad;
  const long long dot_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (dot_blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  flash_bwd_dot_kernel<T, HD><<<(unsigned)dot_blocks, kThreads, 0, stream>>>(a, rows);
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = sizeof(T) == 2 ? launch_bf16<HD>(a, stream) : launch_f32<HD>(a, stream);
  if (err || a.group * a.splits == 1) return err;
  const long long n_kv = (long long)a.b_rows * a.skv * a.kv_heads * HD;
  const long long n_q = (long long)a.b_rows * a.sq * a.heads * HD;
  const long long blocks = ((n_kv + (a.splits > 1 ? n_q : 0)) / 4 + kThreads - 1) / kThreads;
  flash_bwd_sum_kernel<T><<<(unsigned)(blocks < 1056 ? blocks : 1056), kThreads, 0, stream>>>(
      a, n_kv, n_q);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const BwdArgs& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_bwd<T, 32>(a, stream);
    case 64: return launch_bwd<T, 64>(a, stream);
    case 128: return launch_bwd<T, 128>(a, stream);
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
  using F = F32Tiles<HD>;
  using W = BwdWgmma<HD>;
  switch (which) {
    case 0: return fill_attrs((const void*)flash_bwd_dot_kernel<T, HD>, 0, out);
    case 1:
      if (sizeof(T) == 2)
        return fill_attrs((const void*)flash_bwd_tiles_wgmma<HD>,
                          W::DKDV_SMEM > W::DQ_SMEM ? W::DKDV_SMEM : W::DQ_SMEM, out);
      return fill_attrs((const void*)flash_bwd_tiles_f32<HD>,
                        F::DKDV_BYTES > F::DQ_BYTES ? F::DKDV_BYTES : F::DQ_BYTES, out);
    case 2: return fill_attrs((const void*)flash_bwd_sum_kernel<T>, 0, out);
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
// one dtype (0: f32, 1: bf16), innermost stride 1, and 16-byte strides and
// base addresses for q, k, v and dout (bf16: TMA's; f32: the tile copies');
// ``strides`` holds the (batch, seq, head) strides in elements of q, k, v, o
// and dout, 15 in all. lse (B, H, Sq) f32 from the forward; dd an f32
// scratch of g4r_flash_attn_bwd_plan's floats; dq, dk, dv contiguous outputs
// in the inputs' dtype. window <= 0 means none. The plan's launches on
// ``stream``; returns cudaGetLastError() after them.
extern "C" int g4r_flash_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, const float* lse, float* dd, void* dq,
                                  void* dk, void* dv, int dtype, int b_rows, int sq, int skv,
                                  int heads, int kv_heads, int hd, const long long* strides,
                                  float scale, int causal, int window, void* stream) {
  if (b_rows <= 0 || sq <= 0 || heads <= 0) return (int)cudaGetLastError();
  if (kv_heads <= 0 || heads % kv_heads != 0 || skv <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Plan plan;
  const int err = plan_of(dtype == 1, b_rows, sq, skv, heads, kv_heads, hd, &plan);
  if (err) return err;
  BwdArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.lse = lse; a.dq = dq; a.dk = dk; a.dv = dv;
  a.b_rows = b_rows; a.sq = sq; a.skv = skv; a.heads = heads; a.kv_heads = kv_heads;
  a.group = heads / kv_heads;
  a.splits = plan.splits;
  a.sq_pad = (sq + kRowPad - 1) / kRowPad * kRowPad;
  // lse and D rows, then the dK / dV partials, then the dQ partials
  const long long padded = (long long)b_rows * heads * a.sq_pad;
  const long long pk = (long long)a.group * a.splits;
  a.lse_pad = dd;
  a.dd = dd + padded;
  a.part = dd + 2 * padded;
  a.qpart = a.part + (pk > 1 ? 2 * pk * b_rows * skv * kv_heads * hd : 0);
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
  return dtype == 0 ? dispatch_hd<float>(a, hd, s) : dispatch_hd<__nv_bfloat16>(a, hd, s);
}

// The backward's plan for these dimensions on the current card: out[0] the
// blocks a tile (splits), out[1] the scratch g4r_flash_attn_bwd takes (f32
// floats), out[2] its launches. Returns a cudaError_t.
extern "C" int g4r_flash_attn_bwd_plan(int dtype, int b_rows, int sq, int skv, int heads,
                                       int kv_heads, int hd, long long* out) {
  if (b_rows <= 0 || sq <= 0 || skv <= 0 || heads <= 0 || kv_heads <= 0 ||
      heads % kv_heads != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Plan plan;
  const int err = plan_of(dtype == 1, b_rows, sq, skv, heads, kv_heads, hd, &plan);
  if (err) return err;
  out[0] = plan.splits;
  out[1] = plan.scratch;
  out[2] = plan.launches;
  return 0;
}

// Registers, local memory (spills and stack) and dynamic shared memory of the
// backward's kernel ``which`` (0 the D pass, 1 the dK/dV and dQ tiles, 2 the
// sum of the partials) for (dtype, hd): out[0..2]. Returns a cudaError_t.
extern "C" int g4r_flash_attn_bwd_attrs(int dtype, int hd, int which, int* out) {
  if (dtype == 0) return attrs_hd<float>(hd, which, out);
  if (dtype == 1) return attrs_hd<__nv_bfloat16>(hd, which, out);
  return (int)cudaErrorInvalidValue;
}
