// IVF gather-then-score shortlist over int8 CSR inverted lists, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ivf.py:ivf_list_topk_pallas
// (pallas_call at :136). Per query and probe p: the list's rows start at
// starts[q, p] and number lengths[q, p] (clamped to [0, lpad]); each row's
// score is (codes . q) * scale, the dot accumulated in f32 and the scale a
// separate multiply after it, as in the reference. Across all probes the
// S = shortlist best are kept, best first; on equal scores the lower flat
// index p * lpad + offset wins, and +0.0 ranks above -0.0 (lax.top_k's
// order). Slots no candidate fills are (-inf, -1). Output rows are packed
// row indices start + offset. The dot runs over d in order, one rounded
// product and one rounded sum a term (no fused multiply-add), as the plain
// version kernels/ref.py:ivf_list_scores computes it: the two agree
// bitwise, so near-tied scores rank alike in both. Rows may repeat across
// probes; a row outside [0, rows) is dropped, never read.
//
// What bounds it on this card. Each candidate row is d int8 codes and one
// f32 scale, scored with 2d FLOP. At the 1M arm's call (d 32, ~900,000
// distinct rows) that is bytes: ~33 MB, 10 us at 3.35 TB/s. At the UB
// calls a row is scored by thousands of queries from L2, and the bound is
// operations: 2d FLOP a (query, row) pair over 67 TFLOP/s. The ordered,
// FMA-free dot cannot use the FMA rate or the tensor cores, and an int8
// code becomes an f32 in one more add (the conversion below), so the
// CUDA-core floor is 3d operations a pair at 128 a clock an SM: 1.5x the
// FLOP bound (twice the FMA-peak one), about 0.11 ms at the UB S 419 call.
//
// Every candidate becomes one 64-bit key: the score's total-order bits in
// the high half and the complement of its flat index in the low half. Flat
// indices are unique within a query, so keys are unique and descending key
// order is exactly (score desc, flat index asc): the S best are a fixed set
// whatever the order of the work. Key 0 is the empty slot.
//
// How each regime is handled (kernels/ivf.py:plan_launch picks one a call;
// one launch a call either way):
//   - shared (cluster size C = 1 .. 8): a query's probes are dealt round
//     the C blocks of a thread-block cluster (block r takes probes r, r + C,
//     ..; the probes come nearest first, so the blocks hold keys spread
//     alike over the scores). A block scores its probes' rows, one thread a
//     row, into shared memory as keys, packed by the prefix of its list
//     lengths. At d 32 and 64 a thread loads its next row's codes and
//     scale into registers (16-byte loads) while it scores this one; any
//     other d (or an unaligned table) takes byte loads: a load path chosen
//     by shape. The query is read
//     from shared memory 16 bytes at a time, one broadcast for 4 terms.
//     The block then selects once for the whole query: where the query's
//     candidates exceed S, a radix select over the key bits finds the S-th
//     key, 8 bits a pass from the highest bit where the cluster's keys
//     differ, with shared-memory histograms summed over the cluster through
//     distributed shared memory, stopping as soon as the keys at or above
//     the chosen bucket are few enough to sort. Otherwise (the exhaustive
//     regime, nprobe == nlist) every key is kept. Each block compacts its
//     kept keys in place and sorts them (a bitonic network whose
//     comparators all put the larger key first, so it needs no padding; the
//     stages within 64-key chunks in registers); a key's output slot is its
//     index plus, for each peer block, the number of the peer's kept keys
//     above it: each peer's sorted keys come over distributed shared memory
//     in chunks (coalesced remote reads; a search through remote memory,
//     a round trip a step, cost more than the scoring) and are merged with
//     the block's own by merge path, each thread an equal share. Nothing goes
//     through device memory but the inputs and the (Q, S) outputs. The
//     histogram counts do not depend on the order of their atomic adds, and
//     the kept set is the keys at or above a threshold, so re-runs are
//     bitwise equal. The plan takes the smallest C whose blocks hold a
//     query's P * lpad keys, raised only while the Q * C blocks fall short
//     of one wave of resident blocks.
//   - global (C = 0): where even 8 blocks cannot hold a query's keys, one
//     block a query walks its probes, sorts each chunk of up to kChunk rows
//     in shared memory, and merges it by merge path into a running list in
//     a (2, Q, S) device workspace; a chunk whose best key is below a full
//     list's last is skipped.
//
// Measured against the TPU design's slab copies: staging each tile of rows
// by cp.async into a two-stage ring took 1.8x the scoring time of the
// register prefetch at the UB S 419 call (PERF.md, PR 18).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 2048;     // global path: rows scored and sorted at once
constexpr int kBins = 256;       // radix select: 8 bits a pass
constexpr int kMaxCluster = 8;   // = kernels/ivf.py:MAX_CLUSTER (the portable size)
constexpr int kRankChunk = 2048;  // cluster ranking: a peer's keys copied at a time
constexpr unsigned kFull = 0xffffffffu;

// How a block reads its code rows (kernels/ivf.py:load_mode):
constexpr int kBytes = 0;  // byte loads (any other d, or an unaligned table)
constexpr int kPre2 = 1;   // 16-byte loads into registers a row ahead: d 32
constexpr int kPre4 = 2;   // the same at d 64

// 16-byte units a row held in registers by load mode `load` (0: not held)
__host__ __device__ constexpr int held_units(int load) {
  return load == kPre2 ? 2 : load == kPre4 ? 4 : 0;
}

__device__ __forceinline__ unsigned int order_bits(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(unsigned int o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ u64 make_key(float score, unsigned int flat) {
  return ((u64)order_bits(score) << 32) | (u64)(~flat);
}

// Adds 16 int8 codes (one 16-byte unit) times the query's floats q4[0..4)
// to acc in order, one rounded product and one rounded sum a term. Each code
// becomes its f32 exactly as 2^23 + (c + 128), built by a byte permute, less
// 2^23 + 128: one integer and one f32 operation, where a conversion
// instruction runs at an eighth of the f32 rate.
__device__ __forceinline__ float dot_unit(float acc, int4 v, const float4* q4) {
  const unsigned w[4] = {(unsigned)v.x ^ 0x80808080u, (unsigned)v.y ^ 0x80808080u,
                         (unsigned)v.z ^ 0x80808080u, (unsigned)v.w ^ 0x80808080u};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 qv = q4[j];
    const float qs[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float c =
          __fadd_rn(__uint_as_float(__byte_perm(w[j], 0x4B000000u, 0x7650 + b)), -8388736.0f);
      acc = __fadd_rn(acc, __fmul_rn(c, qs[b]));
    }
  }
  return acc;
}

// The ordered, FMA-free dot of one code row in device memory with the query
// in shared memory. VEC: 16-byte loads (d % 16 == 0, a 16-byte aligned
// table), else byte loads.
template <bool VEC>
__device__ __forceinline__ float dot_row(const int8_t* __restrict__ row, const float* s_q,
                                         int d) {
  float acc = 0.0f;
  if (VEC) {
    const int4* r4 = reinterpret_cast<const int4*>(row);
    const float4* q4 = reinterpret_cast<const float4*>(s_q);
    for (int t = 0; t < d / 16; ++t) acc = dot_unit(acc, __ldg(r4 + t), q4 + 4 * t);
  } else {
    for (int t = 0; t < d; ++t) acc = __fadd_rn(acc, __fmul_rn((float)row[t], s_q[t]));
  }
  return acc;
}

// The same for a row held in registers (U 16-byte units).
template <int U>
__device__ __forceinline__ float dot_units(const int4 (&v)[U], const float* s_q) {
  float acc = 0.0f;
  const float4* q4 = reinterpret_cast<const float4*>(s_q);
#pragma unroll
  for (int t = 0; t < U; ++t) acc = dot_unit(acc, v[t], q4 + 4 * t);
  return acc;
}

// ------------------------------------------------------------ shared path
// The most keys a block keeps: S + S/8 + 32 where a select ran (its stop
// rule), else its own candidates, never more than its slots.
__host__ __device__ __forceinline__ int keep_cap(int ppb, int lpad, int S) {
  return (int)min((long long)ppb * lpad, (long long)S + (S >> 3) + 32);
}

// The dynamic shared memory of a block holding `ppb` probes of lpad rows,
// in order: the keys, two histograms and their cluster sum, the query, the
// lists' prefix and starts, the scalars and, in a cluster, each kept key's
// count of the peers' keys above it and a chunk of a peer's keys
// (kernels/ivf.py:shared_bytes computes the same).
__host__ __device__ __forceinline__ size_t r16(size_t n) { return (n + 15) / 16 * 16; }
__host__ __device__ __forceinline__ size_t keys_bytes(int ppb, int lpad) {
  return r16((size_t)ppb * (size_t)lpad * sizeof(u64));
}
__host__ __device__ __forceinline__ size_t shared_bytes(int ppb, int lpad, int d, int cluster,
                                                        int S) {
  const size_t rank = cluster > 1 ? r16((size_t)keep_cap(ppb, lpad, S) * 4) +
                                        (size_t)kRankChunk * sizeof(u64)
                                  : 0;
  return keys_bytes(ppb, lpad) + 3 * kBins * 4 + r16((size_t)d * 4) +
         r16((size_t)(2 * ppb + 1) * 4) + 64 + rank;
}

struct Scalars {
  u64 kmax, kmin;   // this block's largest and smallest non-empty key
  int count;        // its non-empty keys
  int nsel;         // its kept keys
  int bin, above, inbin;  // a select pass's choice, broadcast
};

// The larger of a and b where keep_max, else the smaller.
__device__ __forceinline__ u64 pick(u64 a, u64 b, bool keep_max) {
  return (b > a) == keep_max ? b : a;
}

// One warp's share of a bitonic stage set on 64-key chunks held in
// registers: element lane of a chunk in a, element 32 + lane in b. Runs the
// merges of sizes 2 .. 64 (first) or only the half-cleaners of strides
// 32 .. 1 of a larger merge, larger keys to lower positions.
__device__ __forceinline__ void chunk_stages(u64& a, u64& b, int lane, bool first) {
  if (first) {
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
      const bool low = (lane & (size >> 1)) == 0;  // the lower half of its merge
      a = pick(a, __shfl_xor_sync(kFull, a, size - 1), low);
      b = pick(b, __shfl_xor_sync(kFull, b, size - 1), low);
#pragma unroll
      for (int st = size >> 2; st > 0; st >>= 1) {
        const bool lo = (lane & st) == 0;
        a = pick(a, __shfl_xor_sync(kFull, a, st), lo);
        b = pick(b, __shfl_xor_sync(kFull, b, st), lo);
      }
    }
    // size 64's mirrored comparison: element l with element 63 - l
    const u64 pa = __shfl_xor_sync(kFull, a, 31), pb = __shfl_xor_sync(kFull, b, 31);
    a = pick(a, pb, true);
    b = pick(b, pa, false);
  } else {
    const u64 hi = pick(a, b, true), lo = pick(a, b, false);  // stride 32
    a = hi;
    b = lo;
  }
#pragma unroll
  for (int st = 16; st > 0; st >>= 1) {
    const bool lo = (lane & st) == 0;
    a = pick(a, __shfl_xor_sync(kFull, a, st), lo);
    b = pick(b, __shfl_xor_sync(kFull, b, st), lo);
  }
}

// Sorts keys[0..n) descending by the whole block: a bitonic network whose
// comparators all put the larger key first (each merge opens with the
// mirrored comparison), so positions past n act as key 0, the least. The
// stages within 64-key chunks run in registers, a warp a chunk (shuffles,
// no block barrier); only the comparisons 64 or more apart go through
// shared memory, and those that reach past n are skipped.
__device__ void sort_desc(u64* keys, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int npow = 64;
  while (npow < n) npow <<= 1;
  auto in_chunks = [&](bool first) {
    for (int base = warp * 64; base < n; base += kWarps * 64) {
      u64 a = base + lane < n ? keys[base + lane] : 0;
      u64 b = base + 32 + lane < n ? keys[base + 32 + lane] : 0;
      chunk_stages(a, b, lane, first);
      if (base + lane < n) keys[base + lane] = a;
      if (base + 32 + lane < n) keys[base + 32 + lane] = b;
    }
  };
  in_chunks(true);
  __syncthreads();
  for (int size = 128; size <= npow; size <<= 1) {
    const int half = size >> 1;
    for (int stride = half; stride >= 64; stride >>= 1) {
      for (int t = threadIdx.x; t < npow / 2; t += kThreads) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = stride == half ? lo ^ (size - 1) : lo + stride;  // mirrored first
        if (hi < n) {
          const u64 x = keys[lo], y = keys[hi];
          if (y > x) {
            keys[lo] = y;
            keys[hi] = x;
          }
        }
      }
      __syncthreads();
    }
    in_chunks(false);
    __syncthreads();
  }
}

// Grid (Q, C), clusters of (1, C, 1): block (q, r) owns probes r, r + C,
// r + 2C, .. of query q (at most ppb), so that the blocks of a cluster hold
// keys spread alike over the scores (the probes come nearest first).
template <int LOAD>
__global__ void __launch_bounds__(kThreads)
ivf_select_kernel(const float* __restrict__ q, const int8_t* __restrict__ codes,
                  const float* __restrict__ scales, const int* __restrict__ starts,
                  const int* __restrict__ lens, long long rows, int P, int d, int lpad, int S,
                  int ppb, float* __restrict__ out_s, int* __restrict__ out_r) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* keys = reinterpret_cast<u64*>(smem);
  unsigned* hist = reinterpret_cast<unsigned*>(smem + keys_bytes(ppb, lpad));  // (2, kBins)
  unsigned* tot = hist + 2 * kBins;                                          // (kBins,)
  float* s_q = reinterpret_cast<float*>(tot + kBins);
  int* s_pre = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(s_q) +
                                      r16((size_t)d * 4));  // (ppb + 1,)
  int* s_start = s_pre + ppb + 1;                           // (ppb,)
  Scalars* sc = reinterpret_cast<Scalars*>(reinterpret_cast<unsigned char*>(s_pre) +
                                           r16((size_t)(2 * ppb + 1) * 4));

  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.y, part = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long qi = blockIdx.x;
  const int np = P > part ? (P - part + C - 1) / C : 0;  // this block's probes
  auto csync = [&]() {
    if (C > 1) cluster.sync(); else __syncthreads();
  };

  // the query; the block's list starts and the prefix of its lengths
  for (int t = tid; t < d; t += kThreads) s_q[t] = q[qi * d + t];
  if (warp == 0) {
    int carry = 0;
    for (int base = 0; base < np; base += 32) {
      const int i = base + lane;
      int len = 0;
      if (i < np) {
        len = min(max(lens[qi * P + part + C * i], 0), lpad);
        s_start[i] = starts[qi * P + part + C * i];
      }
      int incl = len;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += v;
      }
      if (i < np) s_pre[i + 1] = carry + incl;
      carry += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) s_pre[0] = 0;
  }
  __syncthreads();

  // score the block's rows into keys[0, n), in (probe, offset) order
  const int n = s_pre[np];
  u64 kmax = 0, kmin = ~0ull;
  int count = 0;
  auto score_at = [&](int j, int i, bool ok, float dot, float scale) {  // position j, probe i
    u64 key = 0;
    if (ok) {
      key = make_key(__fmul_rn(dot, scale), (unsigned)((part + C * i) * lpad + j - s_pre[i]));
      kmax = max(kmax, key);
      kmin = min(kmin, key);
      ++count;
    }
    keys[j] = key;
  };
  // the row of position j, advancing the probe i (only moves forward)
  auto row_of = [&](int j, int& i) {
    while (s_pre[i + 1] <= j) ++i;
    return (long long)s_start[i] + (j - s_pre[i]);
  };
  if (held_units(LOAD) > 0) {
    // each thread's next row is loaded into registers while this one is scored
    constexpr int U = held_units(LOAD) > 0 ? held_units(LOAD) : 1;
    int i = 0;
    int4 cur[U];
    float cur_scale = 0.0f;
    bool cur_ok = false;
    int cur_i = 0;
    auto fetch = [&](int j, int4 (&v)[U], float& scale, bool& ok, int& pi) {
      const long long row = row_of(j, i);
      pi = i;
      ok = row >= 0 && row < rows;
      const int4* r4 = reinterpret_cast<const int4*>(codes + (ok ? row : 0) * d);
#pragma unroll
      for (int t = 0; t < U; ++t) v[t] = ok ? __ldg(r4 + t) : make_int4(0, 0, 0, 0);
      scale = ok ? __ldg(scales + row) : 0.0f;
    };
    if (tid < n) fetch(tid, cur, cur_scale, cur_ok, cur_i);
    for (int j = tid; j < n; j += kThreads) {
      int4 nxt[U];
      float nxt_scale = 0.0f;
      bool nxt_ok = false;
      int nxt_i = 0;
      if (j + kThreads < n) fetch(j + kThreads, nxt, nxt_scale, nxt_ok, nxt_i);
      score_at(j, cur_i, cur_ok, dot_units<U>(cur, s_q), cur_scale);
#pragma unroll
      for (int t = 0; t < U; ++t) cur[t] = nxt[t];
      cur_scale = nxt_scale;
      cur_ok = nxt_ok;
      cur_i = nxt_i;
    }
  } else {
    int i = 0;
    for (int j = tid; j < n; j += kThreads) {
      const long long row = row_of(j, i);
      const bool ok = row >= 0 && row < rows;
      const float scale = ok ? __ldg(scales + row) : 0.0f;
      score_at(j, i, ok, ok ? dot_row<false>(codes + row * d, s_q, d) : 0.0f, scale);
    }
  }
  // this block's largest and smallest key and its count, then the cluster's
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    kmax = max(kmax, __shfl_xor_sync(kFull, kmax, o));
    kmin = min(kmin, __shfl_xor_sync(kFull, kmin, o));
    count += __shfl_xor_sync(kFull, count, o);
  }
  u64* wred = reinterpret_cast<u64*>(tot);  // (kWarps, 2) + counts; free until the select
  if (lane == 0) {
    wred[warp * 2] = kmax;
    wred[warp * 2 + 1] = kmin;
    reinterpret_cast<int*>(wred + 2 * kWarps)[warp] = count;
  }
  __syncthreads();
  if (tid == 0) {
    u64 a = 0, b = ~0ull;
    int c = 0;
    for (int w = 0; w < kWarps; ++w) {
      a = max(a, wred[w * 2]);
      b = min(b, wred[w * 2 + 1]);
      c += reinterpret_cast<int*>(wred + 2 * kWarps)[w];
    }
    sc->kmax = a;
    sc->kmin = b;
    sc->count = c;
  }
  csync();
  u64 gmax = sc->kmax, gmin = sc->kmin;
  int total = sc->count;  // the query's non-empty keys
  if (C > 1) {
    gmax = 0;
    gmin = ~0ull;
    total = 0;
    for (int r = 0; r < C; ++r) {
      const Scalars* ps = cluster.map_shared_rank(sc, r);
      gmax = max(gmax, ps->kmax);
      gmin = min(gmin, ps->kmin);
      total += ps->count;
    }
  }

  // the threshold: every non-empty key at or above it is kept
  u64 thr = 1;
  int kept = total;
  if (total > S) {
    const int sortcap = S + (S >> 3) + 32;  // keys worth sorting rather than another pass
    u64 prefix = gmax & ~((2ull << (63 - __clzll(gmax ^ gmin))) - 1);  // bits all keys share
    int top = 63 - __clzll(gmax ^ gmin);  // the highest bit not yet resolved
    int need = S, above = 0;  // the rank sought among keys sharing `prefix`; keys above it
    for (int pass = 0;; ++pass) {
      unsigned* h = hist + (pass & 1) * kBins;
      const int shift = max(top - 7, 0);
      const u64 himask = ~((2ull << top) - 1);
      for (int b = tid; b < kBins; b += kThreads) h[b] = 0;
      __syncthreads();
      for (int j = tid; j < n; j += kThreads) {
        const u64 k = keys[j];
        if (k != 0 && ((k ^ prefix) & himask) == 0)
          atomicAdd(&h[(unsigned)(k >> shift) & (kBins - 1)], 1u);
      }
      csync();
      for (int b = tid; b < kBins; b += kThreads) {
        unsigned s = 0;
        if (C > 1) {
          for (int r = 0; r < C; ++r) s += cluster.map_shared_rank(h, r)[b];
        } else {
          s = h[b];
        }
        tot[b] = s;
      }
      __syncthreads();
      if (warp == 0) {  // lane l holds bins 255 - 8l .. 248 - 8l, the top bins first
        unsigned c[8], sum = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          c[k] = tot[kBins - 1 - 8 * lane - k];
          sum += c[k];
        }
        unsigned incl = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned v = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += v;
        }
        const unsigned excl = incl - sum;
        const unsigned hit = __ballot_sync(kFull, excl < (unsigned)need && incl >= (unsigned)need);
        if (lane == __ffs(hit) - 1) {
          unsigned cum = excl, inbin = 0;
          int kk = 8;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            if (kk < 8) continue;
            if (cum + c[k] >= (unsigned)need) {
              kk = k;
              inbin = c[k];
            } else {
              cum += c[k];
            }
          }
          sc->bin = kBins - 1 - 8 * lane - kk;
          sc->above = (int)cum;
          sc->inbin = (int)inbin;
        }
      }
      __syncthreads();
      const int bin = sc->bin;
      need -= sc->above;
      above += sc->above;
      prefix |= (u64)bin << shift;
      if (above + sc->inbin <= sortcap || shift == 0) {
        thr = prefix;
        kept = above + sc->inbin;
        break;
      }
      top = shift - 1;
    }
  }

  // keep the keys >= thr, packed in place at the front; a tile's keys are
  // read before any of its slots is written, and its writes land below the
  // next tile
  if (tid == 0) sc->nsel = 0;
  __syncthreads();
  constexpr int kPer = 8;
  for (int base = 0; base < n; base += kThreads * kPer) {
    u64 v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = base + k * kThreads + tid;
      v[k] = j < n ? keys[j] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const bool keep = v[k] >= thr;  // thr >= 1: empty slots are never kept
      const unsigned m = __ballot_sync(kFull, keep);
      int slot = 0;
      if (lane == 0 && m) slot = atomicAdd(&sc->nsel, __popc(m));
      slot = __shfl_sync(kFull, slot, 0);
      if (keep) keys[slot + __popc(m & ((1u << lane) - 1u))] = v[k];
    }
    __syncthreads();
  }
  const int nsel = sc->nsel;
  sort_desc(keys, nsel);

  // write: a key's slot is its index plus each peer's kept keys above it
  const long long orow = qi * (long long)S;
  auto put = [&](int slot, u64 key) {
    const unsigned flat = ~(unsigned)(key & 0xffffffffull);
    const int p = (int)(flat / (unsigned)lpad);
    out_s[orow + slot] = from_order_bits((unsigned)(key >> 32));
    out_r[orow + slot] = starts[qi * P + p] + (int)(flat - (unsigned)p * lpad);
  };
  if (C == 1) {
    for (int j = tid; j < min(nsel, S); j += kThreads) put(j, keys[j]);
  } else {
    // a kept key's slot: its index plus each peer's kept keys above it. A
    // peer's sorted keys come over in chunks of kRankChunk (coalesced remote
    // reads); each chunk is merged with this block's sorted keys by merge
    // path, every thread walking an equal share of the merged order, and a
    // key of ours that the walk passes gains the chunk's keys above it.
    int* s_rank = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(sc) + 64);
    u64* s_chunk = reinterpret_cast<u64*>(reinterpret_cast<unsigned char*>(s_rank) +
                                          r16((size_t)keep_cap(ppb, lpad, S) * 4));
    for (int i = tid; i < nsel; i += kThreads) s_rank[i] = 0;
    csync();  // every block's keys sorted
    for (int r = 0; r < C; ++r) {
      if (r == part) continue;
      const u64* pk = cluster.map_shared_rank(keys, r);
      const int pn = cluster.map_shared_rank(sc, r)->nsel;
      for (int c0 = 0; c0 < pn; c0 += kRankChunk) {
        const int nb = min(kRankChunk, pn - c0);
        for (int t = tid; t < nb; t += kThreads) s_chunk[t] = pk[c0 + t];
        __syncthreads();
        const int per = (nsel + nb + kThreads - 1) / kThreads;
        const int k0 = min(nsel + nb, tid * per), k1 = min(nsel + nb, k0 + per);
        if (k0 < k1) {
          int lo = max(0, k0 - nb), hi = min(k0, nsel);  // our keys among the first k0
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (keys[mid] > s_chunk[k0 - 1 - mid]) lo = mid + 1; else hi = mid;
          }
          int ia = lo, ib = k0 - lo;
          for (int k = k0; k < k1; ++k) {
            if (ib >= nb || (ia < nsel && keys[ia] > s_chunk[ib])) {
              s_rank[ia] += ib;  // the chunk's keys above ours
              ++ia;
            } else {
              ++ib;
            }
          }
        }
        __syncthreads();  // the chunk is read before the next one lands
      }
    }
    for (int i = tid; i < nsel; i += kThreads) {
      const int slot = i + s_rank[i];
      if (slot < S) put(slot, keys[i]);
    }
  }
  // the slots no candidate fills, shared by the cluster's blocks
  for (int j = min(kept, S) + part * kThreads + tid; j < S; j += C * kThreads) {
    out_s[orow + j] = -INFINITY;
    out_r[orow + j] = -1;
  }
  if (C > 1) cluster.sync();  // no block leaves while a peer may still read its keys
}

// ------------------------------------------------------------ global path
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
__device__ void merge_desc(const u64* a, int na, const u64* b, int nb, u64* out, int m) {
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

__global__ void __launch_bounds__(kThreads)
ivf_global_kernel(const float* __restrict__ q, const int8_t* __restrict__ codes,
                  const float* __restrict__ scales, const int* __restrict__ starts,
                  const int* __restrict__ lens, long long rows, int P, int d, int lpad, int S,
                  int vec, u64* __restrict__ ws_a, u64* __restrict__ ws_b,
                  float* __restrict__ out_s, int* __restrict__ out_r) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* s_key = reinterpret_cast<u64*>(smem);              // (kChunk,)
  float* s_q = reinterpret_cast<float*>(s_key + kChunk);  // (d,)

  const int tid = threadIdx.x;
  const long long qi = blockIdx.x;
  for (int t = tid; t < d; t += kThreads) s_q[t] = q[qi * d + t];
  u64* cur = ws_a + qi * S;
  u64* nxt = ws_b + qi * S;
  int count = 0;  // keys in the running list, the same in every thread
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
          const float dot = vec ? dot_row<true>(codes + row * d, s_q, d)
                                : dot_row<false>(codes + row * d, s_q, d);
          const float score = __fmul_rn(dot, scales[row]);
          key = make_key(score, (unsigned)(p * lpad + c0 + j));
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

// ------------------------------------------------------------ launches
int load_mode(const int8_t* codes, int d) {
  if ((reinterpret_cast<uintptr_t>(codes) & 15) != 0) return kBytes;
  return d == 32 ? kPre2 : d == 64 ? kPre4 : kBytes;
}

template <int LOAD>
cudaError_t set_select_smem(size_t smem) {
  return cudaFuncSetAttribute(ivf_select_kernel<LOAD>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

cudaLaunchConfig_t select_config(int nq, int cluster, size_t smem, cudaStream_t st,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nq, cluster, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int LOAD>
int launch_select(const float* q, const int8_t* codes, const float* scales, const int* starts,
                  const int* lens, float* out_s, int* out_r, int nq, int P, int d, int lpad,
                  int S, long long rows, int cluster, cudaStream_t st) {
  const int ppb = (P + cluster - 1) / cluster;
  const size_t smem = shared_bytes(ppb, lpad, d, cluster, S);
  cudaError_t err = set_select_smem<LOAD>(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = select_config(nq, cluster, smem, st, attr);
  err = cudaLaunchKernelEx(&cfg, ivf_select_kernel<LOAD>, q, codes, scales, starts, lens, rows,
                           P, d, lpad, S, ppb, out_s, out_r);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int launch_global(const float* q, const int8_t* codes, const float* scales, const int* starts,
                  const int* lens, void* ws, float* out_s, int* out_r, int nq, int P, int d,
                  int lpad, int S, long long rows, int vec, cudaStream_t st) {
  const size_t smem = sizeof(u64) * kChunk + sizeof(float) * (size_t)d;
  cudaError_t err = cudaFuncSetAttribute(
      ivf_global_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  u64* ws_a = static_cast<u64*>(ws);
  u64* ws_b = ws_a + (size_t)nq * S;
  ivf_global_kernel<<<nq, kThreads, smem, st>>>(q, codes, scales, starts, lens, rows, P, d, lpad,
                                                S, vec, ws_a, ws_b, out_s, out_r);
  return (int)cudaGetLastError();
}

int global_attrs(int d, int* out) {
  const size_t smem = sizeof(u64) * kChunk + sizeof(float) * (size_t)d;
  cudaError_t err = cudaFuncSetAttribute(
      ivf_global_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, (const void*)ivf_global_kernel);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ivf_global_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem;
  out[3] = per_sm;
  out[4] = 0;
  return 0;
}

template <int LOAD>
int select_attrs(int cluster, size_t smem, int* out) {
  cudaError_t err = set_select_smem<LOAD>(smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, (const void*)ivf_select_kernel<LOAD>);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, clusters = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ivf_select_kernel<LOAD>, kThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = select_config(1, cluster, smem, 0, attr);
  err = cudaOccupancyMaxActiveClusters(&clusters, ivf_select_kernel<LOAD>, &cfg);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem;
  out[3] = per_sm;
  out[4] = clusters;
  return 0;
}

}  // namespace

// q: (nq, d) f32; codes: (rows, d) int8; scales: (rows,) f32; starts and
// lens: (nq, P) int32; out_s, out_r: (nq, S). cluster: the plan's blocks a
// query (1 .. 8, the shared path) or 0 (the global path, whose (2, nq, S)
// 64-bit workspace is ws; the shared path reads no ws). Returns
// cudaGetLastError() after the launch; the caller raises on anything but 0.
extern "C" int g4r_ivf_list_topk_i8(const float* q, const int8_t* codes, const float* scales,
                                    const int* starts, const int* lens, void* ws, float* out_s,
                                    int* out_r, int nq, int P, int d, int lpad, int S,
                                    long long rows, int cluster, void* stream) {
  if (nq < 1 || P < 1 || d < 1 || lpad < 1 || S < 1 || cluster < 0 || cluster > kMaxCluster ||
      cluster > P || (long long)P * lpad > 0x7fffffffLL || S > P * lpad ||
      (cluster == 0 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int load = load_mode(codes, d);
  if (cluster == 0)
    return launch_global(q, codes, scales, starts, lens, ws, out_s, out_r, nq, P, d, lpad, S,
                         rows, (d & 15) == 0 && (reinterpret_cast<uintptr_t>(codes) & 15) == 0,
                         st);
  switch (load) {
    case kPre2:
      return launch_select<kPre2>(q, codes, scales, starts, lens, out_s, out_r, nq, P, d, lpad,
                                  S, rows, cluster, st);
    case kPre4:
      return launch_select<kPre4>(q, codes, scales, starts, lens, out_s, out_r, nq, P, d, lpad,
                                  S, rows, cluster, st);
    default:
      return launch_select<kBytes>(q, codes, scales, starts, lens, out_s, out_r, nq, P, d, lpad,
                                   S, rows, cluster, st);
  }
}

// The shared path's instantiation for load mode `load` (0 byte loads, 1 and 2
// rows held in registers at d 32 and 64) with
// blocks of ppb probes of lpad rows and a shortlist of S
// at width d, in clusters of `cluster`, or the global path's kernel at
// width d for cluster 0: out[0..4] = registers a thread, local memory bytes
// (spills and stack), dynamic shared memory bytes, resident blocks an SM,
// and resident clusters on the card (0 for the global path).
extern "C" int g4r_ivf_attrs(int load, int cluster, int ppb, int lpad, int d, int S, int* out) {
  if (load < kBytes || load > kPre4 || cluster < 0 || cluster > kMaxCluster || ppb < 1 ||
      lpad < 1 || d < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  if (cluster == 0) return global_attrs(d, out);
  const size_t smem = shared_bytes(ppb, lpad, d, cluster, S);
  switch (load) {
    case kPre2: return select_attrs<kPre2>(cluster, smem, out);
    case kPre4: return select_attrs<kPre4>(cluster, smem, out);
    default: return select_attrs<kBytes>(cluster, smem, out);
  }
}
