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
// scores); the U2I call (512 x 20,000 x 64) is 1.31 GFLOP, 19.6 us at
// 67 TFLOP/s, while its inputs are 5.2 MB, 1.6 us at 3.35 TB/s. A block
// reads its split of the table once per query tile, so the table crosses
// L2 Q / kTQ times (328 MB for the U2I call). In practice the selection,
// not the product, sets the time (PERF.md section 6, PR 17).
//
// How the design answers it (one launch per call):
//   - Fill the card. A block owns kTQ = 8 queries and one contiguous split
//     of the items; the splits of a query tile are one thread-block cluster
//     of at most 8 blocks, launched with cudaLaunchKernelEx. The wrapper's
//     plan (kernels/topk.py:plan_splits) takes the most splits whose
//     clusters all fit the card at once, and at least two blocks an SM. A
//     block is 96 threads and ~52 KB of shared memory at k <= 128: four fit
//     an SM.
//   - Stage by asynchronous copies. Warp 2 is the producer: it fills a ring
//     of kStages tiles (the 8 query rows and kCH = 128 item rows, each a
//     32-float slice of d) with cp.async 16-byte copies (4-byte ones where
//     d % 4 != 0 or a row is not 16-byte aligned), each lane arriving on the
//     tile's `full` mbarrier when its copies land; the two consumer warps
//     release a tile on its `empty` mbarrier, so the next tile's copies
//     overlap this one's product and selection. The 128-byte rows are
//     XOR-swizzled (16-byte unit j of row r at j ^ (r & 7)), not padded: a
//     warp's float4 reads of 32 consecutive rows then hit distinct banks,
//     and padding would cost 1/9 of the ring, which decides whether four
//     blocks fit an SM.
//   - The product: each consumer lane holds 8 queries x 2 items of
//     accumulators, reads its two item rows as float4 and the queries as
//     warp broadcasts, and sums over d in order with fmaf, so a score does
//     not depend on the launch shape.
//   - Select from registers, with no block barrier per chunk. At a chunk's
//     end each lane compares its scores with its queries' thresholds (read
//     once a chunk from shared memory) and a ballot per query gives each
//     survivor its slot in the warp's own buffer for the query. A buffer
//     the next 32 items could overflow is flushed: entries below the
//     threshold as it stands now, or in the query's sorted exclusion row
//     (staged in shared memory up to kExCap entries, else read from device
//     memory; binary search), are dropped; if more than 32 remain they are
//     sorted in registers (bitonic, on 64-bit keys: score desc, id asc, a
//     total order) and merged into the query's list under a per-query lock
//     (the first become the list). The filter keeps scores >= the threshold,
//     so an item that ties it reaches the sort whatever the order of the
//     warps' merges: the result is the top k of a total order, bitwise the
//     same from run to run.
//   - The threshold is the larger of two lower bounds of the query's final
//     k-th score: its list's k-th score, and the least, over the cluster,
//     of each block's ceil(k / splits)-th listed score (the blocks hold that
//     many distinct non-excluded items each). The producer reads the
//     cluster's scores through distributed shared memory after each tile.
//   - Merge the splits inside the kernel. After cluster.sync(), a tree of
//     rounds merges the lists through distributed shared memory (block r
//     takes block r + h's lists: an elementwise max against the reversed
//     peer list, then a bitonic merge), and block 0 writes (Q, k) once. A
//     split with no items keeps its filler list.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTQ = 8;          // queries per block
constexpr int kCH = 128;        // items per chunk
constexpr int kDT = 32;         // floats of d per staged tile (one 128-byte row)
constexpr int kU = kDT / 4;     // 16-byte units a row
constexpr int kNC = 2;          // consumer warps; warp kNC is the producer
constexpr int kWarps = kNC + 1;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;      // tiles in the ring
constexpr int kRows = kTQ + kCH;  // rows of a staged tile: queries, then items
constexpr int kRowBytes = kDT * 4;
constexpr int kTileBytes = kRows * kRowBytes;
constexpr int kBufW = 64;       // a warp's buffer per query
constexpr int kExCap = 32;      // exclusion entries per query staged in shared memory
constexpr int kMaxK = 256;      // = kernels/topk.py:MAX_K
constexpr int kMaxCluster = 8;  // = kernels/topk.py:MAX_CLUSTER (the portable size)
constexpr unsigned kFull = 0xffffffffu;

static_assert(kCH == 64 * kNC, "a consumer lane scores two items of a chunk");
static_assert(kTQ == 8, "a tile's query rows are one swizzle period; 4 lanes a query pair");
static_assert(kU == 8, "a row fills the 32 banks");

// the swizzle phase of stage row r: its 16-byte unit j lies at j ^ swz(r), so
// that the same unit of 8 consecutive rows hits 8 distinct bank groups
__device__ __forceinline__ int swz(int r) { return r & 7; }

template <int KP>
constexpr size_t smem_bytes() {
  return (size_t)kStages * kTileBytes + (size_t)kTQ * KP * 8 + (size_t)kNC * kTQ * kBufW * 8 +
         2 * kStages * 8 + (size_t)kTQ * kExCap * 4 + 4 * kTQ * 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one of the barrier's expected arrivals, made when this thread's earlier
// cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}

// 16 bytes (src_bytes of them read, the rest zero-filled)
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

// A spin lock in shared memory, with acquire and release semantics at the
// block's scope (lighter than a sequentially consistent fence).
__device__ __forceinline__ void lock_acquire(int* lock) {
  const uint32_t addr = smem_addr(lock);
  uint32_t old;
  do {
    asm volatile("atom.acquire.cta.shared::cta.cas.b32 %0, [%1], 0, 1;"
                 : "=r"(old)
                 : "r"(addr)
                 : "memory");
  } while (old != 0);
}

__device__ __forceinline__ void lock_release(int* lock) {
  asm volatile("st.release.cta.shared::cta.b32 [%0], 0;" ::"r"(smem_addr(lock)) : "memory");
}

// (score desc, id asc) as one unsigned key, larger is better; 0 is the
// filler (-inf, -1), below every real entry. -0 scores as +0.
__device__ __forceinline__ uint64_t make_key(float s, int id) {
  uint32_t b = __float_as_uint(s);
  if (b == 0x80000000u) b = 0u;
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((uint64_t)b << 32) | (uint32_t)(~id);
}

__device__ __forceinline__ float key_score(uint64_t key) {
  if (key == 0) return -INFINITY;
  const uint32_t b = (uint32_t)(key >> 32);
  return __uint_as_float((b & 0x80000000u) ? (b & 0x7fffffffu) : ~b);
}

__device__ __forceinline__ int key_id(uint64_t key) {
  return key == 0 ? -1 : (int)~(uint32_t)key;
}

// v or o: the larger if keep_max, else the smaller (one 64-bit compare)
__device__ __forceinline__ uint64_t pick(uint64_t v, uint64_t o, bool keep_max) {
  return (o > v) == keep_max ? o : v;
}

// (a, b) <- (max, min) of the pair
__device__ __forceinline__ void order(uint64_t& a, uint64_t& b) {
  const bool swap = b > a;
  const uint64_t hi = swap ? b : a, lo = swap ? a : b;
  a = hi;
  b = lo;
}

__device__ __forceinline__ bool excluded(const int* row, int e, int id) {
  int lo = 0, hi = e;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row[mid] < id) lo = mid + 1; else hi = mid;
  }
  return lo < e && row[lo] == id;
}

// Sorts the bitonic sequence v (element s * 32 + lane in v[s]) best first.
template <int S>
__device__ __forceinline__ void bitonic_merge(uint64_t (&v)[S], int lane) {
#pragma unroll
  for (int ss = S / 2; ss > 0; ss >>= 1) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if ((s & ss) == 0) order(v[s], v[s + ss]);
    }
  }
#pragma unroll
  for (int st = 16; st > 0; st >>= 1) {
    const bool lower = (lane & st) == 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      v[s] = pick(v[s], __shfl_xor_sync(kFull, v[s], st), lower);
    }
  }
}

// Merges the sorted list `other` (read back to front) into the sorted list
// `lst`, both KP keys: lst keeps the KP best of the two.
template <int KP>
__device__ __forceinline__ void merge_lists(uint64_t* lst, const uint64_t* other, int other_len,
                                            int lane) {
  constexpr int S = KP / 32;
  uint64_t v[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int i = s * 32 + lane, j = KP - 1 - i;
    v[s] = pick(lst[i], j < other_len ? other[j] : 0, true);
  }
  bitonic_merge<S>(v, lane);
#pragma unroll
  for (int s = 0; s < S; ++s) lst[s * 32 + lane] = v[s];
  __syncwarp();
}

// A warp flushes its buffer `buf` (n <= kBufW keys) for one query: entries
// below `floor` (the query's threshold now) or in its sorted exclusion row
// `ex` (e ids) are dropped; if more than
// kBufW - 32 remain, they are sorted in registers and merged into the
// query's list under its lock, and the list's k-th and kq-th scores become
// the query's threshold and its published score. Returns the entries left.
template <int KP>
__device__ __forceinline__ int flush_buffer(uint64_t* buf, int n, float floor, const int* ex,
                                            int e, int keep, uint64_t* lst, int k, int kq,
                                            float* thr, float* pub, int* lock, int lane) {
  uint64_t a = lane < n ? buf[lane] : 0, b = lane + 32 < n ? buf[lane + 32] : 0;
  if (a != 0 && (key_score(a) < floor || (e > 0 && excluded(ex, e, key_id(a))))) a = 0;
  if (b != 0 && (key_score(b) < floor || (e > 0 && excluded(ex, e, key_id(b))))) b = 0;
  const unsigned ma = __ballot_sync(kFull, a != 0), mb = __ballot_sync(kFull, b != 0);
  const int left = __popc(ma) + __popc(mb);
  if (left <= keep) {  // compact and keep buffering
    const unsigned below = (1u << lane) - 1u;
    __syncwarp();
    if (a != 0) buf[__popc(ma & below)] = a;
    if (b != 0) buf[__popc(ma) + __popc(mb & below)] = b;
    __syncwarp();
    return left;
  }
  // sort best first: element lane in a, lane + 32 in b (dropped entries are 0)
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll
    for (int st = size >> 1; st > 0; st >>= 1) {
      if (st == 32) {
        order(a, b);
      } else {
        const bool lower = (lane & st) == 0;
        const uint64_t oa = __shfl_xor_sync(kFull, a, st), ob = __shfl_xor_sync(kFull, b, st);
        a = pick(a, oa, lower == ((lane & size) == 0));
        b = pick(b, ob, lower == (((lane + 32) & size) == 0));
      }
    }
  }
  __syncwarp();
  buf[lane] = a;
  buf[lane + 32] = b;
  __syncwarp();
  if (lane == 0) lock_acquire(lock);
  __syncwarp();
  const bool first = lst[0] == 0;
  __syncwarp();
  if (first) {  // the query's first entries: the sorted buffer is the list
    lst[lane] = a;
    if (KP > 32) lst[lane + 32] = b;
    __syncwarp();
  } else {
    merge_lists<KP>(lst, buf, kBufW, lane);
  }
  if (lane == 0) {
    *reinterpret_cast<volatile float*>(thr) = key_score(lst[k - 1]);
    *reinterpret_cast<volatile float*>(pub) = key_score(lst[kq - 1]);
    lock_release(lock);
  }
  __syncwarp();
  return 0;
}

template <int KP>
__global__ void __launch_bounds__(kThreads, 4)
topk_kernel(const float* __restrict__ q, const float* __restrict__ items,
            const int* __restrict__ excl, int e, int nq, int ni, int d, int k, int split_len,
            int vec, float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* list = reinterpret_cast<uint64_t*>(smem + kStages * kTileBytes);  // (kTQ, KP)
  uint64_t* wbuf = list + kTQ * KP;                   // (kNC, kTQ, kBufW)
  uint64_t* bars = wbuf + kNC * kTQ * kBufW;          // full[kStages], empty[kStages]
  int* ex_s = reinterpret_cast<int*>(bars + 2 * kStages);  // (kTQ, kExCap)
  float* thr_s = reinterpret_cast<float*>(ex_s + kTQ * kExCap);  // the lists' k-th scores
  float* pub_s = thr_s + kTQ;  // the lists' kq-th scores, read by the cluster
  float* cthr_s = pub_s + kTQ;  // the least of the cluster's pub_s
  int* lock_s = reinterpret_cast<int*>(cthr_s + kTQ);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kTQ;
  const int split = blockIdx.y, nsplit = gridDim.y;  // the cluster spans the splits
  const int kq = (k + nsplit - 1) / nsplit;
  const int start = (int)min((long long)split * split_len, (long long)ni);
  const int n_in = (int)min((long long)split_len, (long long)ni - start);  // items in the split
  const int nch = (n_in + kCH - 1) / kCH;
  const uint32_t ring = smem_addr(smem), full0 = smem_addr(bars), empty0 = full0 + 8 * kStages;
  cg::cluster_group cluster = cg::this_cluster();

  for (int j = tid; j < kTQ * KP; j += kThreads) list[j] = 0;
  if (tid < kTQ) {
    thr_s[tid] = pub_s[tid] = cthr_s[tid] = -INFINITY;
    lock_s[tid] = 0;
  }
  if (e <= kExCap) {
    for (int r = 0; r < kTQ; ++r)
      for (int c = tid; c < e; c += kThreads)
        ex_s[r * kExCap + c] = q0 + r < nq ? excl[(long long)(q0 + r) * e + c] : -1;
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 32);
      mbar_init(empty0 + 8 * s, kNC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (nsplit > 1) cluster.sync(); else __syncthreads();  // peers read pub_s from here on

  if (warp == kNC) {
    // producer: lane copies 16-byte unit j = lane % kU of rows lane / kU,
    // + 32 / kU, ... of each tile; tile t is d-slice t % ndt of chunk t / ndt
    constexpr int kStep = 32 / kU;  // rows a pass
    const int j = lane & (kU - 1), rl = lane / kU;
    // after each tile, the least of the scores block lane & 7 published for
    // queries lane >> 3 and 4 + (lane >> 3) into cthr_s
    const int peer = lane & 7, pq = lane >> 3;
    const volatile float* pub_peer =
        nsplit > 1 && peer < nsplit ? cluster.map_shared_rank(pub_s, peer) : nullptr;
    int stage = 0, phase = 0, t = 0;
    for (int base = 0; base < n_in; base += kCH) {
      for (int k0 = 0; k0 < d; k0 += kDT, ++t) {
        if (t >= kStages) mbar_wait(empty0 + 8 * stage, phase ^ 1);
        const uint32_t tile = ring + stage * kTileBytes;
        const int col = k0 + 4 * j, nd = max(0, min(4, d - col));
        for (int r = rl; r < kTQ; r += kStep) {
          const int nv = q0 + r < nq ? nd : 0;
          const float* src = q + (long long)(q0 + r) * d + col;
          const uint32_t dst = tile + r * kRowBytes + ((j ^ swz(r)) << 4);
          if (vec) {
            cp_async16(dst, nv ? src : items, 4u * nv);
          } else {
#pragma unroll
            for (int m = 0; m < 4; ++m) cp_async4(dst + 4 * m, m < nv ? src + m : items, m < nv ? 4u : 0u);
          }
        }
        const float* src = items + ((long long)start + base + rl) * d + col;
        uint32_t dst = tile + (kTQ + rl) * kRowBytes;
        const long long step = (long long)kStep * d;
        if (vec) {
#pragma unroll 4
          for (int i = 0; i < kCH / kStep; ++i, src += step, dst += kStep * kRowBytes) {
            const int nv = base + rl + kStep * i < n_in ? nd : 0;
            cp_async16(dst + ((j ^ swz(kTQ + rl + kStep * i)) << 4), nv ? src : items, 4u * nv);
          }
        } else {
          for (int i = 0; i < kCH / kStep; ++i, src += step, dst += kStep * kRowBytes) {
            const int nv = base + rl + kStep * i < n_in ? nd : 0;
            const uint32_t dd = dst + ((j ^ swz(kTQ + rl + kStep * i)) << 4);
#pragma unroll
            for (int m = 0; m < 4; ++m) cp_async4(dd + 4 * m, m < nv ? src + m : items, m < nv ? 4u : 0u);
          }
        }
        cp_async_arrive(full0 + 8 * stage);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
        if (nsplit > 1) {
          float lo = pub_peer ? pub_peer[pq] : INFINITY, hi = pub_peer ? pub_peer[pq + 4] : INFINITY;
#pragma unroll
          for (int o = 1; o < 8; o <<= 1) {
            lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
            hi = fminf(hi, __shfl_xor_sync(kFull, hi, o));
          }
          if (peer == 0) {
            reinterpret_cast<volatile float*>(cthr_s)[pq] = lo;
            reinterpret_cast<volatile float*>(cthr_s)[pq + 4] = hi;
          }
        }
      }
    }
  } else {
    // consumers: lane scores items w*64 + lane and w*64 + 32 + lane of each
    // chunk (stage rows kTQ + ..., swizzle phase swz(lane)) for all kTQ queries
    uint64_t* mybuf = wbuf + warp * kTQ * kBufW;
    int cnt[kTQ];  // the entries in this warp's buffer for each query
#pragma unroll
    for (int r = 0; r < kTQ; ++r) cnt[r] = 0;
    const unsigned live = nq - q0 >= kTQ ? (1u << kTQ) - 1u : (1u << (nq - q0)) - 1u;
    const int row0 = (kTQ + warp * 64 + lane) * kRowBytes, row1 = row0 + 32 * kRowBytes;
    const int sw = swz(lane);
    int stage = 0, phase = 0;
    for (int c = 0; c < nch; ++c) {
      // the chunk's thresholds: max(own k-th score, min over the cluster of
      // the kq-th scores). Each is a lower bound of the query's k-th score
      // over all items: k listed items score at least the first, and the
      // cluster's blocks hold kq * nsplit >= k distinct items scoring at
      // least the second.
      float thr[kTQ], acc[kTQ][2];
#pragma unroll
      for (int r = 0; r < kTQ; ++r) {
        thr[r] = fmaxf(reinterpret_cast<volatile float*>(thr_s)[r],
                       reinterpret_cast<volatile float*>(cthr_s)[r]);
        acc[r][0] = acc[r][1] = 0.0f;
      }
      for (int k0 = 0; k0 < d; k0 += kDT) {
        mbar_wait(full0 + 8 * stage, phase);
        const unsigned char* tile = smem + stage * kTileBytes;
#pragma unroll
        for (int j = 0; j < kU; ++j) {
          const float4 x0 = *reinterpret_cast<const float4*>(tile + row0 + ((j ^ sw) << 4));
          const float4 x1 = *reinterpret_cast<const float4*>(tile + row1 + ((j ^ sw) << 4));
#pragma unroll
          for (int r = 0; r < kTQ; ++r) {
            const float4 a =
                *reinterpret_cast<const float4*>(tile + r * kRowBytes + ((j ^ swz(r)) << 4));
            acc[r][0] = fmaf(a.x, x0.x, acc[r][0]);
            acc[r][0] = fmaf(a.y, x0.y, acc[r][0]);
            acc[r][0] = fmaf(a.z, x0.z, acc[r][0]);
            acc[r][0] = fmaf(a.w, x0.w, acc[r][0]);
            acc[r][1] = fmaf(a.x, x1.x, acc[r][1]);
            acc[r][1] = fmaf(a.y, x1.y, acc[r][1]);
            acc[r][1] = fmaf(a.z, x1.z, acc[r][1]);
            acc[r][1] = fmaf(a.w, x1.w, acc[r][1]);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * stage);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }

      // select: an item that reaches a query's threshold takes the next
      // slot of the warp's buffer for the query (a ballot numbers them);
      // exclusions are checked when the buffer is flushed
#pragma unroll 1
      for (int b = 0; b < 2; ++b) {  // items w*64 + lane, then + 32
        const int rel = c * kCH + warp * 64 + 32 * b + lane, id = start + rel;
        unsigned pm = 0;  // bit r: the item reaches query r's threshold
#pragma unroll
        for (int r = 0; r < kTQ; ++r)
          if ((b ? acc[r][1] : acc[r][0]) >= thr[r]) pm |= 1u << r;
        pm = rel < n_in ? pm & live : 0u;
        if (__any_sync(kFull, pm != 0)) {
#pragma unroll
          for (int r = 0; r < kTQ; ++r) {
            const bool pass = (pm >> r) & 1u;
            const unsigned m = __ballot_sync(kFull, pass);
            if (pass)
              mybuf[r * kBufW + cnt[r] + __popc(m & ((1u << lane) - 1u))] =
                  make_key(b ? acc[r][1] : acc[r][0], id);
            cnt[r] += __popc(m);
          }
        }
        // flush the buffers the next 32 items could overflow; all of them
        // after the split's last items
        const int keep = b == 1 && c == nch - 1 ? 0 : kBufW - 32;
        unsigned need = 0;
#pragma unroll
        for (int r = 0; r < kTQ; ++r)
          if (cnt[r] > keep) need |= 1u << r;
        if (need) {
          __syncwarp();
#pragma unroll 1
          for (int i = 0; i < kTQ; ++i) {
            const int r = (i + warp * (kTQ / 2)) & (kTQ - 1);  // the warps start apart
            if (!((need >> r) & 1u)) continue;
            int n = 0;
#pragma unroll
            for (int rr = 0; rr < kTQ; ++rr)
              if (rr == r) n = cnt[rr];
            const float floor = fmaxf(reinterpret_cast<volatile float*>(thr_s)[r],
                                      reinterpret_cast<volatile float*>(cthr_s)[r]);
            const int* ex = e <= kExCap ? ex_s + r * kExCap : excl + (long long)(q0 + r) * e;
            n = flush_buffer<KP>(mybuf + r * kBufW, n, floor, ex, e, keep, list + r * KP, k, kq,
                                 thr_s + r, pub_s + r, lock_s + r, lane);
#pragma unroll
            for (int rr = 0; rr < kTQ; ++rr)
              if (rr == r) cnt[rr] = n;
          }
        }
      }
    }
  }
  __syncthreads();

  // the cluster's splits: block r takes block r + h's lists, h = 1, 2, 4
  if (nsplit > 1) {
    for (int h = 1; h < nsplit; h <<= 1) {
      cluster.sync();
      if ((split & (2 * h - 1)) == 0 && split + h < nsplit) {
        const uint64_t* peer = cluster.map_shared_rank(list, split + h);
        for (int r = warp; r < kTQ; r += kWarps)
          merge_lists<KP>(list + r * KP, peer + r * KP, KP, lane);
      }
    }
    cluster.sync();  // no block leaves while a peer may still read its lists
  }
  if (split == 0) {
    for (int r = warp; r < kTQ; r += kWarps) {
      if (q0 + r >= nq) continue;
      const long long row = (long long)(q0 + r) * k;
      for (int j = lane; j < k; j += 32) {
        const uint64_t key = list[r * KP + j];
        out_s[row + j] = key_score(key);
        out_i[row + j] = key_id(key);
      }
    }
  }
}

template <int KP>
int launch(const float* q, const float* items, const int* excl, int e, float* out_s,
           int* out_i, int nq, int ni, int d, int k, int splits, int split_len,
           cudaStream_t st) {
  const size_t smem = smem_bytes<KP>();
  cudaError_t err = cudaFuncSetAttribute(
      topk_kernel<KP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = d % 4 == 0 && (uintptr_t)q % 16 == 0 && (uintptr_t)items % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((nq + kTQ - 1) / kTQ, splits, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, topk_kernel<KP>, q, items, excl, e, nq, ni, d, k, split_len,
                           vec, out_s, out_i);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int KP>
int attrs_of(int splits, int* out) {
  const size_t smem = smem_bytes<KP>();
  cudaError_t err = cudaFuncSetAttribute(
      topk_kernel<KP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, (const void*)topk_kernel<KP>);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, clusters = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, topk_kernel<KP>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, splits, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(&clusters, topk_kernel<KP>, &cfg);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem;
  out[3] = per_sm;
  out[4] = clusters;
  return 0;
}

}  // namespace

// excl: (nq, e) int32, each row sorted ascending (-1 slots first); e may be
// 0. The plan: `splits` contiguous item splits of `split_len` items (a
// multiple of 128), one cluster of `splits` blocks per 8 queries. Returns
// cudaGetLastError() after the launch; the caller raises on anything but 0.
extern "C" int g4r_topk_f32(const float* q, const float* items, const int* excl, int e,
                            float* out_s, int* out_i, int nq, int ni, int d, int k, int splits,
                            int split_len, void* stream) {
  if (k < 1 || k > kMaxK || k > ni || nq < 1 || d < 1 || e < 0 || splits < 1 ||
      splits > kMaxCluster || split_len < 1 || split_len % kCH != 0 ||
      (long long)splits * split_len < ni)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (k <= 32) return launch<32>(q, items, excl, e, out_s, out_i, nq, ni, d, k, splits, split_len, st);
  if (k <= 64) return launch<64>(q, items, excl, e, out_s, out_i, nq, ni, d, k, splits, split_len, st);
  if (k <= 128) return launch<128>(q, items, excl, e, out_s, out_i, nq, ni, d, k, splits, split_len, st);
  return launch<256>(q, items, excl, e, out_s, out_i, nq, ni, d, k, splits, split_len, st);
}

// The kernel instantiation for k: out[0..4] = registers a thread, local
// memory bytes (spills and stack), dynamic shared memory bytes, resident
// blocks an SM, and resident clusters of `splits` blocks on the card.
extern "C" int g4r_topk_attrs(int k, int splits, int* out) {
  if (k < 1 || k > kMaxK || splits < 1 || splits > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  if (k <= 32) return attrs_of<32>(splits, out);
  if (k <= 64) return attrs_of<64>(splits, out);
  if (k <= 128) return attrs_of<128>(splits, out);
  return attrs_of<256>(splits, out);
}
