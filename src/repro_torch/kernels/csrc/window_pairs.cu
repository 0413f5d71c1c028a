// The fused sampler's pair stage, for Hopper (sm_90a): the skip-gram window
// gather and, in one launch, the uniform draw of the batch's pairs from it.
//
// Replaces the TPU kernel repro/kernels/window_pairs.py:window_pair_ids_pallas
// (pallas_call at :55) twice over:
//   - g4r_window_pairs_i32 is its counterpart as it stands: walks paths (B, L)
//     int32 and a static table of npos (src_col, dst_col) positions give
//         src[b, p] = paths[b, pos[p, 0]],  dst[b, p] = paths[b, pos[p, 1]]
//     with BOTH set to PAD (-1) wherever either endpoint is PAD. It serves
//     the dispatcher's window_pair_ids, repro's public name.
//   - g4r_window_pair_draw_i64 computes that gather and the whole stage that
//     repro/sampling/fused.py builds around it (:340-396): the valid count,
//     then P draws by inverse CDF, r = sel % max(n_valid, 1) and the r-th
//     valid candidate (the last candidate, n - 1, when none is valid), each
//     draw's src and dst ids (PAD in an all-dead round), its (walk, column)
//     indices src_sel = row * walk_len + spos[col] and dst_sel, and the round's
//     all_dead flag. The fused training path calls this one.
//
// What bounds the stage on this card: the launch, not bytes or operations.
// At the training path's call (57 walks of 6, npos 18, P 512) the draw reads
// 2.7 KB of walks and 4 KB of bits and writes 16 KB: 7e-6 ms at 3.35 TB/s,
// against 0.87 us for an empty one-block launch. Composed of PyTorch ops the
// stage was about 24 launches (an int32 cast of the walks, the gather,
// cumsum, searchsorted, the index, cast and select of each side, the row and
// column arithmetic), each with its own launch and its round trip through
// device memory, and each a few microseconds of the host's time in a step
// the host paces.
//
// How the design answers it:
//   - One launch of one block of kDrawThreads threads does it all. The walks
//     are read once, as the walker's int64, into shared memory (no cast pass,
//     no int32 copy); the position table and the spos / dpos columns too.
//   - The valid candidates are ranked in tiles of one candidate a thread: a
//     warp ballot and __popc give a thread its rank in its warp, a scan of
//     the 32 warp counts by warp 0 gives each warp's offset, and each valid
//     candidate writes its flat index to a compacted list at its rank. The
//     list stays in shared memory up to kListSmem candidates (16 KB); past
//     that it goes to a scratch the wrapper allocates. No atomics: the order
//     is the candidates' order, the same every run, and the r-th entry of the
//     list is what searchsorted(cumsum(valid), r + 1) finds.
//   - The first draw's bits are loaded before anything waits, so their
//     latency hides under the walks' load; the draws then read the list,
//     gather their two ids from the staged walks again (an all-dead round
//     takes candidate n - 1 and writes PAD ids) and write the four outputs.
//   - A position outside [0, L) reads nothing and gives PAD, in both kernels:
//     the table is built by the sampler, and a wrong one must not read out of
//     bounds. Walks past kWalkSmem entries (16 KB) are read from device
//     memory where they lie instead of being staged.
//
// The gather kernel:
//   - The Pallas version holds a (TB, L) tile in VMEM and gathers columns
//     with a static unrolled stack. Here one thread owns one output (b, p):
//     consecutive threads write consecutive ids of the (B, npos) outputs
//     (coalesced stores), and the threads of one row read the same L-int row
//     (one or two 32-byte sectors, served from L1 after the first). Bytes
//     bound it: at B = 65,536 and npos 18 it moves about 11 MB, 3.4 us.
//   - The position table is a small device array (npos * 8 bytes) that
//     every block reads through the read-only path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPad = -1;

__global__ void window_pairs_kernel(const int* __restrict__ paths,
                                    const int* __restrict__ pos,
                                    int* __restrict__ src,
                                    int* __restrict__ dst,
                                    long long b_rows, int walk_len, int npos) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= b_rows * npos) return;
  const long long b = i / npos;
  const int p = (int)(i - b * npos);
  const int sc = __ldg(pos + 2 * p);
  const int dc = __ldg(pos + 2 * p + 1);
  const int* row = paths + b * walk_len;
  const bool in_range = sc >= 0 && sc < walk_len && dc >= 0 && dc < walk_len;
  const int s = in_range ? row[sc] : kPad;
  const int d = in_range ? row[dc] : kPad;
  const bool valid = s != kPad && d != kPad;
  src[i] = valid ? s : kPad;
  dst[i] = valid ? d : kPad;
}

constexpr int kDrawThreads = 1024;  // the draw's one block
constexpr int kWarps = kDrawThreads / 32;
constexpr int kMaxPos = 512;      // positions the draw stages (12 KB with spos, dpos)
constexpr int kWalkSmem = 2048;   // walk entries (int64) staged in shared memory, 16 KB
constexpr int kListSmem = 4096;   // valid-candidate indices kept in shared memory, 16 KB
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kDrawThreads, 1)
window_pair_draw_kernel(const long long* __restrict__ paths, const int* __restrict__ pos,
                        const long long* __restrict__ spos,
                        const long long* __restrict__ dpos,
                        const long long* __restrict__ sel, int* __restrict__ scratch,
                        long long* __restrict__ src, long long* __restrict__ dst,
                        long long* __restrict__ src_sel, long long* __restrict__ dst_sel,
                        bool* __restrict__ all_dead, int b_rows, int cols, int npos,
                        int n_draws, long long walk_len, bool stage_walks) {
  extern __shared__ long long smem[];
  __shared__ int warp_off[kWarps];
  __shared__ int tile_total;
  long long* s_spos = smem;
  long long* s_dpos = s_spos + npos;
  long long* s_walks = s_dpos + npos;
  const int n_walk = stage_walks ? b_rows * cols : 0;
  int* s_pos = reinterpret_cast<int*>(s_walks + n_walk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = b_rows * npos;

  const long long first_bits = tid < n_draws ? sel[tid] : 0;  // in flight from the start
  for (int i = tid; i < npos; i += kDrawThreads) {
    s_spos[i] = spos[i];
    s_dpos[i] = dpos[i];
    s_pos[2 * i] = pos[2 * i];
    s_pos[2 * i + 1] = pos[2 * i + 1];
  }
  for (int i = tid; i < n_walk; i += kDrawThreads) s_walks[i] = paths[i];
  __syncthreads();
  const long long* walks = stage_walks ? s_walks : paths;
  int* list = scratch != nullptr ? scratch : s_pos + 2 * npos;

  // the valid candidates' flat indices, compacted in order
  int count = 0;
  const unsigned below = (1u << lane) - 1u;
  for (int base = 0; base < n; base += kDrawThreads) {
    const int c = base + tid;
    bool valid = false;
    if (c < n) {
      const int b = c / npos, p = c - b * npos;
      const int sc = s_pos[2 * p], dc = s_pos[2 * p + 1];
      if (sc >= 0 && sc < cols && dc >= 0 && dc < cols) {
        const long long* row = walks + (long long)b * cols;
        valid = (int)row[sc] != kPad && (int)row[dc] != kPad;
      }
    }
    const unsigned mask = __ballot_sync(kFull, valid);
    if (lane == 0) warp_off[warp] = __popc(mask);
    __syncthreads();
    if (warp == 0) {
      const int v = warp_off[lane];
      int incl = v;
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += u;
      }
      warp_off[lane] = incl - v;
      if (lane == 31) tile_total = incl;
    }
    __syncthreads();
    if (valid) list[count + warp_off[warp] + __popc(mask & below)] = c;
    count += tile_total;
  }
  __syncthreads();

  const bool dead = count == 0;
  if (tid == 0) *all_dead = dead;
  const long long m = dead ? 1 : count;
  for (int j = tid; j < n_draws; j += kDrawThreads) {
    long long r = (j == tid ? first_bits : sel[j]) % m;
    if (r < 0) r += m;  // the floor modulo of the plain version
    const int idx = dead ? n - 1 : list[r];
    const int b = idx / npos, p = idx - b * npos;
    long long s = kPad, d = kPad;
    if (!dead) {  // a listed candidate: both columns in range, neither id PAD
      const long long* row = walks + (long long)b * cols;
      s = (int)row[s_pos[2 * p]];
      d = (int)row[s_pos[2 * p + 1]];
    }
    src[j] = s;
    dst[j] = d;
    src_sel[j] = (long long)b * walk_len + s_spos[p];
    dst_sel[j] = (long long)b * walk_len + s_dpos[p];
  }
}

}  // namespace

// paths (b_rows, walk_len) int32, pos (npos, 2) int32, src and dst
// (b_rows, npos) int32, all contiguous. Returns cudaGetLastError() after the
// launch.
extern "C" int g4r_window_pairs_i32(const int* paths, const int* pos, int* src,
                                    int* dst, long long b_rows, int walk_len,
                                    int npos, void* stream) {
  const long long n = b_rows * npos;
  if (n <= 0) return (int)cudaGetLastError();
  if (walk_len <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  window_pairs_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      paths, pos, src, dst, b_rows, walk_len, npos);
  return (int)cudaGetLastError();
}

// The pair stage: paths (b_rows, cols) int64, pos (npos, 2) int32, spos and
// dpos (npos,) int64, sel (n_draws,) int64 give src, dst, src_sel and dst_sel
// (n_draws,) int64 and all_dead (one bool), all contiguous; walk_len is the
// row multiplier of src_sel / dst_sel. scratch holds b_rows * npos ints and
// may be null where that is at most kListSmem. Returns cudaGetLastError()
// after the launch.
extern "C" int g4r_window_pair_draw_i64(const long long* paths, const int* pos,
                                        const long long* spos, const long long* dpos,
                                        const long long* sel, int* scratch, long long* src,
                                        long long* dst, long long* src_sel,
                                        long long* dst_sel, bool* all_dead, int b_rows,
                                        int cols, int npos, int n_draws,
                                        long long walk_len, void* stream) {
  const long long n = (long long)b_rows * npos;
  if (b_rows <= 0 || cols <= 0 || npos <= 0 || npos > kMaxPos || n_draws < 0 ||
      n >= (1LL << 30) || (n > kListSmem && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool stage_walks = (long long)b_rows * cols <= kWalkSmem;
  const size_t smem = 2 * npos * sizeof(long long) +
                      (stage_walks ? (size_t)b_rows * cols * sizeof(long long) : 0) +
                      2 * npos * sizeof(int) + (scratch == nullptr ? n * sizeof(int) : 0);
  window_pair_draw_kernel<<<1, kDrawThreads, smem, (cudaStream_t)stream>>>(
      paths, pos, spos, dpos, sel, scratch, src, dst, src_sel, dst_sel, all_dead, b_rows,
      cols, npos, n_draws, walk_len, stage_walks);
  return (int)cudaGetLastError();
}
