// Skip-gram window-pair gather from walk paths, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/window_pairs.py:window_pair_ids_pallas
// (pallas_call at :55): a batch of walks paths (B, L) int32 and a static
// table of npos (src_col, dst_col) positions give
//     src[b, p] = paths[b, pos[p, 0]],  dst[b, p] = paths[b, pos[p, 1]]
// with BOTH set to PAD (-1) wherever either endpoint is PAD, so the fused
// sampler's pair draw needs a single src != PAD test per candidate.
//
// What bounds it on this card: bytes. Each walk row is read once (L * 4
// bytes) and 2 * npos ids are written, with no arithmetic to speak of; at the
// training path's (57, 6) walks and npos 18 that is 9.6 KB, a launch-sized
// call, and at B = 65,536 about 11 MB, 3.4 us at 3.35 TB/s.
//
// How the design answers it:
//   - The Pallas version holds a (TB, L) tile in VMEM and gathers columns
//     with a static unrolled stack. Here one thread owns one output (b, p):
//     consecutive threads write consecutive ids of the (B, npos) outputs
//     (coalesced stores), and the threads of one row read the same L-int row
//     (one or two 32-byte sectors, served from L1 after the first).
//   - The position table is a small device array (npos * 8 bytes) that
//     every block reads through the read-only path.
//   - A position outside [0, L) reads nothing and gives PAD: the table is
//     built by the sampler, and a wrong one must not read out of bounds.

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
