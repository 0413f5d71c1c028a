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
// below the cost of a launch. The design therefore aims only at moving the
// bytes once, coalesced:
//   - a block owns ROWS rows; threadIdx.x walks D (contiguous, so a warp
//     reads 128 contiguous bytes of one neighbour row), threadIdx.y is the
//     row, and each thread loops over F for its (row, d) outputs;
//   - the block stages its rows' mask bytes in shared memory once, so the
//     mask row is read from device memory once per row, not once per d;
//   - x and the mask take a row stride, so the strided per-relation view
//     child[:, :, r] of the ego layout (core/hetero.py) is read in place,
//     with no copy; F and D must be dense (strides D and 1).
// The TPU version padded N and D up to its (8, 256) tiles; here the ragged
// edge is masked by bounds checks and nothing is padded.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;      // rows per block (blockDim.y)
constexpr int kThreadsD = 32; // threads along D (blockDim.x)
constexpr float kNegInf = -1e30f;

__global__ void seg_aggr_kernel(const float* __restrict__ x,
                                const uint8_t* __restrict__ mask,
                                float* __restrict__ out, long long n, int f,
                                int d, long long x_row_stride,
                                long long m_row_stride, int mode) {
  extern __shared__ uint8_t s_mask[];  // (kRows, f)
  const long long row0 = (long long)blockIdx.x * kRows;
  const int tid = threadIdx.y * kThreadsD + threadIdx.x;
  for (int i = tid; i < kRows * f; i += kRows * kThreadsD) {
    const long long r = row0 + i / f;
    s_mask[i] = (r < n) ? mask[r * m_row_stride + (i % f)] : 0;
  }
  __syncthreads();
  const long long row = row0 + threadIdx.y;
  if (row >= n) return;
  const uint8_t* m = s_mask + threadIdx.y * f;
  const float* xr = x + row * x_row_stride;
  float* o = out + row * (long long)d;
  if (mode == 2) {  // max
    bool any = false;
    for (int j = 0; j < f; ++j) any |= (m[j] != 0);
    for (int c = threadIdx.x; c < d; c += kThreadsD) {
      float acc = kNegInf;
      for (int j = 0; j < f; ++j) {
        const float v = m[j] ? xr[(long long)j * d + c] : kNegInf;
        acc = fmaxf(acc, v);
      }
      o[c] = any ? acc : 0.0f;
    }
    return;
  }
  float count = 0.0f;
  for (int j = 0; j < f; ++j) count += m[j] ? 1.0f : 0.0f;
  for (int c = threadIdx.x; c < d; c += kThreadsD) {
    float acc = 0.0f;
    for (int j = 0; j < f; ++j) {
      // x * mask, as the plain version computes it (0 * x for PAD slots)
      acc += xr[(long long)j * d + c] * (m[j] ? 1.0f : 0.0f);
    }
    o[c] = (mode == 1) ? acc / fmaxf(count, 1.0f) : acc;
  }
}

// Backward of sum and mean: dx[n, f, :] = mask[n, f] * g[n, :] (sum) or
// (g[n, :] / max(count_n, 1)) * mask[n, f] (mean), in the order JAX's
// autodiff of the plain version multiplies, into a dense (N, F, D) block.
// Bytes again: it reads g once and writes F times as much. Same layout as
// the forward: a block owns kRows rows, threadIdx.x walks D, each thread
// loops over F, and the mask rows are staged in shared memory once.
__global__ void seg_aggr_bwd_kernel(const float* __restrict__ g,
                                    const uint8_t* __restrict__ mask,
                                    float* __restrict__ dx, long long n, int f,
                                    int d, long long m_row_stride, int mode) {
  extern __shared__ uint8_t s_mask[];  // (kRows, f)
  const long long row0 = (long long)blockIdx.x * kRows;
  const int tid = threadIdx.y * kThreadsD + threadIdx.x;
  for (int i = tid; i < kRows * f; i += kRows * kThreadsD) {
    const long long r = row0 + i / f;
    s_mask[i] = (r < n) ? mask[r * m_row_stride + (i % f)] : 0;
  }
  __syncthreads();
  const long long row = row0 + threadIdx.y;
  if (row >= n) return;
  const uint8_t* m = s_mask + threadIdx.y * f;
  float count = 0.0f;
  for (int j = 0; j < f; ++j) count += m[j] ? 1.0f : 0.0f;
  const float c = fmaxf(count, 1.0f);
  const float* gr = g + row * (long long)d;
  float* o = dx + row * (long long)f * d;
  for (int c_ = threadIdx.x; c_ < d; c_ += kThreadsD) {
    const float gv = (mode == 1) ? gr[c_] / c : gr[c_];
    for (int j = 0; j < f; ++j) {
      o[(long long)j * d + c_] = gv * (m[j] ? 1.0f : 0.0f);
    }
  }
}

}  // namespace

// mode: 0 = sum, 1 = mean, 2 = max. Returns cudaGetLastError() after the
// launch; the caller raises on anything but 0.
extern "C" int g4r_seg_aggr_f32(const float* x, const uint8_t* mask,
                                float* out, long long n, int f, int d,
                                long long x_row_stride, long long m_row_stride,
                                int mode, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const dim3 block(kThreadsD, kRows);
  const long long blocks = (n + kRows - 1) / kRows;
  const size_t smem = (size_t)kRows * (size_t)f;
  seg_aggr_kernel<<<(unsigned)blocks, block, smem, (cudaStream_t)stream>>>(
      x, mask, out, n, f, d, x_row_stride, m_row_stride, mode);
  return (int)cudaGetLastError();
}

// Backward of mode 0 (sum) or 1 (mean); max has no backward kernel. g is
// (N, D) contiguous, dx (N, F, D) contiguous; the mask takes a row stride.
extern "C" int g4r_seg_aggr_bwd_f32(const float* g, const uint8_t* mask,
                                    float* dx, long long n, int f, int d,
                                    long long m_row_stride, int mode,
                                    void* stream) {
  if (mode != 0 && mode != 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const dim3 block(kThreadsD, kRows);
  const long long blocks = (n + kRows - 1) / kRows;
  const size_t smem = (size_t)kRows * (size_t)f;
  seg_aggr_bwd_kernel<<<(unsigned)blocks, block, smem, (cudaStream_t)stream>>>(
      g, mask, dx, n, f, d, m_row_stride, mode);
  return (int)cudaGetLastError();
}

// Text of a cudaError_t, for the Python wrappers' exceptions.
extern "C" const char* g4r_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
