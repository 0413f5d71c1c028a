// An empty kernel: what one launch of `blocks` x `threads` costs the card
// when the kernel does nothing. chip_smoke.py times it with the same
// measure() as the port's kernels, so their times and bounds can be read
// against the least time a launch can be seen to take.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// One launch a call on `stream`; returns cudaGetLastError() after it.
extern "C" int g4r_empty(int blocks, int threads, void* stream) {
  if (blocks <= 0 || threads <= 0) return (int)cudaErrorInvalidValue;
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
