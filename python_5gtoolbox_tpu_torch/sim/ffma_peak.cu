// FP32 FMA throughput probe for sim/time_filter_kernels.py --peak: the
// card's FFMA rate under its present clock and power limit, the yardstick
// for the operation-bound filter kernels. Every thread runs 8 independent
// FMA chains of `iters` steps (enough in flight to hide the FMA latency
// at 8 blocks of 256 threads per SM; unrolled so that the loop's own
// instructions are under 3 % of the issue slots) and stores one sum, so
// nothing is folded away and no memory traffic competes.
#include <cuda_runtime.h>

namespace {

constexpr int kChains = 8;

__global__ void __launch_bounds__(256) ffma_kernel(float* out, int iters) {
  const float x = threadIdx.x * 1e-7f, y = 0.999f + blockIdx.x * 1e-9f;
  float a[kChains];
#pragma unroll
  for (int i = 0; i < kChains; ++i) a[i] = x + i;
#pragma unroll 16
  for (int k = 0; k < iters; ++k) {
#pragma unroll
    for (int i = 0; i < kChains; ++i) a[i] = fmaf(a[i], y, x);
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kChains; ++i) s += a[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// out: blocks * 256 floats on the device. Performs 2 * 8 * iters FLOPs
// per thread. Returns the CUDA error of the launch (0 on success).
extern "C" int ffma_peak(float* out, int blocks, int iters, void* stream) {
  if (blocks <= 0 || iters <= 0) return static_cast<int>(cudaErrorInvalidValue);
  ffma_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(out,
                                                                    iters);
  return static_cast<int>(cudaGetLastError());
}
