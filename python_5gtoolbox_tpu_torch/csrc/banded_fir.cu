// Banded FIR stage (upfirdn conventions) on real float32 planes.
//
// Replaces the TPU kernel python_5gtoolbox_tpu/ops/pallas_filters.py
// _conv_kernel (banded-Toeplitz matmul in bf16x3 on the MXU). Here each
// output is a plain FP32 FMA sum over the taps, which is more accurate
// than bf16x3 and needs no band matrix.
//
//   mode 0 same : y[t] = sum_j h[j] x[t + b - j]
//   mode 1 up2  : y[t] = sum_{j : t+b-j even} h[j] x[(t + b - j) / 2]
//   mode 2 down2: y[t] = sum_j h[j] x[2t + b - j]
//
// (b and the sqrt(2) tap scale of the halfband modes come from the
// wrapper, python_5gtoolbox_tpu_torch/ops/filters.py:banded_fir.)
//
// Design: one block per (plane, tile of kTile outputs). The block stages
// the tile's input window plus halo and the taps in shared memory; each
// thread keeps kPerThread accumulators (outputs kThreads apart, so a warp
// reads consecutive shared words) and loads each tap once for all of
// them. Bound on the H100: at 71..287 taps the stage does 71..287 FMAs
// per 8 bytes moved, so it is operation-bound against the 67 TFLOP/s FP32
// peak; this simple kernel is instead limited by shared-memory loads
// (about 1.25 per FMA).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;

__host__ __device__ inline int floor_div2(int a) {
  return a >= 0 ? a / 2 : -((1 - a) / 2);
}

// input window [lo, lo + len) that the tile starting at output t0 reads
__host__ __device__ inline void window(int mode, int t0, int n, int b,
                                       int* lo, int* len) {
  if (mode == 0) {
    *lo = t0 + b - (n - 1);
    *len = kTile + n - 1;
  } else if (mode == 1) {
    *lo = floor_div2(t0 + b - (n - 1));
    *len = (kTile + n) / 2 + 2;
  } else {
    *lo = 2 * t0 + b - (n - 1);
    *len = 2 * kTile + n - 1;
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
banded_fir_kernel(const float* __restrict__ x, const float* __restrict__ h,
                  float* __restrict__ y, int t_in, int t_out, int n, int b) {
  extern __shared__ float smem[];
  float* sh = smem;
  float* sx = smem + n;
  const int t0 = blockIdx.x * kTile;
  const float* xp = x + static_cast<size_t>(blockIdx.y) * t_in;
  float* yp = y + static_cast<size_t>(blockIdx.y) * t_out;
  int lo, len;
  window(MODE, t0, n, b, &lo, &len);
  for (int k = threadIdx.x; k < n; k += kThreads) sh[k] = h[k];
  for (int k = threadIdx.x; k < len; k += kThreads) {
    const int i = lo + k;
    sx[k] = (i >= 0 && i < t_in) ? xp[i] : 0.f;
  }
  __syncthreads();

  const int tl = threadIdx.x;
  float acc[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) acc[r] = 0.f;

  if (MODE == 0 || MODE == 2) {
    // window index of x[t + b - j] (same) / x[2t + b - j] (down2) for
    // j = 0 is base + r * stride
    const int step = MODE == 0 ? 1 : 2;
    const int base = step * tl + n - 1;
    for (int j = 0; j < n; ++j) {
      const float hj = sh[j];
#pragma unroll
      for (int r = 0; r < kPerThread; ++r)
        acc[r] = fmaf(hj, sx[base + step * r * kThreads - j], acc[r]);
    }
  } else {
    // t + b has the same parity for all of this thread's outputs
    // (kThreads is even), so they share the tap phase j0.
    const int m = t0 + tl + b;
    const int j0 = m & 1;
    for (int j = j0; j < n; j += 2) {
      const float hj = sh[j];
      const int base = (m - j) / 2 - lo;
#pragma unroll
      for (int r = 0; r < kPerThread; ++r)
        acc[r] = fmaf(hj, sx[base + r * (kThreads / 2)], acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int t = t0 + tl + r * kThreads;
    if (t < t_out) yp[t] = acc[r];
  }
}

}  // namespace

// x (planes, t_in) -> y (planes, t_out), both contiguous float32 on the
// device; h (n) float32 taps (already scaled). Returns the CUDA error of
// the launch (0 on success). Launches on `stream`, does not synchronise.
extern "C" int banded_fir(const float* x, const float* h, float* y,
                          int planes, int t_in, int t_out, int n, int mode,
                          int b, void* stream) {
  if (planes <= 0 || t_out <= 0) return 0;
  if (mode < 0 || mode > 2 || planes > 65535 || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int lo, len;
  window(mode, 0, n, b, &lo, &len);
  const size_t smem = static_cast<size_t>(n + len) * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((t_out + kTile - 1) / kTile, planes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    banded_fir_kernel<0><<<grid, kThreads, smem, s>>>(x, h, y, t_in, t_out,
                                                      n, b);
  else if (mode == 1)
    banded_fir_kernel<1><<<grid, kThreads, smem, s>>>(x, h, y, t_in, t_out,
                                                      n, b);
  else
    banded_fir_kernel<2><<<grid, kThreads, smem, s>>>(x, h, y, t_in, t_out,
                                                      n, b);
  return static_cast<int>(cudaGetLastError());
}
