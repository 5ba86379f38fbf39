// Fused channel FIR + first halfband x2 on flat real float32 planes.
//
// Replaces the TPU kernel python_5gtoolbox_tpu/ops/pallas_filters.py
// _fused_kernel (entries fir_up2_fused, fir_up2_fused_planes): two
// banded-Toeplitz bf16x3 matmuls per 128-sample frame with the 1x-rate
// FIR output masked to [0, t) in between. Here the band matrices, the
// hi/lo splits and the pre-padding of the input fall away: one block per
// (plane, tile of nz_tile outputs) stages its input window (zeros outside
// the plane) in shared memory and runs duc::fir_up2_tile, so the 1x
// intermediate never reaches device memory.
//
// Bound on the H100: per 1x sample 4 bytes in, 8 bytes out and
// n1 + n2 FMAs (287 + 55 for BW 100), so the stage is operation-bound
// against the 67 TFLOP/s FP32 peak; duc_common.cuh says what the inner
// loop does about it.
#include "duc_common.cuh"

namespace {

using namespace duc;

__global__ void __launch_bounds__(kThreads)
fir_up2_fused_kernel(const float* __restrict__ x, const float* __restrict__ h,
                     const float* __restrict__ g, float* __restrict__ z,
                     int t, int n1, int n2) {
  extern __shared__ __align__(16) float smem[];
  const Geometry gm = geometry(n1, n2);
  float* sh = smem;
  float* sge = sh + gm.n1p;
  float* sgo = sge + gm.kp;
  float* sy = sgo + gm.kp;
  float* sx = sy + kTileY;
  const float* xp = x + static_cast<size_t>(blockIdx.y) * t;
  float* zp = z + static_cast<size_t>(blockIdx.y) * 2 * t;
  const int z0 = blockIdx.x * gm.nz_tile;
  const int nz = min(gm.nz_tile, 2 * t - z0);
  const int x_lo = z0 / 2 - gm.hl;
  const int nx = gm.n1p + round_up4(nz / 2 + gm.off);
  load_taps(gm, h, n1, g, sh, sge, sgo);
  for (int k = threadIdx.x; k < nx; k += kThreads) {
    const int i = x_lo + k;
    sx[k] = (i >= 0 && i < t) ? xp[i] : 0.f;
  }
  __syncthreads();
  fir_up2_tile(gm, sx, sy, sh, sge, sgo, t, z0, nz, zp);
}

}  // namespace

// x (planes, t) -> z (planes, 2 t), contiguous float32 on the device;
// h (n1) FIR taps, g (n2) halfband taps already scaled by sqrt(2).
// Returns the CUDA error of the launch (0 on success). Launches on
// `stream`, does not synchronise.
extern "C" int fir_up2_fused(const float* x, const float* h, const float* g,
                             float* z, int planes, int t, int n1, int n2,
                             void* stream) {
  if (planes <= 0 || t <= 0) return 0;
  if (planes > 65535 || n1 <= 0 || n2 < 3 || t > (1 << 30) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const duc::Geometry gm = duc::geometry(n1, n2);
  if (gm.nz_tile < 8) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(duc::fixed_floats(gm)) + gm.n1p + duc::kTileY);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fir_up2_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((2 * t + gm.nz_tile - 1) / gm.nz_tile, planes);
  fir_up2_fused_kernel<<<grid, duc::kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      x, h, g, z, t, n1, n2);
  return static_cast<int>(cudaGetLastError());
}
