// CP insertion + channel FIR + first halfband x2 from per-symbol IFFT
// output planes.
//
// Replaces the TPU kernel python_5gtoolbox_tpu/ops/pallas_filters.py
// _fused_sym_kernel (entry fir_up2_fused_symbols), which assembles one
// slot's CP timeline in VMEM with 128-lane copy plans and takes the
// neighbour slots' samples from a precomputed halo side array. A CUDA
// block reads any sample it needs straight from device memory, so the
// copy plans, the halo array and the per-slot grid fall away: the grid
// is (tile of outputs, plane) over the whole waveform, and the loader
// maps each timeline index to (slot, symbol, offset) through the CP
// table. Outside the waveform the timeline is zero (not the clamped
// neighbour), and FIR outputs outside [0, S * slot_samples) are masked
// before the halfband, as in duc_common.cuh. Any FIR length is served
// (the TPU kernel's frame geometry refuses short FIRs below nfft 1024).
//
// Bound on the H100: per 1x sample 4 bytes in (14 nfft of 15 nfft
// timeline samples are read once), 8 bytes out and n1 + n2 FMAs:
// operation-bound against the 67 TFLOP/s FP32 peak from about 65 FIR
// taps on, byte-bound for the short FIRs below nfft 1024 (27 to 51
// taps); duc_common.cuh says what the inner loop does about the
// operations, and the loader's integer division and symbol search cost
// little beside them.
#include "duc_common.cuh"

namespace {

using namespace duc;

__global__ void __launch_bounds__(kThreads)
fir_up2_fused_symbols_kernel(const float* __restrict__ sym,
                             const int* __restrict__ cps,
                             const float* __restrict__ h,
                             const float* __restrict__ g,
                             float* __restrict__ z, int n_slots, int nfft,
                             int n1, int n2) {
  extern __shared__ __align__(16) float smem[];
  __shared__ SlotLayout lay;
  const Geometry gm = geometry(n1, n2);
  float* sh = smem;
  float* sge = sh + gm.n1p;
  float* sgo = sge + gm.kp;
  float* sy = sgo + gm.kp;
  float* sx = sy + kTileY;
  load_slot_layout(&lay, cps, nfft);
  const int slot_samples = lay.start[14];
  const int t = n_slots * slot_samples;
  const float* xp = sym + static_cast<size_t>(blockIdx.y) * n_slots * 14 * nfft;
  float* zp = z + static_cast<size_t>(blockIdx.y) * 2 * t;
  const int z0 = blockIdx.x * gm.nz_tile;
  const int nz = min(gm.nz_tile, 2 * t - z0);
  const int x_lo = z0 / 2 - gm.hl;
  const int nx = gm.n1p + round_up4(nz / 2 + gm.off);
  load_taps(gm, h, n1, g, sh, sge, sgo);
  for (int k = threadIdx.x; k < nx; k += kThreads) {
    const int i = x_lo + k;
    float v = 0.f;
    if (i >= 0 && i < t) {
      const int s = i / slot_samples;
      const int r = i - s * slot_samples;
      int m = 0;
      while (r >= lay.start[m + 1]) ++m;
      const int src = cp_source(r - lay.start[m], lay.cp[m], nfft);
      v = xp[(static_cast<size_t>(s) * 14 + m) * nfft + src];
    }
    sx[k] = v;
  }
  __syncthreads();
  fir_up2_tile(gm, sx, sy, sh, sge, sgo, t, z0, nz, zp);
}

}  // namespace

// sym (planes, n_slots, 14, nfft) -> z (planes, 2 n_slots slot_samples),
// contiguous float32 on the device; cps (14) int32 CP lengths on the
// device, slot_samples = sum(cps) + 14 nfft; h (n1) FIR taps, g (n2)
// halfband taps already scaled by sqrt(2). Returns the CUDA error of the
// launch (0 on success). Launches on `stream`, does not synchronise.
extern "C" int fir_up2_fused_symbols(const float* sym, const int* cps,
                                     const float* h, const float* g, float* z,
                                     int planes, int n_slots, int nfft,
                                     int slot_samples, int n1, int n2,
                                     void* stream) {
  if (planes <= 0 || n_slots <= 0) return 0;
  if (planes > 65535 || n1 <= 0 || n2 < 3 || nfft <= 0 ||
      slot_samples < 14 * nfft)
    return static_cast<int>(cudaErrorInvalidValue);
  const duc::Geometry gm = duc::geometry(n1, n2);
  const int nz_tile = gm.nz_tile;
  if (nz_tile < 8) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(duc::fixed_floats(gm)) + gm.n1p + duc::kTileY);
  if (smem > 226 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fir_up2_fused_symbols_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long t2 = 2LL * n_slots * slot_samples;
  if (t2 > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((t2 + nz_tile - 1) / nz_tile), planes);
  fir_up2_fused_symbols_kernel<<<grid, duc::kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      sym, cps, h, g, z, n_slots, nfft, n1, n2);
  return static_cast<int>(cudaGetLastError());
}
