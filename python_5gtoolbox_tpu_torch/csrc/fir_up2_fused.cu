// Fused channel FIR + first halfband x2 on flat real float32 planes.
//
// Replaces the TPU kernel python_5gtoolbox_tpu/ops/pallas_filters.py
// _fused_kernel (entries fir_up2_fused, fir_up2_fused_planes): two
// banded-Toeplitz bf16x3 matmuls per 128-sample frame with the 1x-rate
// FIR output masked to [0, t) in between. Here the band matrices, the
// hi/lo splits and the pre-padding of the input fall away: a block stages
// each tile's input window (zeros outside the plane) in shared memory and
// runs the duc_common.cuh tile routine on it, so the 1x intermediate
// never reaches device memory.
//
// Bound on the H100: per 1x sample 4 bytes in, 8 bytes out and
// n1 + n2 FMAs (287 + 55 for BW 100), so the stage is operation-bound
// against the 67 TFLOP/s FP32 peak from about 65 FIR taps on and
// byte-bound below.
//
// Design (the host plan, python_5gtoolbox_tpu_torch/ops/filters.py:
// fused_plan, fixes every choice):
// * One tile of nz_tile outputs per block, on a flat grid in (plane,
//   tile) order (a two-dimensional grid of tiles x planes was 2-3 %
//   slower at 287 taps); the packed taps and the tile's window arrive by
//   cp.async in one copy group. Blocks of several tiles through a ring
//   of windows were slower at every shape measured (PERF.md section 6).
// * The FIR gets `lead` zero taps in front (ops/filters.py:fused_lead),
//   which makes every window start on a multiple of 4 samples: with rows
//   of a multiple of 4 samples on a 16-byte aligned base each 16-byte
//   chunk lies wholly inside or outside [0, t) and is copied (or
//   zero-filled) as one; otherwise the plan picks 4-byte copies.
// * PER = 4: duc::fir_up2_tiles, paced by shared memory for long FIRs;
//   PER = 8: duc::fir_up2_tile8 on windows split into their even and odd
//   float4s.
#include "duc_common.cuh"

namespace {

using namespace duc;

struct Args {
  const float* x;
  const float* taps;     // the plan's packed taps (copy_taps)
  float* z;
  Geometry gm;           // geometry(n1, n2, lead, PER)
  int t;
  int tiles;             // tiles per plane
  int win;               // window floats
  int half;              // PER = 8: floats of each half of the split window
};

template <int PER, bool VEC>
__global__ void __launch_bounds__(kThreads)
fir_up2_fused_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  const Geometry& gm = a.gm;
  float* sh = smem;
  float* sge = sh + gm.n1p;
  float* sgo = sge + gm.kp;
  float* sy = sgo + gm.kp;
  float* win = sy + PER * kThreads;
  const int plane = blockIdx.x / a.tiles;
  const int z0 = (blockIdx.x - plane * a.tiles) * gm.nz_tile;
  const int lo = z0 / 2 - gm.hl;
  const float* xp = a.x + static_cast<size_t>(plane) * a.t;

  copy_taps(sh, a.taps, gm.n1p + 2 * gm.kp);
  if (VEC) {
    for (int c = threadIdx.x; c < a.win / 4; c += kThreads) {
      const int i = lo + 4 * c;
      const bool in = i >= 0 && i < a.t;
      copy16(win + (PER == 8 ? split(4 * c, a.half) : 4 * c),
             in ? xp + i : xp, in);
    }
  } else {
    for (int f = threadIdx.x; f < a.win; f += kThreads) {
      const int i = lo + f;
      const bool in = i >= 0 && i < a.t;
      copy4(win + (PER == 8 ? split(f, a.half) : f), in ? xp + i : xp, in);
    }
  }
  commit_copies();
  wait_copies(0);
  __syncthreads();
  const int nz = min(gm.nz_tile, 2 * a.t - z0);
  float* zp = a.z + static_cast<size_t>(plane) * 2 * a.t;
  if (PER == 8)
    fir_up2_tile8(gm, win, a.half, sy, sh, sge, sgo, a.t, z0, nz, zp);
  else
    fir_up2_tile(gm, win, sy, sh, sge, sgo, a.t, z0, nz, zp);
}

template <int PER, bool VEC>
int launch(const Args& a, dim3 grid, int smem, cudaStream_t stream) {
  auto kernel = fir_up2_fused_kernel<PER, VEC>;
  // above 48 KB only after opting in; once per instantiation and size
  static int opted = 48 * 1024;
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (planes, t) -> z (planes, 2 t), contiguous float32 on the device;
// taps: the plan's packed taps (FIR with `lead` zeros in front, then the
// halfband branches scaled by sqrt(2)) on the device. lead, per (4 or 8),
// vec (16-byte copies: t a multiple of 4 and x 16-byte aligned), win
// (window floats) and smem (bytes of dynamic shared memory) come from the
// host plan (ops/filters.py:fused_plan), which checks that they fit.
// Returns the CUDA error of the launch (0 on success). Launches on
// `stream`, does not synchronise.
extern "C" int fir_up2_fused(const float* x, const float* taps, float* z,
                             int planes, int t, int n1, int n2, int lead,
                             int per, int vec, int win, int smem,
                             void* stream) {
  if (planes <= 0 || t <= 0) return 0;
  if (n1 <= 0 || n2 < 3 || lead < 0 || lead > 3 ||
      (per != 4 && per != 8) || win <= 0 || win % 4 || smem <= 0 ||
      t > (1 << 29) ||
      (vec && (t % 4 || reinterpret_cast<size_t>(x) % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  const duc::Geometry gm = duc::geometry(n1, n2, lead, per);
  if (gm.nz_tile < 8 || gm.hl % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int win_phys = per == 8 ? (win + 7) & ~7 : win;
  if (win < gm.n1p + gm.nz_tile / 2 + gm.off ||
      smem < 4 * (gm.n1p + 2 * gm.kp + per * duc::kThreads + win_phys))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (2 * t + gm.nz_tile - 1) / gm.nz_tile;
  if (static_cast<long long>(tiles) * planes > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, taps, z, gm, t, tiles, win, win_phys / 2};
  const dim3 grid(tiles * planes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((per == 8 ? 2 : 0) + (vec ? 1 : 0)) {
    case 0: return launch<4, false>(a, grid, smem, s);
    case 1: return launch<4, true>(a, grid, smem, s);
    case 2: return launch<8, false>(a, grid, smem, s);
    default: return launch<8, true>(a, grid, smem, s);
  }
}
