// CP insertion + channel FIR + first halfband x2 from per-symbol IFFT
// output planes.
//
// Replaces the TPU kernel python_5gtoolbox_tpu/ops/pallas_filters.py
// _fused_sym_kernel (entry fir_up2_fused_symbols), which assembles one
// slot's CP timeline in VMEM with 128-lane copy plans and takes the
// neighbour slots' samples from a precomputed halo side array. Here a
// block serves a group of `group` consecutive symbols of one slot on one
// plane (grid: groups of the waveform x planes) with 4 FIR outputs per
// thread (duc::fir_up2_tile: the carriers below nfft 1024 have 27-51
// taps). Its window is the group's CP timeline with hl samples before it
// and hr after, made of contiguous runs of the (planes, S, 14, nfft)
// input that the host plan lists (python_5gtoolbox_tpu_torch/ops/
// filters.py:fused_symbols_plan): the tail of symbol g0 - 1, then per
// symbol its CP (the tail of its own row) and its body, then the CP and
// the head of the next symbol, each one cp.async copy of 16-byte chunks
// where source and window offsets allow it, else of 4-byte elements;
// zeros beyond the waveform's ends. The run table travels in the
// kernel's parameters, so no block reads a CP table, divides or searches
// per sample. FIR outputs outside [0, S * slot_samples) are masked before
// the halfband, as in duc_common.cuh. The group's outputs go through the
// tile routine in equal tiles (the rule duc_from_spec's tile table uses).
// Any FIR length is served (the TPU kernel's frame geometry refuses short
// FIRs below nfft 1024).
//
// Bound on the H100: per 1x sample 4 bytes in (14 nfft of 15 nfft
// timeline samples are read once), 8 bytes out and n1 + n2 FMAs:
// byte-bound for the short FIRs below nfft 1024 (27 to 51 taps). At
// these sizes (about one wave of blocks) the latency of one block's
// copy, FIR and halfband sets the time: the taps and the whole window
// arrive in one copy group.
#include <string.h>

#include "duc_common.cuh"

namespace {

using namespace duc;

constexpr int kMaxGroups = 14;
// per group: the left halo, CP and body of each symbol, the two runs of
// the right halo and the zero tail
constexpr int kMaxRuns = 2 * 14 + 4 * kMaxGroups;
constexpr int kRunInts = 5;      // window float, row - g0, row float,
                                 // length, flags (1: 16-byte, 2: zeros)

struct SymArgs {
  const float* sym;
  const float* taps;     // the plan's packed taps (copy_taps)
  float* z;
  Geometry gm;           // geometry(n1, n2, lead)
  int n_slots, nfft, slot_samples, t, group, groups;
  int run_lo[kMaxGroups + 1];   // runs of group j: run_lo[j] .. run_lo[j+1]
  int start[kMaxGroups + 1];    // group j's first sample in its slot
  int tile[kMaxGroups];         // outputs per tile of group j
  int run[kMaxRuns][kRunInts];
};

__global__ void __launch_bounds__(kThreads)
fir_up2_fused_symbols_kernel(const __grid_constant__ SymArgs a) {
  extern __shared__ __align__(16) float smem[];
  const Geometry& gm = a.gm;
  float* sh = smem;
  float* sge = sh + gm.n1p;
  float* sgo = sge + gm.kp;
  float* sy = sgo + gm.kp;
  float* win = sy + kTileY;
  const int slot = blockIdx.x / a.groups;
  const int j = blockIdx.x - slot * a.groups;
  const int g0 = 14 * slot + j * a.group;
  const int n_sym = 14 * a.n_slots;
  const float* xp = a.sym + static_cast<size_t>(blockIdx.y) * n_sym * a.nfft;

  copy_taps(sh, a.taps, gm.n1p + 2 * gm.kp);
  for (int r = a.run_lo[j]; r < a.run_lo[j + 1]; ++r) {
    const int dst = a.run[r][0], row = g0 + a.run[r][1];
    const int len = a.run[r][3], flags = a.run[r][4];
    const bool in = !(flags & 2) && row >= 0 && row < n_sym;
    const float* src =
        in ? xp + static_cast<size_t>(row) * a.nfft + a.run[r][2] : xp;
    if (flags & 1) {
      for (int c = threadIdx.x; c < len / 4; c += kThreads)
        copy16(win + dst + 4 * c, in ? src + 4 * c : xp, in);
    } else {
      for (int k = threadIdx.x; k < len; k += kThreads)
        copy4(win + dst + k, in ? src + k : xp, in);
    }
  }
  commit_copies();
  wait_copies(0);
  __syncthreads();
  const int n_out = 2 * (a.start[j + 1] - a.start[j]);
  const int tile = a.tile[j];
  const int z0 = 2 * (slot * a.slot_samples + a.start[j]);
  float* zp = a.z + static_cast<size_t>(blockIdx.y) * 2 * a.t;
  for (int u0 = 0; u0 < n_out; u0 += tile)
    fir_up2_tile(gm, win + u0 / 2, sy, sh, sge, sgo, a.t, z0 + u0,
                 min(tile, n_out - u0), zp);
}

}  // namespace

// sym (planes, n_slots, 14, nfft) -> z (planes, 2 n_slots slot_samples),
// contiguous float32 on the device; taps: the plan's packed taps (FIR
// with `lead` zeros in front, then the halfband branches scaled by
// sqrt(2)) on the device. table: the plan's run table in host memory,
// int32: run_lo (groups + 1), start (groups + 1), tile (groups), then
// n_runs runs of 5. lead, group (symbols per block; groups = 14 / group
// per slot), win (window floats) and smem (bytes of dynamic shared
// memory) come from the host plan (ops/filters.py:fused_symbols_plan),
// which checks that they fit. Returns the CUDA error of the launch (0 on
// success). Launches on `stream`, does not synchronise.
extern "C" int fir_up2_fused_symbols(const float* sym, const float* taps,
                                     float* z, const int* table, int planes,
                                     int n_slots, int nfft, int slot_samples,
                                     int n1, int n2, int lead, int group,
                                     int n_runs, int win, int smem,
                                     void* stream) {
  if (planes <= 0 || n_slots <= 0) return 0;
  if (planes > 65535 || n1 <= 0 || n2 < 3 || nfft <= 0 || lead < 0 ||
      lead > 3 || group < 1 || 14 % group || n_runs < 0 ||
      n_runs > kMaxRuns || win <= 0 || win % 4 || smem <= 0 ||
      slot_samples < 14 * nfft ||
      2LL * n_slots * slot_samples > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  SymArgs a = {};
  a.gm = duc::geometry(n1, n2, lead);
  if (a.gm.nz_tile < 8 ||
      smem < 4 * (a.gm.n1p + 2 * a.gm.kp + duc::kTileY + win))
    return static_cast<int>(cudaErrorInvalidValue);
  a.sym = sym;
  a.taps = taps;
  a.z = z;
  a.n_slots = n_slots;
  a.nfft = nfft;
  a.slot_samples = slot_samples;
  a.t = n_slots * slot_samples;
  a.group = group;
  a.groups = 14 / group;
  const int groups = a.groups;
  memcpy(a.run_lo, table, sizeof(int) * (groups + 1));
  memcpy(a.start, table + groups + 1, sizeof(int) * (groups + 1));
  memcpy(a.tile, table + 2 * groups + 2, sizeof(int) * groups);
  memcpy(a.run, table + 3 * groups + 2, sizeof(int) * kRunInts * n_runs);
  if (a.run_lo[groups] != n_runs)
    return static_cast<int>(cudaErrorInvalidValue);
  // above 48 KB only after opting in; once per size
  static int opted = 48 * 1024;
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        fir_up2_fused_symbols_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  const dim3 grid(n_slots * groups, planes);
  fir_up2_fused_symbols_kernel<<<grid, duc::kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
