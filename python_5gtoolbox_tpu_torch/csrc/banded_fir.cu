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
// The host plan (python_5gtoolbox_tpu_torch/ops/filters.py:fir_plan)
// rewrites each mode as one or two polyphase branches over a sample
// array w, each a 'same'-style sum at a common delay d (a multiple of 4):
//
//   same : y[v]      = sum_k H[k] x[v + d - k]
//   up2  : y[2v + e] = sum_k H_e[k] x[v + d - k]                 e = 0, 1
//   down2: y[v]      = sum_k H_0[k] x_p0[v + d - k]
//                    + sum_k H_1[k] x_p1[v + d - k],    x_p[m] = x[2m + p]
//
// and hands over the branch taps H_e (scaled, zero-padded to kp, a
// multiple of 4), d, the input phase of down2's first branch, the tiles
// per block and the staging path.
//
// Bound on the H100: the stage moves 8 bytes per input sample (same) and
// does n FMAs per output, so bytes bind below ~80 taps (the 71-tap FIR
// and every 55-tap halfband stage, <= 17.75 FLOP/B against the card's
// ~20) and operations bind the 143- and 287-tap 'same' stages.
//
// Design:
// * Register blocking (duc::fma16): a thread owns two groups of 4
//   consecutive positions, 4 * kThreads apart. Per step of 4 taps it loads
//   one float4 of each branch's taps (a broadcast) and one new float4 of
//   samples per group and branch, for 32 (same), 64 (up2, both branches
//   on one sample stream) or 64 (down2, two streams) FMAs: 0.16-0.28
//   shared-memory wavefronts per warp-FMA (one output per thread and one
//   tap per load would need 1.25), conflict-free (threads 16 bytes
//   apart).
// * down2 reads two phase arrays: the window is deinterleaved into the
//   even and odd samples once per tile, so every read is unit-stride (a
//   stride-2 read would conflict 2-way in the banks). Every tap is kept: the
//   remez halfband's "zero" taps are up to 8e-6, and the TPU kernel
//   computes with them.
// * Windows are copied in by cp.async. A block walks tiles_per_block
//   consecutive tiles of the flattened (plane, tile) order through a ring
//   of `stages` window buffers, the next stages - 1 tiles' windows in
//   flight while one is computed. The plan gives small stages one tile
//   and one buffer per block (the most resident blocks, which keep the
//   most reads in flight) and stages of more than 64K outputs per SM two
//   tiles through a ring of two; rings of 3 and 4 and longer blocks
//   measured slower.
//   Windows start on a multiple of 4 samples; with rows of a multiple of
//   4 samples on a 16-byte aligned base every 16-byte chunk lies wholly
//   inside or outside [0, t_in) and is copied (or zero-filled) as one;
//   otherwise the plan picks 4-byte copies.
#include <stdint.h>

#include "duc_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 2;                       // groups of 4 per thread
constexpr int kTile = kThreads * 4 * kGroups;    // branch positions per tile
constexpr int kMaxStages = 2;                    // window buffers per block

struct Args {
  const float* x;
  const float* h;        // (branches, kp) branch taps
  float* y;
  int t_in, t_out;
  int kp, d, e0;         // taps per branch, delay, down2: phase of branch 0
  int tiles;             // tiles per plane
  int total;             // planes * tiles
  int tiles_per_block;
  int stages;            // window buffers in the ring, 1..kMaxStages
};

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Input samples [lo, lo + len) of row xp, zeros outside [0, t_in), into
// dst, asynchronously; commits one cp.async group per thread. lo and len
// are multiples of 4.
template <bool VEC>
__device__ inline void stage(float* dst, const float* xp, int lo, int len,
                             int t_in) {
  if (VEC) {
    for (int c = threadIdx.x; c < len / 4; c += kThreads) {
      const int i = lo + 4 * c;
      const bool in = i >= 0 && i < t_in;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(smem_u32(dst + 4 * c)), "l"(in ? xp + i : xp),
                      "r"(in ? 16 : 0) : "memory");
    }
  } else {
    for (int k = threadIdx.x; k < len; k += kThreads) {
      const int i = lo + k;
      const bool in = i >= 0 && i < t_in;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(smem_u32(dst + k)), "l"(in ? xp + i : xp),
                      "r"(in ? 4 : 0) : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n (0 or 1) of this thread's cp.async groups are in
// flight.
__device__ inline void wait_groups(int n) {
  if (n)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int MODE>
__host__ __device__ inline int window_len(int kp) {
  return (MODE == 2 ? 2 : 1) * (kTile + kp);
}

// Tile k's window into buf; past the block's last tile an empty group,
// so that every block iteration commits exactly one.
template <int MODE, bool VEC>
__device__ inline void stage_tile(const Args& a, float* buf, int k,
                                  int last) {
  if (k >= last) {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    return;
  }
  const int plane = k / a.tiles;
  const int lo = (k - plane * a.tiles) * kTile + a.d - a.kp;
  stage<VEC>(buf, a.x + static_cast<size_t>(plane) * a.t_in,
             MODE == 2 ? 2 * lo : lo, window_len<MODE>(a.kp), a.t_in);
}

// Four consecutive outputs at yp[t], masked to t_out.
__device__ inline void store4(float* yp, int t, int t_out, const float v[4]) {
  float* out = yp + t;
  if (t + 3 < t_out && (reinterpret_cast<size_t>(out) & 15) == 0) {
    *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (t + c < t_out) out[c] = v[c];
  }
}

template <int MODE, bool VEC>
__global__ void __launch_bounds__(kThreads)
banded_fir_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kBranches = MODE == 0 ? 1 : 2;
  const int kp = a.kp, win = window_len<MODE>(kp);
  const int stages = a.stages;
  float* sh = smem;                          // kBranches * kp taps
  float* ring = sh + kBranches * kp;         // `stages` windows
  float* phase = ring + stages * win;        // down2: two phase arrays
  const int first = blockIdx.x * a.tiles_per_block;
  const int last = min(first + a.tiles_per_block, a.total);
  if (first >= last) return;

  // tiles first .. first + stages - 2 in flight before the first compute
  for (int i = 0; i < stages - 1; ++i)
    stage_tile<MODE, VEC>(a, ring + i * win, first + i, last);
  for (int k = threadIdx.x; k < kBranches * kp; k += kThreads) sh[k] = a.h[k];

  const int tid = threadIdx.x;
  // float4 index of the sample x[v0 + d] (group 0) in a tile's window
  const int base = tid + kp / 4;
  const float4* h0 = reinterpret_cast<const float4*>(sh);
  const float4* h1 = reinterpret_cast<const float4*>(sh + kp);
  for (int k = first; k < last; ++k) {
    const int i = k - first;
    float* buf = ring + (i % stages) * win;
    // tile k + stages - 1 goes into the buffer tile k - 1 was computed in
    stage_tile<MODE, VEC>(a, ring + ((i + stages - 1) % stages) * win,
                          k + stages - 1, last);
    wait_groups(stages - 1);
    __syncthreads();
    const int plane = k / a.tiles;
    const int v_lo = (k - plane * a.tiles) * kTile;
    float* yp = a.y + static_cast<size_t>(plane) * a.t_out;

    if (MODE == 0) {
      const float4* w4 = reinterpret_cast<const float4*>(buf);
      float acc[kGroups][4] = {};
      float4 hi[kGroups];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) hi[g] = w4[base + g * kThreads];
      for (int q = 0; q < kp / 4; ++q) {
        const float4 t = h0[q];
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const float4 lo = w4[base + g * kThreads - q - 1];
          duc::fma16(acc[g], t, lo, hi[g]);
          hi[g] = lo;
        }
      }
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
        store4(yp, v_lo + 4 * (tid + g * kThreads), a.t_out, acc[g]);
    } else if (MODE == 1) {
      const float4* w4 = reinterpret_cast<const float4*>(buf);
      float ev[kGroups][4] = {}, od[kGroups][4] = {};
      float4 hi[kGroups];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) hi[g] = w4[base + g * kThreads];
      for (int q = 0; q < kp / 4; ++q) {
        const float4 t0 = h0[q], t1 = h1[q];
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const float4 lo = w4[base + g * kThreads - q - 1];
          duc::fma16(ev[g], t0, lo, hi[g]);
          duc::fma16(od[g], t1, lo, hi[g]);
          hi[g] = lo;
        }
      }
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int v = v_lo + 4 * (tid + g * kThreads);
        const float lo4[4] = {ev[g][0], od[g][0], ev[g][1], od[g][1]};
        const float hi4[4] = {ev[g][2], od[g][2], ev[g][3], od[g][3]};
        store4(yp, 2 * v, a.t_out, lo4);
        store4(yp, 2 * v + 4, a.t_out, hi4);
      }
    } else {
      // deinterleave: phase[p][m] = x[2 (m_lo + m) + p]
      const int len = kTile + kp;
      {
        const float4* r4 = reinterpret_cast<const float4*>(buf);
        float2* p0 = reinterpret_cast<float2*>(phase);
        float2* p1 = reinterpret_cast<float2*>(phase + len);
        for (int j = tid; j < len / 2; j += kThreads) {
          const float4 r = r4[j];
          p0[j] = make_float2(r.x, r.z);
          p1[j] = make_float2(r.y, r.w);
        }
      }
      __syncthreads();
      const float4* wa = reinterpret_cast<const float4*>(phase + a.e0 * len);
      const float4* wb =
          reinterpret_cast<const float4*>(phase + (1 - a.e0) * len);
      float acc[kGroups][4] = {};
      float4 ha[kGroups], hb[kGroups];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        ha[g] = wa[base + g * kThreads];
        hb[g] = wb[base + g * kThreads];
      }
      for (int q = 0; q < kp / 4; ++q) {
        const float4 t0 = h0[q], t1 = h1[q];
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const float4 la = wa[base + g * kThreads - q - 1];
          const float4 lb = wb[base + g * kThreads - q - 1];
          duc::fma16(acc[g], t0, la, ha[g]);
          duc::fma16(acc[g], t1, lb, hb[g]);
          ha[g] = la;
          hb[g] = lb;
        }
      }
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
        store4(yp, v_lo + 4 * (tid + g * kThreads), a.t_out, acc[g]);
    }
    // the buffer of this tile is refilled by the next iteration's copy
    __syncthreads();
  }
}

template <int MODE, bool VEC>
int launch(const Args& a, int blocks, cudaStream_t stream) {
  const int kb = MODE == 0 ? 1 : 2;
  const int win = window_len<MODE>(a.kp);
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(kb) * a.kp + static_cast<size_t>(a.stages) * win +
       (MODE == 2 ? 2 * (kTile + a.kp) : 0));
  auto kernel = banded_fir_kernel<MODE, VEC>;
  // above 48 KB (down2) only after opting in; once per size reached
  static size_t opted = 48 * 1024;
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (planes, t_in) -> y (planes, t_out), both contiguous float32 on the
// device; h (branches, kp) float32 branch taps of fir_plan (scaled,
// zero-padded; branches 1 for same, 2 for up2 / down2); d the branches'
// common delay, e0 the input phase down2's first branch reads; a block
// computes tiles_per_block tiles of 2048 positions with `stages` window
// buffers; vec the staging path (16-byte copies: t_in a multiple of 4 and
// x 16-byte aligned). Returns the CUDA error of the launch (0 on
// success). Launches on `stream`, does not synchronise.
extern "C" int banded_fir(const float* x, const float* h, float* y,
                          int planes, int t_in, int t_out, int mode, int kp,
                          int d, int e0, int tiles_per_block, int stages,
                          int vec, void* stream) {
  if (planes <= 0 || t_out <= 0) return 0;
  const int positions = mode == 2 ? t_out : t_in;
  if (mode < 0 || mode > 2 || t_in <= 0 || kp <= 0 || kp % 4 || d < 0 ||
      d % 4 || (e0 != 0 && e0 != 1) || tiles_per_block <= 0 ||
      stages < 1 || stages > kMaxStages ||
      (vec && (t_in % 4 || reinterpret_cast<size_t>(x) % 16)) ||
      t_out != (mode == 0 ? t_in : mode == 1 ? 2 * t_in : t_in / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (positions + kTile - 1) / kTile;
  const long long total = tiles * planes;
  const long long blocks = (total + tiles_per_block - 1) / tiles_per_block;
  if (total > 0x7fffffffLL || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, h, y, t_in, t_out, kp, d, e0, static_cast<int>(tiles),
               static_cast<int>(total), tiles_per_block, stages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = static_cast<int>(blocks);
  switch (mode * 2 + (vec ? 1 : 0)) {
    case 0: return launch<0, false>(a, nb, s);
    case 1: return launch<0, true>(a, nb, s);
    case 2: return launch<1, false>(a, nb, s);
    case 3: return launch<1, true>(a, nb, s);
    case 4: return launch<2, false>(a, nb, s);
    default: return launch<2, true>(a, nb, s);
  }
}
