// IDFT + phase compensation + CP insertion + channel FIR + first
// halfband x2 from padded spectrum planes: the whole TX low-PHY and the
// first two DUC stages in one kernel.
//
// Replaces the TPU kernel python_5gtoolbox_tpu/ops/pallas_filters.py
// _fused_spec_kernel (entry duc_from_spec_planes): one grid step per
// (antenna, slot), a two-stage Karatsuba matmul DFT in bf16x3 per symbol,
// the slot timeline assembled in VMEM with 128-lane copy plans, halos
// recomputed from the neighbour slots' symbols 13 and 0 through clamped
// index maps and zeroed again at the waveform's ends. None of that
// machinery is carried over. Here one block serves one symbol of one
// antenna (block g = 14 slot + symbol), and the blocks of K consecutive
// symbols form a thread-block cluster (K from the host plan,
// python_5gtoolbox_tpu_torch/ops/filters.py:duc_plan; clusters may cross
// slot boundaries; the grid is padded to whole clusters with blocks that
// take part in the cluster barriers and emit nothing):
//
//   1. a Stockham autosort IDFT in shared memory (radix 4, one radix-2
//      pass first when log2 nfft is odd; FP32, twiddles from a table
//      computed in float64) of the block's own symbol. The passes go to
//      and fro between two buffers in natural order, so no pass and no
//      load is bit-reversed and every read is conflict-free;
//   2. per sample the (-1)^t sign of the centre ifftshift, the
//      1/sqrt(nfft) scale and the symbol's phase compensation, while its
//      CP timeline (the CP is the tail of its own output) is written into
//      the middle of the block's window [halo | CP | data | halo];
//   3. after a cluster barrier, the halos: the last hl samples of symbol
//      g - 1 and the first hr of g + 1 are read from the neighbouring
//      blocks' windows through distributed shared memory. Only the
//      cluster's first block computes symbol g - 1's IDFT itself, and its
//      last block symbol g + 1's, before their own (the second IDFT buffer
//      is the window's middle, which is published only afterwards). The
//      waveform's two ends stay zero. K = 8: 10 IDFTs per 8 symbols where
//      a block per symbol computing both neighbours needs 24;
//   4. duc::fir_up2_tiles over the window in equal tiles (multiples of 8
//      outputs), both planes per pass. The plan's tile table gives each
//      symbol of a slot its tile length and the run of tiles that read no
//      halo sample. The cluster barriers are split: a block arrives once
//      its timeline is published and runs that run of tiles before it
//      waits (at nfft 4096 the middle three of five are filtered while
//      the edge blocks compute their second IDFT); it arrives again once
//      its halo copies are done, runs the other tiles, and waits only
//      before it exits.
//
// Bound on the H100: per 1x complex sample 2 x (n1 + n2) FMAs against
// about 7.5 bytes in and 16 bytes out: operation-bound against the 67
// TFLOP/s FP32 peak. The IDFT is about 4 % of the operations at nfft 4096
// with 287 + 55 taps.
#include <cooperative_groups.h>

#include "duc_common.cuh"

namespace {

using namespace duc;
namespace cg = cooperative_groups;

// One radix-2 Stockham pass of length n at stride 1 (the first pass):
// natural order in x, natural order in y. tw: cos then sin of
// 2 pi q / n, q < n/2.
__device__ inline void pass2(const float* __restrict__ xr,
                             const float* __restrict__ xi,
                             float* __restrict__ yr, float* __restrict__ yi,
                             const float* __restrict__ twc,
                             const float* __restrict__ tws, int n) {
  for (int t = threadIdx.x; t < n / 2; t += kThreads) {
    const float ar = xr[t], ai = xi[t];
    const float br = xr[t + n / 2], bi = xi[t + n / 2];
    const float c = __ldg(twc + t), s = __ldg(tws + t);
    const float dr = ar - br, di = ai - bi;
    yr[2 * t] = ar + br;
    yi[2 * t] = ai + bi;
    yr[2 * t + 1] = dr * c - di * s;
    yi[2 * t + 1] = dr * s + di * c;
  }
}

// One radix-4 Stockham pass (inverse transform, e^{+}) at stride s =
// 1 << ls over nfull points: butterfly t reads x[t + k nfull/4] and writes
// y[q + s (4 p + k)], p = t >> ls, q = t & (s - 1), k < 4, with the
// twiddles e^{2 pi i k p s / nfull}.
__device__ inline void pass4(const float* __restrict__ xr,
                             const float* __restrict__ xi,
                             float* __restrict__ yr, float* __restrict__ yi,
                             const float* __restrict__ twc,
                             const float* __restrict__ tws, int nfull,
                             int ls) {
  const int quarter = nfull / 4;
  for (int t = threadIdx.x; t < quarter; t += kThreads) {
    const int q = t & ((1 << ls) - 1);
    const int ps = t - q;                       // p * s
    const float ar = xr[t], ai = xi[t];
    const float br = xr[t + quarter], bi = xi[t + quarter];
    const float cr = xr[t + 2 * quarter], ci = xi[t + 2 * quarter];
    const float dr = xr[t + 3 * quarter], di = xi[t + 3 * quarter];
    const float w1r = __ldg(twc + ps), w1i = __ldg(tws + ps);
    const float w2r = __ldg(twc + 2 * ps), w2i = __ldg(tws + 2 * ps);
    const float w3r = w1r * w2r - w1i * w2i, w3i = w1r * w2i + w1i * w2r;
    const float apcr = ar + cr, apci = ai + ci;
    const float amcr = ar - cr, amci = ai - ci;
    const float bpdr = br + dr, bpdi = bi + di;
    // i (b - d)
    const float jr = -(bi - di), ji = br - dr;
    const int o = q + 4 * ps;
    const int s = 1 << ls;
    yr[o] = apcr + bpdr;
    yi[o] = apci + bpdi;
    float ur = amcr + jr, ui = amci + ji;       // k = 1
    yr[o + s] = ur * w1r - ui * w1i;
    yi[o + s] = ur * w1i + ui * w1r;
    ur = apcr - bpdr, ui = apci - bpdi;         // k = 2
    yr[o + 2 * s] = ur * w2r - ui * w2i;
    yi[o + 2 * s] = ur * w2i + ui * w2r;
    ur = amcr - jr, ui = amci - ji;             // k = 3
    yr[o + 3 * s] = ur * w3r - ui * w3i;
    yi[o + 3 * s] = ur * w3i + ui * w3r;
  }
}

// Number of passes of idft_symbol for nfft = 1 << logn.
__host__ __device__ inline int idft_passes(int logn) {
  return (logn & 1) + logn / 2;
}

// Inverse DFT (unscaled, e^{+2 pi i k t / n}) of one symbol's spectrum
// planes gre/gim. The spectrum is loaded into (p0r, p0i); the passes
// alternate with (p1r, p1i); the result is in p0 if idft_passes(logn) is
// even, else in p1. Starts and ends with a barrier.
__device__ inline void idft_symbol(const float* __restrict__ gre,
                                   const float* __restrict__ gim,
                                   float* p0r, float* p0i, float* p1r,
                                   float* p1i,
                                   const float* __restrict__ twc,
                                   const float* __restrict__ tws, int n,
                                   int logn) {
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += kThreads) {
    p0r[k] = gre[k];
    p0i[k] = gim[k];
  }
  __syncthreads();
  int ls = 0;
  if (logn & 1) {
    pass2(p0r, p0i, p1r, p1i, twc, tws, n);
    __syncthreads();
    float* t = p0r; p0r = p1r; p1r = t;
    t = p0i; p0i = p1i; p1i = t;
    ls = 1;
  }
  for (; ls < logn; ls += 2) {
    pass4(p0r, p0i, p1r, p1i, twc, tws, n, ls);
    __syncthreads();
    float* t = p0r; p0r = p1r; p1r = t;
    t = p0i; p0i = p1i; p1i = t;
  }
}

// Timeline samples [o0, o0 + count) of a symbol (0 = first CP sample)
// from its IDFT output, signed, scaled and phase-compensated, into
// out_re/out_im[0..count).
__device__ inline void emit_symbol(const float* __restrict__ fre,
                                   const float* __restrict__ fim, int nfft,
                                   int cp, float scale, float pc_re,
                                   float pc_im, int o0, int count,
                                   float* __restrict__ out_re,
                                   float* __restrict__ out_im) {
  for (int k = threadIdx.x; k < count; k += kThreads) {
    const int src = cp_source(o0 + k, cp, nfft);
    const float sgn = (src & 1) ? -scale : scale;
    const float re = fre[src] * sgn, im = fim[src] * sgn;
    out_re[k] = re * pc_re - im * pc_im;
    out_im[k] = re * pc_im + im * pc_re;
  }
}

__device__ inline void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ inline void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 5 blocks per SM at most 51 registers a thread: at nfft 1024 (18 KB of
// shared memory) the 245.76 Msps sweep's 560 blocks then fit one wave
__global__ void __launch_bounds__(kThreads, 5)
duc_from_spec_kernel(const float* __restrict__ spec,
                     const int* __restrict__ cps,
                     const int* __restrict__ tiles,
                     const float* __restrict__ pc,
                     const float* __restrict__ tw,
                     const float* __restrict__ h, const float* __restrict__ g,
                     float* __restrict__ z, int nant, int n_slots, int nfft,
                     int logn, int n1, int n2, int win) {
  extern __shared__ __align__(16) float smem[];
  __shared__ SlotLayout lay;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int n_sym = 14 * n_slots;
  const int sym = blockIdx.x, a = blockIdx.y;
  // a padding block only takes part in the cluster barriers
  const bool real = sym < n_sym;
  const Geometry gm = geometry(n1, n2);
  float* sh = smem;
  float* sge = sh + gm.n1p;
  float* sgo = sge + gm.kp;
  float* sxr = sgo + gm.kp;     // window, real plane; imaginary at + win
  float* sxi = sxr + win;
  float* ar = sxi + win;        // IDFT buffer A, later the FIR intermediate
  float* ai = ar + nfft;
  float* sy = ar;
  const int hl = gm.hl, hr = gm.hr;
  float* br = sxr + hl;         // IDFT buffer B: the window's middle
  float* bi = sxi + hl;
  const int m = sym % 14, s = sym / 14;
  int len = 0, sym_start = 0, t = 0;
  if (real) {
    load_slot_layout(&lay, cps, nfft);
    load_taps(gm, h, n1, g, sh, sge, sgo);
    t = n_slots * lay.start[14];
    len = lay.cp[m] + nfft;
    sym_start = s * lay.start[14] + lay.start[m];
    const float* twc = tw;
    const float* tws = tw + nfft / 2;
    const float scale = rsqrtf(static_cast<float>(nfft));
    const size_t plane = static_cast<size_t>(n_slots) * 14 * nfft;
    const float* sre = spec + static_cast<size_t>(a) * plane;
    const float* sim = spec + static_cast<size_t>(nant + a) * plane;
    const bool even = (idft_passes(logn) & 1) == 0;
    // where an IDFT loaded into A ends
    const float* ra = even ? ar : br;
    const float* ia = even ? ai : bi;

    // the cluster's first block: the last hl samples of symbol sym - 1
    if (rank == 0 && sym > 0) {
      const int mp = (sym - 1) % 14;
      const size_t off = static_cast<size_t>(sym - 1) * nfft;
      idft_symbol(sre + off, sim + off, ar, ai, br, bi, twc, tws, nfft, logn);
      emit_symbol(ra, ia, nfft, lay.cp[mp], scale, pc[2 * mp],
                  pc[2 * mp + 1], lay.cp[mp] + nfft - hl, hl, sxr, sxi);
    }
    // its last block: the first hr samples of symbol sym + 1
    if (rank == csize - 1 && sym + 1 < n_sym) {
      const int mn = (sym + 1) % 14;
      const size_t off = static_cast<size_t>(sym + 1) * nfft;
      idft_symbol(sre + off, sim + off, ar, ai, br, bi, twc, tws, nfft, logn);
      emit_symbol(ra, ia, nfft, lay.cp[mn], scale, pc[2 * mn],
                  pc[2 * mn + 1], 0, hr, sxr + hl + len, sxi + hl + len);
    }
    // own symbol, loaded so that it ends in A: the window's middle, which
    // holds B, is written from it
    const size_t off = static_cast<size_t>(sym) * nfft;
    if (even)
      idft_symbol(sre + off, sim + off, ar, ai, br, bi, twc, tws, nfft, logn);
    else
      idft_symbol(sre + off, sim + off, br, bi, ar, ai, twc, tws, nfft, logn);
    emit_symbol(ar, ai, nfft, lay.cp[m], scale, pc[2 * m], pc[2 * m + 1], 0,
                len, br, bi);
  }
  // The tiles of the plan's table (tile length, the run [lo, hi) of
  // tiles that read no halo sample): that run while the neighbours
  // publish, the others once the halos are in.
  const int n_out = 2 * len;
  const int tile = real ? __ldg(tiles + 3 * m) : 1;
  const int lo = real ? __ldg(tiles + 3 * m + 1) : 0;
  const int hi = real ? __ldg(tiles + 3 * m + 2) : 0;
  const int n_tiles = (n_out + tile - 1) / tile;
  float* zre = z + static_cast<size_t>(a) * 2 * t;
  const size_t zplane = static_cast<size_t>(nant) * 2 * t;
  cluster_arrive();
  if (real) {
    __syncthreads();
    for (int i = lo; i < hi; ++i)
      fir_up2_tiles<2>(gm, sxr + i * tile / 2, win, sy, sh, sge, sgo, t,
                       2 * sym_start + i * tile, min(tile, n_out - i * tile),
                       zre, zplane);
  }
  // every block of the cluster has published its timeline
  cluster_wait();
  if (real) {
    if (sym == 0) {
      for (int k = threadIdx.x; k < hl; k += kThreads) sxr[k] = sxi[k] = 0.f;
    } else if (rank > 0) {
      // the neighbour's timeline ends at its window index hl + len_prev
      const float* rr = cluster.map_shared_rank(sxr, rank - 1);
      const int from = lay.cp[(sym - 1) % 14] + nfft;
      for (int k = threadIdx.x; k < hl; k += kThreads) {
        sxr[k] = rr[from + k];
        sxi[k] = rr[win + from + k];
      }
    }
    float* right_r = sxr + hl + len;
    float* right_i = sxi + hl + len;
    if (sym == n_sym - 1) {
      for (int k = threadIdx.x; k < hr; k += kThreads)
        right_r[k] = right_i[k] = 0.f;
    } else if (rank < csize - 1) {
      const float* rr = cluster.map_shared_rank(sxr, rank + 1);
      for (int k = threadIdx.x; k < hr; k += kThreads) {
        right_r[k] = rr[hl + k];
        right_i[k] = rr[win + hl + k];
      }
    }
  }
  // done reading the neighbours; they may exit once all have arrived
  cluster_arrive();
  if (real) {
    __syncthreads();
    for (int i = 0; i < n_tiles; ++i)
      if (i < lo || i >= hi)
        fir_up2_tiles<2>(gm, sxr + i * tile / 2, win, sy, sh, sge, sgo, t,
                         2 * sym_start + i * tile,
                         min(tile, n_out - i * tile), zre, zplane);
  }
  cluster_wait();
}

}  // namespace

// spec (2 nant, n_slots, 14, nfft) padded spectrum planes (real planes
// first) -> z (2 nant, 2 n_slots slot_samples) waveform planes (real
// planes first), contiguous float32 on the device. cps (14) int32 CP
// lengths, tiles (14, 3) int32 the plan's tile table (tile length, first
// and last + 1 halo-free tile, per symbol of a slot), pc (14, 2) float32
// phase compensation (re, im) per symbol, tw (2, nfft / 2) float32 cos
// and sin of 2 pi q / nfft, h (n1) FIR taps, g (n2) halfband taps already
// scaled by sqrt(2), all on the device. cluster: blocks (symbols) per
// thread-block cluster, 1..16; win: floats of a window plane; smem: bytes
// of dynamic shared memory (taps, two window planes, the IDFT's buffer);
// all from the host plan (ops/filters.py:duc_plan), which checks that
// they fit. Returns the CUDA error of the launch (0 on success;
// cudaErrorInvalidConfiguration where the card cannot place such a
// cluster). Launches on `stream`, does not synchronise.
extern "C" int duc_from_spec(const float* spec, const int* cps,
                             const int* tiles, const float* pc,
                             const float* tw, const float* h, const float* g,
                             float* z, int nant, int n_slots, int nfft,
                             int slot_samples, int n1, int n2, int cluster,
                             int win, int smem, void* stream) {
  if (nant <= 0 || n_slots <= 0) return 0;
  int logn = 0;
  while ((1 << logn) < nfft) ++logn;
  if (nant > 65535 || n_slots > 65535 * 8 || n1 <= 0 || n2 < 3 ||
      nfft < 4 || (1 << logn) != nfft || cluster < 1 || cluster > 16 ||
      win <= 0 || smem <= 0 || 2LL * n_slots * slot_samples > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  // each once per size reached: the opt-in above 48 KB, the non-portable
  // cluster sizes, and whether a cluster of this size is placed with this
  // much shared memory per block (a cluster the card cannot place is an
  // error, not a slower launch)
  static int opted = 48 * 1024;
  static bool nonportable = false;
  static int placed[17] = {};
  cudaError_t err = cudaSuccess;
  if (smem > opted) {
    err = cudaFuncSetAttribute(duc_from_spec_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  if (cluster > 8 && !nonportable) {
    err = cudaFuncSetAttribute(duc_from_spec_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return static_cast<int>(err);
    nonportable = true;
  }
  const int n_sym = 14 * n_slots;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_sym + cluster - 1) / cluster * cluster, nant, 1);
  cfg.blockDim = dim3(duc::kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (smem > placed[cluster]) {
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(&active, duc_from_spec_kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (active < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    placed[cluster] = smem;
  }
  err = cudaLaunchKernelEx(&cfg, duc_from_spec_kernel, spec, cps, tiles, pc,
                           tw, h, g, z, nant, n_slots, nfft, logn, n1, n2,
                           win);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
