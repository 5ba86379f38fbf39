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
// machinery is carried over. Here one block serves one (symbol, slot,
// antenna):
//
//   1. a Stockham autosort IDFT in shared memory (radix 4, one radix-2
//      pass first when log2 nfft is odd; FP32, twiddles from a table
//      computed in float64) of the previous and of the next symbol of the
//      waveform, of which only the filters' halos are kept (zeros before
//      the first slot and after the last: no clamped neighbour), then of
//      the block's own symbol. The passes go to and fro between two
//      buffers in natural order, so no pass and no load is bit-reversed
//      and every read is conflict-free; the second buffer lies in the
//      middle of the timeline window, which is written only afterwards;
//   2. per output sample the (-1)^t sign of the centre ifftshift, the
//      1/sqrt(nfft) scale (amplitude ifft * sqrt(nfft)) and the symbol's
//      phase compensation, while the CP timeline window
//      [halo | CP | data | halo] is written to shared memory; the CP of a
//      symbol is the tail of its own compensated IDFT output;
//   3. duc::fir_up2_tile over the window, real plane then imaginary.
//
// A block per symbol computes three IDFTs for one symbol of output, where
// a block per slot would compute 16 for 14. The IDFT is about 4 % of the
// stage's operations, so this buys 14 times as many blocks (1792 for 64
// slots x 2 antennas on 132 SMs) and a window that fits in shared memory
// (72 KB at nfft 4096 with 287 taps) for about 10 % more arithmetic.
//
// Bound on the H100: per 1x complex sample 2 x (n1 + n2) FMAs against
// about 7.5 bytes in and 16 bytes out: operation-bound against the 67
// TFLOP/s FP32 peak.
#include "duc_common.cuh"

namespace {

using namespace duc;

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

__global__ void __launch_bounds__(kThreads)
duc_from_spec_kernel(const float* __restrict__ spec,
                     const int* __restrict__ cps,
                     const float* __restrict__ pc,
                     const float* __restrict__ tw,
                     const float* __restrict__ h, const float* __restrict__ g,
                     float* __restrict__ z, int nant, int n_slots, int nfft,
                     int logn, int n1, int n2, int win) {
  extern __shared__ __align__(16) float smem[];
  __shared__ SlotLayout lay;
  const Geometry gm = geometry(n1, n2);
  float* sh = smem;
  float* sge = sh + gm.n1p;
  float* sgo = sge + gm.kp;
  float* sxr = sgo + gm.kp;
  float* sxi = sxr + win;
  float* ar = sxi + win;        // IDFT buffer A, later the FIR intermediate
  float* ai = ar + nfft;
  float* sy = ar;
  const int hl = gm.hl, hr = gm.hr;
  float* br = sxr + hl;         // IDFT buffer B: the window's middle
  float* bi = sxi + hl;
  const int m = blockIdx.x, s = blockIdx.y, a = blockIdx.z;
  load_slot_layout(&lay, cps, nfft);
  load_taps(gm, h, n1, g, sh, sge, sgo);
  const int slot_samples = lay.start[14];
  const int t = n_slots * slot_samples;
  const int cp = lay.cp[m];
  const int len = cp + nfft;
  const int sym_start = s * slot_samples + lay.start[m];
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

  // left halo: the last hl samples of the previous symbol of the waveform
  if (m == 0 && s == 0) {
    for (int k = threadIdx.x; k < hl; k += kThreads) sxr[k] = sxi[k] = 0.f;
  } else {
    const int mp = m == 0 ? 13 : m - 1, sp = m == 0 ? s - 1 : s;
    const size_t off = (static_cast<size_t>(sp) * 14 + mp) * nfft;
    idft_symbol(sre + off, sim + off, ar, ai, br, bi, twc, tws, nfft, logn);
    emit_symbol(ra, ia, nfft, lay.cp[mp], scale, pc[2 * mp], pc[2 * mp + 1],
                lay.cp[mp] + nfft - hl, hl, sxr, sxi);
  }

  // right halo: the first hr samples of the next symbol of the waveform
  if (m == 13 && s == n_slots - 1) {
    for (int k = threadIdx.x; k < hr; k += kThreads)
      sxr[hl + len + k] = sxi[hl + len + k] = 0.f;
  } else {
    const int mn = m == 13 ? 0 : m + 1, sn = m == 13 ? s + 1 : s;
    const size_t off = (static_cast<size_t>(sn) * 14 + mn) * nfft;
    idft_symbol(sre + off, sim + off, ar, ai, br, bi, twc, tws, nfft, logn);
    emit_symbol(ra, ia, nfft, lay.cp[mn], scale, pc[2 * mn], pc[2 * mn + 1],
                0, hr, sxr + hl + len, sxi + hl + len);
  }

  // own symbol, loaded so that it ends in A: the window's middle, which
  // holds B, is written from it
  {
    const size_t off = (static_cast<size_t>(s) * 14 + m) * nfft;
    if (even)
      idft_symbol(sre + off, sim + off, ar, ai, br, bi, twc, tws, nfft, logn);
    else
      idft_symbol(sre + off, sim + off, br, bi, ar, ai, twc, tws, nfft, logn);
    emit_symbol(ar, ai, nfft, cp, scale, pc[2 * m], pc[2 * m + 1], 0, len,
                sxr + hl, sxi + hl);
  }
  __syncthreads();

  float* zre = z + static_cast<size_t>(a) * 2 * t;
  float* zim = z + static_cast<size_t>(nant + a) * 2 * t;
  for (int u0 = 0; u0 < 2 * len; u0 += gm.nz_tile) {
    const int nz = min(gm.nz_tile, 2 * len - u0);
    fir_up2_tile(gm, sxr + u0 / 2, sy, sh, sge, sgo, t, 2 * sym_start + u0,
                 nz, zre);
    fir_up2_tile(gm, sxi + u0 / 2, sy, sh, sge, sgo, t, 2 * sym_start + u0,
                 nz, zim);
  }
}

}  // namespace

// spec (2 nant, n_slots, 14, nfft) padded spectrum planes (real planes
// first) -> z (2 nant, 2 n_slots slot_samples) waveform planes (real
// planes first), contiguous float32 on the device. cps (14) int32 CP
// lengths, pc (14, 2) float32 phase compensation (re, im) per symbol, tw
// (2, nfft / 2) float32 cos and sin of 2 pi q / nfft, h (n1) FIR taps,
// g (n2) halfband taps already scaled by sqrt(2), all on the device.
// cp_min / cp_max: the smallest and largest CP. Returns the CUDA error of
// the launch (0 on success). Launches on `stream`, does not synchronise.
extern "C" int duc_from_spec(const float* spec, const int* cps,
                             const float* pc, const float* tw, const float* h,
                             const float* g, float* z, int nant, int n_slots,
                             int nfft, int slot_samples, int cp_min,
                             int cp_max, int n1, int n2, void* stream) {
  if (nant <= 0 || n_slots <= 0) return 0;
  int logn = 0;
  while ((1 << logn) < nfft) ++logn;
  if (nant > 65535 || n_slots > 65535 || n1 <= 0 || n2 < 3 || nfft < 4 ||
      (1 << logn) != nfft || cp_min < 0 || cp_max < cp_min ||
      2LL * n_slots * slot_samples > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const duc::Geometry gm = duc::geometry(n1, n2);
  // a halo comes from one neighbouring symbol only
  if (gm.nz_tile < 8 || gm.hl > cp_min + nfft || gm.hr > cp_min + nfft)
    return static_cast<int>(cudaErrorInvalidValue);
  const int win = duc::round_up4(gm.hl + cp_max + nfft + gm.hr);
  const int scratch = 2 * nfft > duc::kTileY ? 2 * nfft : duc::kTileY;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(gm.n1p) + 2 * gm.kp + 2 * win + scratch);
  if (smem > 226 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      duc_from_spec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(14, n_slots, nant);
  duc_from_spec_kernel<<<grid, duc::kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      spec, cps, pc, tw, h, g, z, nant, n_slots, nfft, logn, n1, n2, win);
  return static_cast<int>(cudaGetLastError());
}
