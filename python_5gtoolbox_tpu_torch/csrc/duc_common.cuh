// Common part of the three fused DUC kernels (fir_up2_fused.cu,
// fir_up2_fused_symbols.cu, duc_from_spec.cu): channel FIR in 'same'
// alignment, the mask between the stages, then the first halfband x2
// interpolator, with the 1x-rate intermediate kept in shared memory.
//
//   y[t] = sum_j h[j] x[t + b1 - j],   b1 = n1 - 1 - n1/2     (fir_same)
//   y[t] = 0 for t < 0 or t >= t_orig  (the serial pipeline truncates
//                                       fir_same to [0, T) before the
//                                       halfband sees it)
//   z[u] = sum_{j : u + b2 - j even} g[j] y[(u + b2 - j) / 2],
//          b2 = n2/2 - 1, g already scaled by sqrt(2)     (hb_upsample2)
//
// Every sum is a plain FP32 FMA chain. The halfband is run as its two
// polyphase branches, z[2v + e] = sum_k G_e[k] y[v + d - k], brought to a
// common delay d by a leading zero tap where needed, so both stages are
// the same loop: a thread owns kPer = 4 consecutive outputs and walks the
// taps four at a time; per step it loads one float4 of taps (a broadcast)
// and one new float4 of samples (the other four it needs are the previous
// step's), for 16 FMAs. That is 0.125 shared-memory loads per FMA, all of
// 16 bytes, conflict-free (threads 16 bytes apart), where one output per
// thread and tap would need 1.25. For the float4 loads every array starts
// on a multiple of 4 floats, tap counts are padded with zeros to
// multiples of 4, and a tile's windows start where the index of the first
// tap's sample is a multiple of 4; Geometry holds the resulting offsets.
//
// Per step of 4 taps a warp issues 4 wavefronts of samples and one of
// taps for 4 FMA cycles: shared memory, not the FMA pipe, sets the pace
// of a long FIR. fir_up2_tile8 gives a thread 8 consecutive FIR outputs
// instead, for 32 FMAs per new float4 of samples (5 wavefronts per 8 FMA
// cycles). Its threads read float4s 32 bytes apart, which would
// meet twice in each bank, so its window is split into its even and odd
// float4s (split()); a step reads one half at consecutive float4s, at
// offsets fixed per unrolled step.
//
// A front end fills a shared-memory window of the 1x timeline (zeros
// outside the waveform) and calls fir_up2_tiles (or fir_up2_tile8) once
// per tile of outputs.
#pragma once
#include <cuda_runtime.h>

namespace duc {

constexpr int kThreads = 256;
constexpr int kPer = 4;                   // consecutive outputs per thread
constexpr int kTileY = kThreads * kPer;   // FIR outputs held per tile

__host__ __device__ inline int round_up4(int a) { return (a + 3) & ~3; }

// Shared-memory float index of window float f in a split window: its
// even float4s first (half floats), then its odd ones. 8 outputs per
// thread read float4s 32 bytes apart, all of one parity at a time, so a
// quarter warp reads eight consecutive float4s of one half.
__host__ __device__ inline int split(int f, int half) {
  return ((f >> 2) & 1) * half + ((f >> 3) << 2) + (f & 3);
}

// cp.async into shared memory: 16 or 4 bytes from src when `in`, else
// zeros (src is then not read, but must be a valid address).
__device__ inline void copy16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                  "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ inline void copy4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                  "l"(src), "r"(in ? 4 : 0) : "memory");
}

__device__ inline void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n (0 or 1) of this thread's copy groups are in
// flight.
__device__ inline void wait_copies(int n) {
  if (n)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The packed taps of the host plan (ops/filters.py:fused_tap_blob):
// n1p FIR taps (lead zeros first) and the two aligned halfband branches
// of kp each, all multiples of 4 floats, into sh; one copy group not yet
// committed.
__device__ inline void copy_taps(float* sh, const float* taps, int floats) {
  for (int c = threadIdx.x; c < floats / 4; c += kThreads)
    copy16(sh + 4 * c, taps + 4 * c, true);
}

// Offsets of one (n1, n2) filter pair. A tile of halfband outputs
// [z0, z0 + nz), z0 even, reads FIR outputs from y_lo = z0/2 - y_back on;
// its FIR outputs read the timeline from x_lo = y_lo - x_back on.
struct Geometry {
  int n1p;        // FIR taps padded to a multiple of 4
  int kp;         // taps per halfband branch, aligned and padded
  int j0[2];      // first tap of branch e in g: g[j0 + 2 k']
  int shift[2];   // leading zero taps of branch e
  int kn[2];      // true taps of branch e
  int off;        // sy index of y[v + d] for the tile's first v
  int y_back;     // off - d
  int x_back;     // n1p - b1
  int nz_tile;    // largest tile of outputs whose FIR outputs fit the
                  // per * kThreads held per tile
  int hl, hr;     // timeline samples read left of the first / right of
                  // the last input sample of a run of tiles
};

// lead: zero taps put before the FIR's first (its delay grows with them,
// so y is unchanged), which moves hl by -lead mod 4; per: FIR outputs
// per thread (4, or 8 for fir_up2_tile8).
__host__ __device__ inline Geometry geometry(int n1, int n2, int lead = 0,
                                             int per = kPer) {
  Geometry gm;
  const int b1 = n1 - 1 - n1 / 2 + lead, b2 = n2 / 2 - 1;
  int dd[2];
  for (int e = 0; e < 2; ++e) {
    gm.j0[e] = (e + b2) & 1;
    dd[e] = (e + b2 - gm.j0[e]) / 2;
    gm.kn[e] = (n2 - gm.j0[e] + 1) / 2;
  }
  const int d = dd[0] > dd[1] ? dd[0] : dd[1];
  int k = 0;
  for (int e = 0; e < 2; ++e) {
    gm.shift[e] = d - dd[e];
    if (gm.kn[e] + gm.shift[e] > k) k = gm.kn[e] + gm.shift[e];
  }
  gm.kp = round_up4(k);
  gm.n1p = round_up4(n1 + lead);
  // the oldest FIR output an aligned branch reads is y[v + d - (kp - 1)]
  gm.off = gm.kp;
  gm.y_back = gm.off - d;
  gm.x_back = gm.n1p - b1;
  // FIR outputs of a tile: nz/2 + off (the last one is y[v_last + d])
  gm.nz_tile = 2 * ((kThreads * per - gm.off) & ~3);
  gm.hl = gm.y_back + gm.x_back;
  gm.hr = b1 + d + 3;     // + 3: outputs are computed in fours
  return gm;
}

// h, g -> zero-padded FIR taps sh[n1p] and aligned halfband branches
// sge[kp], sgo[kp] (duc_from_spec's tap load; the other two kernels copy
// the same layout in from the host-packed blob, copy_taps). Ends without
// a barrier.
__device__ inline void load_taps(const Geometry& gm,
                                 const float* __restrict__ h, int n1,
                                 const float* __restrict__ g,
                                 float* __restrict__ sh,
                                 float* __restrict__ sge,
                                 float* __restrict__ sgo) {
  for (int k = threadIdx.x; k < gm.n1p; k += kThreads)
    sh[k] = k < n1 ? h[k] : 0.f;
  for (int k = threadIdx.x; k < gm.kp; k += kThreads) {
    const int k0 = k - gm.shift[0], k1 = k - gm.shift[1];
    sge[k] = (k0 >= 0 && k0 < gm.kn[0]) ? g[gm.j0[0] + 2 * k0] : 0.f;
    sgo[k] = (k1 >= 0 && k1 < gm.kn[1]) ? g[gm.j0[1] + 2 * k1] : 0.f;
  }
}

// acc[c] += sum_{q < 4} t[q] * w[4 + c - q], w = (lo, hi) consecutive
__device__ inline void fma16(float acc[4], const float4& t, const float4& lo,
                             const float4& hi) {
  acc[0] = fmaf(t.x, hi.x, acc[0]);
  acc[0] = fmaf(t.y, lo.w, acc[0]);
  acc[0] = fmaf(t.z, lo.z, acc[0]);
  acc[0] = fmaf(t.w, lo.y, acc[0]);
  acc[1] = fmaf(t.x, hi.y, acc[1]);
  acc[1] = fmaf(t.y, hi.x, acc[1]);
  acc[1] = fmaf(t.z, lo.w, acc[1]);
  acc[1] = fmaf(t.w, lo.z, acc[1]);
  acc[2] = fmaf(t.x, hi.z, acc[2]);
  acc[2] = fmaf(t.y, hi.y, acc[2]);
  acc[2] = fmaf(t.z, hi.x, acc[2]);
  acc[2] = fmaf(t.w, lo.w, acc[2]);
  acc[3] = fmaf(t.x, hi.w, acc[3]);
  acc[3] = fmaf(t.y, hi.z, acc[3]);
  acc[3] = fmaf(t.z, hi.y, acc[3]);
  acc[3] = fmaf(t.w, hi.x, acc[3]);
}

// Halfband outputs z[z0 + 2 (i0 + c) + e], c < 4 (those below 2 nv),
// of NP planes from the FIR outputs in sy (planes sy_plane floats apart):
// z[z0 + 2 (i + c) + e] = sum_k G_e[k] sy[i + c + off - k].
template <int NP>
__device__ inline void halfband4(const Geometry& gm,
                                 const float* __restrict__ sy, int sy_plane,
                                 const float* __restrict__ sge,
                                 const float* __restrict__ sgo, int i0,
                                 int nv, int z0, float* __restrict__ zp,
                                 size_t zp_plane) {
  const float4* sge4 = reinterpret_cast<const float4*>(sge);
  const float4* sgo4 = reinterpret_cast<const float4*>(sgo);
  const int a = (i0 + gm.off) / 4;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const float4* sy4 = reinterpret_cast<const float4*>(sy + p * sy_plane);
    float ev[4] = {0.f, 0.f, 0.f, 0.f}, od[4] = {0.f, 0.f, 0.f, 0.f};
    float4 hi = sy4[a];
    for (int q = 0; q < gm.kp / 4; ++q) {
      const float4 lo = sy4[a - q - 1];
      fma16(ev, sge4[q], lo, hi);
      fma16(od, sgo4[q], lo, hi);
      hi = lo;
    }
    float* out = zp + p * zp_plane + z0 + 2 * i0;
    if (i0 + 3 < nv && (reinterpret_cast<size_t>(out) & 15) == 0) {
      reinterpret_cast<float4*>(out)[0] = make_float4(ev[0], od[0], ev[1],
                                                      od[1]);
      reinterpret_cast<float4*>(out)[1] = make_float4(ev[2], od[2], ev[3],
                                                      od[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (i0 + c < nv) {
          out[2 * c] = ev[c];
          out[2 * c + 1] = od[c];
        }
    }
  }
}

// Four FIR outputs y[t .. t + 3], masked to [0, t_orig), into sy.
__device__ inline void store_y4(float* __restrict__ sy, int t, int t_orig,
                                const float acc[4]) {
  float4 y;
  y.x = (t >= 0 && t < t_orig) ? acc[0] : 0.f;
  y.y = (t + 1 >= 0 && t + 1 < t_orig) ? acc[1] : 0.f;
  y.z = (t + 2 >= 0 && t + 2 < t_orig) ? acc[2] : 0.f;
  y.w = (t + 3 >= 0 && t + 3 < t_orig) ? acc[3] : 0.f;
  *reinterpret_cast<float4*>(sy) = y;
}

// One tile of the fused pair on NP planes: writes zp[p zp_plane + u] for
// u in [z0, z0 + nz), z0 and nz even, 2 <= nz <= gm.nz_tile. Plane p's
// window sx + p sx_plane (16-byte aligned) holds the timeline from x_lo =
// z0/2 - gm.hl on, n1p + round_up4(ny) finite floats with ny = nz/2 +
// gm.off; sy holds NP kTileY floats. (nz_tile is a multiple of 8, so
// tiles nz_tile apart within one window keep the alignment.) All threads
// of the block call it; it ends with a barrier.
template <int NP>
__device__ inline void fir_up2_tiles(const Geometry& gm,
                                     const float* __restrict__ sx,
                                     int sx_plane, float* __restrict__ sy,
                                     const float* __restrict__ sh,
                                     const float* __restrict__ sge,
                                     const float* __restrict__ sgo,
                                     int t_orig, int z0, int nz,
                                     float* __restrict__ zp,
                                     size_t zp_plane) {
  const int nv = nz / 2;
  const int ny4 = round_up4(nv + gm.off);
  const int y_lo = z0 / 2 - gm.y_back;
  const int i0 = kPer * threadIdx.x;
  // y[y_lo + i] = sum_j h[j] sx[n1p + i - j]
  if (i0 < ny4) {
    const float4* sh4 = reinterpret_cast<const float4*>(sh);
    const int a = (gm.n1p + i0) / 4;
    float acc[NP][4] = {};
    if (NP == 1) {
      const float4* sx4 = reinterpret_cast<const float4*>(sx);
      float4 hi = sx4[a];
      for (int q = 0; q < gm.n1p / 4; ++q) {
        const float4 lo = sx4[a - q - 1];
        fma16(acc[0], sh4[q], lo, hi);
        hi = lo;
      }
    } else {
      // the planes share each float4 of taps (the one-plane loop above
      // measured faster alone)
      float4 hi[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p)
        hi[p] = reinterpret_cast<const float4*>(sx + p * sx_plane)[a];
      for (int q = 0; q < gm.n1p / 4; ++q) {
        const float4 taps = sh4[q];
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const float4 lo =
              reinterpret_cast<const float4*>(sx + p * sx_plane)[a - q - 1];
          fma16(acc[p], taps, lo, hi[p]);
          hi[p] = lo;
        }
      }
    }
#pragma unroll
    for (int p = 0; p < NP; ++p)
      store_y4(sy + p * kTileY + i0, y_lo + i0, t_orig, acc[p]);
  }
  __syncthreads();
  if (i0 < nv) halfband4<NP>(gm, sy, kTileY, sge, sgo, i0, nv, z0, zp,
                             zp_plane);
  __syncthreads();
}

// fir_up2_tile with 8 FIR outputs per thread over a split window: window
// float f at sx[split(f, half)] holds the timeline from x_lo = z0/2 -
// gm.hl on, gm.n1p + round_up8(ny) finite floats, ny = nz/2 + gm.off; gm
// from geometry(n1, n2, lead, 8); sy holds 8 kThreads floats. The
// halfband keeps 4 outputs per thread (8 measured slower on the H100: the
// extra registers cost blocks per SM). All threads of the block call it;
// it ends with a barrier.
__device__ inline void fir_up2_tile8(const Geometry& gm,
                                     const float* __restrict__ sx, int half,
                                     float* __restrict__ sy,
                                     const float* __restrict__ sh,
                                     const float* __restrict__ sge,
                                     const float* __restrict__ sgo,
                                     int t_orig, int z0, int nz,
                                     float* __restrict__ zp) {
  const int nv = nz / 2;
  const int ny4 = round_up4(nv + gm.off);
  const int y_lo = z0 / 2 - gm.y_back;
  const int i0 = 8 * threadIdx.x;
  // y[y_lo + i] = sum_j h[j] x[n1p + i - j]. Step q (taps 4q .. 4q + 3)
  // needs the float4s k - 1 (new), k and k + 1 of the window, k = a - q,
  // a = (n1p + i0) / 4; with m = n1p / 4 - 1 the new one is float4 m - q
  // + 2 tid: half (m - q) & 1, index tid + (m - q) >> 1,
  // so step 2r reads pa[-r] and step 2r + 1 pb[-r]. Steps run six at a
  // time, the three float4s in use rotating through three registers
  // without moves.
  if (i0 < ny4) {
    const float4* sh4 = reinterpret_cast<const float4*>(sh);
    const int m = gm.n1p / 4 - 1;
    const float4* ev = reinterpret_cast<const float4*>(sx) + threadIdx.x;
    const float4* od =
        reinterpret_cast<const float4*>(sx + half) + threadIdx.x;
    const float4* pa = ((m & 1) ? od : ev) + (m >> 1);
    const float4* pb = ((m & 1) ? ev : od) + ((m - 1) >> 1);
    float acc[8] = {};
    float4 r0 = pa[1];                  // float4 a + 1
    float4 r1 = pb[1];                  // float4 a
    float4 r2;
    const int nq = gm.n1p / 4;
    int q = 0;
    // (lo, mid, hi) -> outputs 0-3 from (lo, mid), 4-7 from (mid, hi)
#define DUC_STEP8(T, LO, MID, HI) \
    fma16(acc, T, LO, MID);        \
    fma16(acc + 4, T, MID, HI)
    for (; q + 6 <= nq; q += 6) {
      const float4* a6 = pa - q / 2;
      const float4* b6 = pb - q / 2;
      r2 = a6[0];
      DUC_STEP8(sh4[q], r2, r1, r0);
      r0 = b6[0];
      DUC_STEP8(sh4[q + 1], r0, r2, r1);
      r1 = a6[-1];
      DUC_STEP8(sh4[q + 2], r1, r0, r2);
      r2 = b6[-1];
      DUC_STEP8(sh4[q + 3], r2, r1, r0);
      r0 = a6[-2];
      DUC_STEP8(sh4[q + 4], r0, r2, r1);
      r1 = b6[-2];
      DUC_STEP8(sh4[q + 5], r1, r0, r2);
    }
    for (; q < nq; ++q) {
      r2 = (q & 1) ? pb[-(q >> 1)] : pa[-(q >> 1)];
      DUC_STEP8(sh4[q], r2, r1, r0);
      r0 = r1;
      r1 = r2;
    }
#undef DUC_STEP8
    store_y4(sy + i0, y_lo + i0, t_orig, acc);
    store_y4(sy + i0 + 4, y_lo + i0 + 4, t_orig, acc + 4);
  }
  __syncthreads();
  for (int i = 4 * threadIdx.x; i < nv; i += 4 * kThreads)
    halfband4<1>(gm, sy, 8 * kThreads, sge, sgo, i, nv, z0, zp, 0);
  __syncthreads();
}

// fir_up2_tiles on one plane.
__device__ inline void fir_up2_tile(const Geometry& gm,
                                    const float* __restrict__ sx,
                                    float* __restrict__ sy,
                                    const float* __restrict__ sh,
                                    const float* __restrict__ sge,
                                    const float* __restrict__ sgo,
                                    int t_orig, int z0, int nz,
                                    float* __restrict__ zp) {
  fir_up2_tiles<1>(gm, sx, 0, sy, sh, sge, sgo, t_orig, z0, nz, zp, 0);
}

// Symbol boundaries of one slot's CP timeline in shared memory:
// start[m] = first sample of symbol m's CP, start[14] = slot_samples.
struct SlotLayout {
  int start[15];
  int cp[14];
};

__device__ inline void load_slot_layout(SlotLayout* lay,
                                        const int* __restrict__ cps,
                                        int nfft) {
  if (threadIdx.x == 0) {
    int off = 0;
    for (int m = 0; m < 14; ++m) {
      lay->cp[m] = cps[m];
      lay->start[m] = off;
      off += cps[m] + nfft;
    }
    lay->start[14] = off;
  }
  __syncthreads();
}

// sample o of symbol m's CP + data stretch -> index into its IDFT output
__device__ inline int cp_source(int o, int cp, int nfft) {
  return o < cp ? nfft - cp + o : o - cp;
}

}  // namespace duc
