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
// A front end fills a shared-memory window of the 1x timeline (zeros
// outside the waveform) and calls fir_up2_tile once per tile of outputs.
#pragma once
#include <cuda_runtime.h>

namespace duc {

constexpr int kThreads = 256;
constexpr int kPer = 4;                   // consecutive outputs per thread
constexpr int kTileY = kThreads * kPer;   // FIR outputs held per tile

__host__ __device__ inline int round_up4(int a) { return (a + 3) & ~3; }

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
  int nz_tile;    // largest tile of outputs whose FIR outputs fit kTileY
  int hl, hr;     // timeline samples read left of the first / right of
                  // the last input sample of a run of tiles
};

__host__ __device__ inline Geometry geometry(int n1, int n2) {
  Geometry gm;
  const int b1 = n1 - 1 - n1 / 2, b2 = n2 / 2 - 1;
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
  gm.n1p = round_up4(n1);
  // the oldest FIR output an aligned branch reads is y[v + d - (kp - 1)]
  gm.off = gm.kp;
  gm.y_back = gm.off - d;
  gm.x_back = gm.n1p - b1;
  // FIR outputs of a tile: nz/2 + off (the last one is y[v_last + d])
  gm.nz_tile = 2 * ((kTileY - gm.off) & ~3);
  gm.hl = gm.y_back + gm.x_back;
  gm.hr = b1 + d + 3;     // + 3: outputs are computed in fours
  return gm;
}

// floats of shared memory the taps and the FIR intermediate take
__host__ __device__ inline int fixed_floats(const Geometry& gm) {
  return gm.n1p + 2 * gm.kp + kTileY;
}

// h, g -> zero-padded FIR taps sh[n1p] and aligned halfband branches
// sge[kp], sgo[kp]. Ends without a barrier.
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

// One tile of the fused pair: writes zp[u] for u in [z0, z0 + nz), z0
// and nz even, 2 <= nz <= gm.nz_tile. sx (16-byte aligned) holds the
// timeline from x_lo = z0/2 - gm.hl on, n1p + round_up4(ny) finite floats
// with ny = nz/2 + gm.off; sy holds kTileY floats. (nz_tile is a multiple
// of 8, so tiles nz_tile apart within one window keep the alignment.) All
// threads of the block call it; it ends with a barrier.
__device__ inline void fir_up2_tile(const Geometry& gm,
                                    const float* __restrict__ sx,
                                    float* __restrict__ sy,
                                    const float* __restrict__ sh,
                                    const float* __restrict__ sge,
                                    const float* __restrict__ sgo,
                                    int t_orig, int z0, int nz,
                                    float* __restrict__ zp) {
  const int nv = nz / 2;
  const int ny4 = round_up4(nv + gm.off);
  const int y_lo = z0 / 2 - gm.y_back;
  const int i0 = kPer * threadIdx.x;
  // y[y_lo + i] = sum_j h[j] sx[n1p + i - j]
  if (i0 < ny4) {
    const float4* sx4 = reinterpret_cast<const float4*>(sx);
    const float4* sh4 = reinterpret_cast<const float4*>(sh);
    const int a = (gm.n1p + i0) / 4;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    float4 hi = sx4[a];
    for (int q = 0; q < gm.n1p / 4; ++q) {
      const float4 lo = sx4[a - q - 1];
      fma16(acc, sh4[q], lo, hi);
      hi = lo;
    }
    const int t = y_lo + i0;
    float4 y;
    y.x = (t >= 0 && t < t_orig) ? acc[0] : 0.f;
    y.y = (t + 1 >= 0 && t + 1 < t_orig) ? acc[1] : 0.f;
    y.z = (t + 2 >= 0 && t + 2 < t_orig) ? acc[2] : 0.f;
    y.w = (t + 3 >= 0 && t + 3 < t_orig) ? acc[3] : 0.f;
    reinterpret_cast<float4*>(sy)[i0 / 4] = y;
  }
  __syncthreads();
  // z[z0 + 2 (i + c) + e] = sum_k G_e[k] sy[i + c + off - k]
  if (i0 < nv) {
    const float4* sy4 = reinterpret_cast<const float4*>(sy);
    const float4* sge4 = reinterpret_cast<const float4*>(sge);
    const float4* sgo4 = reinterpret_cast<const float4*>(sgo);
    const int a = (i0 + gm.off) / 4;
    float ev[4] = {0.f, 0.f, 0.f, 0.f}, od[4] = {0.f, 0.f, 0.f, 0.f};
    float4 hi = sy4[a];
    for (int q = 0; q < gm.kp / 4; ++q) {
      const float4 lo = sy4[a - q - 1];
      fma16(ev, sge4[q], lo, hi);
      fma16(od, sgo4[q], lo, hi);
      hi = lo;
    }
    float* out = zp + z0 + 2 * i0;
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
  __syncthreads();
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
