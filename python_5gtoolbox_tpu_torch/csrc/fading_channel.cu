// The multipath fading channel of NrChannelModel.filter: every path's
// sum-of-sinusoids taps made on the chip, applied to the TX samples and
// summed over the paths, in one launch.
//
// Replaces no TPU kernel: the JAX package's fading generator
// (python_5gtoolbox_tpu/models/channel.py: rayleigh_filters,
// rician_filters, gen_mimo_channel and the path loop of
// NrChannelModel.filter) is plain jnp. It was added because the plain
// version (python_5gtoolbox_tpu_torch/models/channel.py:
// NrChannelModel.filter_plain) materialises, for every path, (links,
// sinusoids, samples) float32 tensors for the arguments and the cosines
// (1.18 GB each at 8 links, 30 sinusoids and a 20-slot point of 1,228,800
// samples), then the (samples, Nr, Nt) taps, their product with the TX
// samples and a shifted copy: some 17 launches and gigabytes of device
// traffic a path, where the result is (Nr, samples).
//
// For every output sample n and RX antenna r:
//   out[r, n] = sum_p g_p sum_t H_p[n - d_p, r, t] tx[t, n - d_p]
// (a term is 0 where n - d_p lies outside [0, N)), with
//   H_p[m, r, t] = (L vec_p[:, m])[t nr + r], L the Cholesky factor
//   vec_p[l, m]  = amp sum_k cos(w m cos(seta_lk) + phase1_lk)
//                + j amp sum_k cos(w m sin(seta_lk) + phase2_lk)
//   and on a Rician path vec_p / sqrt(K + 1)
//                + sqrt(K / (K + 1)) exp(j (2 pi fdo / fs m + phase0_l)),
// where phase1, phase2, seta and phase0 are (2 u - 1) pi of the uniforms u
// that the plain path draws, in its order (the wrapper draws them).
//
// Bound on the H100: per sample, path and link 2 n_sin cosine terms
// (TDL-A 2x4: 23 x 8 x 30 x 2 = 11,040 terms a sample) against 8 (Nt + Nr)
// bytes a sample in and out: operations bind, by four orders of
// magnitude. Counting 4 FP32 instructions a term (the least that keeps
// each term's phase exact: one complex rotation), a 20-slot point of
// TDL-A 2x4 (1.36e10 terms) takes at least 1.6 ms at 33.5 T FP32
// instructions/s (132 SMs x 128 lanes x 1.98 GHz).
//
// Design:
// * A block owns a tile of consecutive output samples and walks the paths
//   in order; nothing of a path leaves the SM. Per path (1) the block turns
//   the path's uniforms into (cos seta, sin seta, phase1, phase2) for each
//   link and sinusoid, in shared memory; (2) a thread sums the sinusoids
//   of one link for 4 consecutive samples in registers and stores the
//   link's vec in shared memory; (3) a thread mixes the links of one
//   sample by L, multiplies by g_p tx[:, m] and adds to the sample's Nr
//   accumulators (shared memory, only ever touched by that thread). The
//   tile's (Nr, tile) result is written once, after the last path.
// * Each term is one hardware cosine, __cosf (SFU: a multiply by 1 / (2 pi)
//   then MUFU.COS; absolute error about 4e-7 at the arguments here), of the
//   argument rounded as the plain path rounds it: fl(fl(fl(m w) c) + phase)
//   with __fmul_rn / __fadd_rn, nothing contracted. No recurrence along the
//   samples, so no error grows with the sample index and the samples stay
//   independent. The SFU gives 16 cosines a clock on an SM against 128 FP32
//   lanes, so the kernel runs at the SFU's rate, 8 FP32 instructions' worth
//   a term (about twice the bound), with the other 4 instructions a term
//   issued beside it.
// * The tile holds tile x links = 2048 (1 to 16 links; tiles of 128 to
//   2048 samples): 2 groups of 4 samples a thread in step (2), and one
//   mixing loop over the padded link count NLP (1, 2, 4, 8, 16), a template
//   argument, so that the sample's links stay in registers. L is lower
//   triangular (a Cholesky factor, or 1 x 1), so H[i] takes links 0..i,
//   computed in place from the top row down.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;              // samples of one link a thread sums
constexpr int kTileLinks = 2048;     // tile samples x links
constexpr float kPi = 3.14159265358979f;

struct PathConst {     // a path's row of the constants (24 bytes)
  float gain;          // 10^(power dB / 20)
  int delay;           // samples
  int rician;          // 0 Rayleigh, 1 Rician
  float nlos;          // fl(1 / fl(sqrt(K + 1)))
  float los;           // sqrt(K / (K + 1))
  float fdo;           // 2 pi fdo / fs
};

struct Args {
  const float2* tx;         // (nt, n)
  const float* draws;       // (paths, 3, nl, n_sin): phase1, phase2, seta
  const float* draws0;      // (paths, nl): phase0 (read on Rician paths)
  const float2* l;          // (nl, nl)
  const PathConst* paths;   // (paths,)
  float2* out;              // (nr, n)
  int n, nt, nr, nl, n_paths, n_sin, tile;
  float w, amp;
};

__device__ __forceinline__ float phase_of(float u) {     // (2 u - 1) pi
  return __fmul_rn(__fsub_rn(__fmul_rn(u, 2.f), 1.f), kPi);
}

__device__ __forceinline__ float2 cfma(float2 a, float2 b, float2 c) {
  return make_float2(fmaf(-a.y, b.y, fmaf(a.x, b.x, c.x)),
                     fmaf(a.y, b.x, fmaf(a.x, b.y, c.y)));
}

template <int NLP>
__global__ void __launch_bounds__(kThreads)
fading_channel_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float4 smem[];
  const int tile = a.tile, nl = a.nl, ns = a.n_sin, tid = threadIdx.x;
  float4* prm = smem;                                        // (nl, ns)
  float2* ls = reinterpret_cast<float2*>(prm + nl * ns);     // (NLP, NLP)
  float2* vec = ls + NLP * NLP;                              // (nl, tile)
  float2* acc = vec + nl * tile;                             // (nr, tile)
  float* ph0 = reinterpret_cast<float*>(acc + a.nr * tile);  // (nl,)
  const int n0 = blockIdx.x * tile;
  const float2 zero = make_float2(0.f, 0.f);

  for (int i = tid; i < NLP * NLP; i += kThreads) {
    const int r = i / NLP, c = i % NLP;
    ls[i] = r < nl && c < nl ? a.l[r * nl + c] : zero;
  }
  for (int i = tid; i < a.nr * tile; i += kThreads) acc[i] = zero;

  const int quads = tile / kPer;
  for (int p = 0; p < a.n_paths; ++p) {
    const PathConst pc = a.paths[p];
    // (1) the path's sinusoids
    const float* u = a.draws + static_cast<size_t>(p) * 3 * nl * ns;
    for (int i = tid; i < nl * ns; i += kThreads) {
      float s, c;
      sincosf(phase_of(u[2 * nl * ns + i]), &s, &c);
      prm[i] = make_float4(c, s, phase_of(u[i]), phase_of(u[nl * ns + i]));
    }
    if (pc.rician && tid < nl) ph0[tid] = phase_of(a.draws0[p * nl + tid]);
    __syncthreads();

    // (2) vec of one link at kPer consecutive samples
    for (int q = tid; q < nl * quads; q += kThreads) {
      const int l = q / quads, j0 = (q - l * quads) * kPer;
      int m[kPer];
      float wm[kPer], ci[kPer], cq[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        m[i] = n0 + j0 + i - pc.delay;
        wm[i] = __fmul_rn(static_cast<float>(m[i]), a.w);
        ci[i] = 0.f;
        cq[i] = 0.f;
      }
      const float4* pk = prm + l * ns;
      for (int k = 0; k < ns; ++k) {
        const float4 c = pk[k];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          ci[i] += __cosf(__fadd_rn(__fmul_rn(wm[i], c.x), c.z));
          cq[i] += __cosf(__fadd_rn(__fmul_rn(wm[i], c.y), c.w));
        }
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        float2 v = make_float2(__fmul_rn(a.amp, ci[i]),
                               __fmul_rn(a.amp, cq[i]));
        if (pc.rician) {
          float s, c;
          sincosf(__fadd_rn(__fmul_rn(static_cast<float>(m[i]), pc.fdo),
                            ph0[l]), &s, &c);
          v = make_float2(__fadd_rn(__fmul_rn(v.x, pc.nlos),
                                    __fmul_rn(c, pc.los)),
                          __fadd_rn(__fmul_rn(v.y, pc.nlos),
                                    __fmul_rn(s, pc.los)));
        }
        vec[l * tile + j0 + i] = m[i] >= 0 && m[i] < a.n ? v : zero;
      }
    }
    __syncthreads();

    // (3) mix by L, apply to g tx, accumulate; thread j owns column j
    for (int j = tid; j < tile; j += kThreads) {
      const int m = n0 + j - pc.delay;
      if (n0 + j >= a.n || m < 0 || m >= a.n) continue;
      float2 h[NLP];
#pragma unroll
      for (int l = 0; l < NLP; ++l) h[l] = l < nl ? vec[l * tile + j] : zero;
#pragma unroll
      for (int i = NLP - 1; i >= 0; --i) {
        float2 s = zero;
#pragma unroll
        for (int l = 0; l <= i; ++l) s = cfma(ls[i * NLP + l], h[l], s);
        h[i] = s;
      }
      float2 x = a.tx[m];
      float2 gx = make_float2(__fmul_rn(x.x, pc.gain),
                              __fmul_rn(x.y, pc.gain));
      int t = 0, r = 0;
#pragma unroll
      for (int i = 0; i < NLP; ++i) {
        if (i < nl) {
          float2* o = acc + r * tile + j;
          *o = cfma(h[i], gx, *o);
          if (++r == a.nr && ++t < a.nt) {
            r = 0;
            x = a.tx[static_cast<size_t>(t) * a.n + m];
            gx = make_float2(__fmul_rn(x.x, pc.gain),
                             __fmul_rn(x.y, pc.gain));
          }
        }
      }
    }
    // the next path's step (1) writes prm and ph0 only, which step (3)
    // does not read; its barrier comes before step (2) writes vec
  }

  for (int j = tid; j < tile; j += kThreads) {
    if (n0 + j >= a.n) break;
    for (int r = 0; r < a.nr; ++r)
      a.out[static_cast<size_t>(r) * a.n + n0 + j] = acc[r * tile + j];
  }
}

template <int NLP>
int launch(const Args& a, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fading_channel_kernel<NLP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (a.n + a.tile - 1) / a.tile;
  fading_channel_kernel<NLP><<<blocks, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// consts: L (nl, nl) complex64, then n_paths PathConst rows
extern "C" int fading_channel(const void* tx, const float* draws,
                              const float* draws0, const void* consts,
                              void* out, int n, int nt, int nr, int n_paths,
                              int n_sin, float w, float amp, void* stream) {
  if (n == 0) return 0;
  const int nl = nt * nr;
  if (n < 0 || nt < 1 || nr < 1 || nl > 16 || n_paths < 1 || n_sin < 1 ||
      n_sin > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  int tile = kTileLinks / nl / 128 * 128;
  if (tile < 128) tile = 128;
  int nlp = 1;
  while (nlp < nl) nlp *= 2;
  const char* c = static_cast<const char*>(consts);
  const Args a{static_cast<const float2*>(tx), draws, draws0,
               reinterpret_cast<const float2*>(c),
               reinterpret_cast<const PathConst*>(c + sizeof(float2) * nl *
                                                  nl),
               static_cast<float2*>(out), n, nt, nr, nl, n_paths, n_sin, tile,
               w, amp};
  const size_t smem = sizeof(float4) * nl * n_sin +
                      sizeof(float2) * (nlp * nlp + (nl + nr) * tile) +
                      sizeof(float) * nl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nlp) {
    case 1: return launch<1>(a, smem, s);
    case 2: return launch<2>(a, smem, s);
    case 4: return launch<4>(a, smem, s);
    case 8: return launch<8>(a, smem, s);
    default: return launch<16>(a, smem, s);
  }
}
