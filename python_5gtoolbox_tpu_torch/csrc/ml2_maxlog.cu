// Exact max-log ML2 search over the full layer-product constellation, one
// warp per resource element (RE).
//
// Replaces no TPU kernel: the JAX package's ML2
// (python_5gtoolbox_tpu/rx/equalize.py:ml2) is plain jnp. It was added
// because the plain version (python_5gtoolbox_tpu_torch/rx/equalize.py:
// ml2_maxlog_plain) builds the (REs, q^NL, Nr) candidate tensor in device
// memory term by term and makes two where/amin passes per bit over the
// (REs, q^NL) metric: megabytes of HBM traffic per RE where the search
// needs about 100 bytes in and 60 out.
//
// Per RE, from the whitened y (Nr), h (Nr, NL) and sigma2, with c_i the
// constellation symbols indexed by the MSB-first integer of their bits:
//   NL = 2: d(i, j) = sum_r |(y_r - h_r0 c_i) - h_r1 c_j|^2, candidate i q + j
//   NL = 1: d(j)    = sum_r |y_r - h_r0 c_j|^2,             candidate j
// best   : the first candidate of least d (row-major: layer 0 major, the
//          order of rx/equalize.py:_candidates)
// min_lv : d(best) / sigma2
// llr    : per layer l and bit k, min(d | bit k of layer l is 1) / sigma2
//          - min(d | bit k of layer l is 0) / sigma2
// all in FP32.
//
// Bound on the H100: per candidate and RX antenna 2 subtractions and 2
// FMAs, then a row and a column minimum: (4 Nr + 2) FP32 instructions a
// candidate, 18 at Nr = 4, against ~160 bytes a RE. Operations bind, by
// three orders of magnitude: 36,036 REs x 4,096 candidates (one slot of
// 64QAM, 2 layers) is ~2.7 G instructions, ~0.08 ms at 33.5 T FP32
// instructions/s (132 SMs x 128 lanes x 1.98 GHz).
//
// Design:
// * Nothing of size q^NL leaves the SM. With a_i = y - h0 c_i and
//   b_j = h1 c_j (NL = 1: one row a_0 = y, b_j = h0 c_j) the metric is
//   |a_i - b_j|^2 over the antennas. The warp writes the q vectors b_j to
//   its shared memory; each lane keeps the a_i of its TA rows in registers
//   and walks its columns, reading each b_j once for TA candidates.
// * Lanes form LR row groups x LC column groups (G = LR LC lanes; with
//   G < 32 the other lanes repeat the first G, which changes no minimum).
//   A lane's columns are cg, cg + LC, ... so that the column groups read
//   neighbouring b_j, in different banks. Row minima stay in registers and
//   meet across the column groups by shuffles at the end; each column's
//   minimum meets across the row groups by shuffles as soon as it is
//   complete. Both land in shared memory.
// * Per-bit minima from row and column minima, exactly: every candidate
//   whose layer-0 bit k is v lies in a row whose symbol has that bit, so
//   the minimum over them is the least of those rows' minima (layer 1:
//   columns). One lane per (layer, bit, value) scans q / 2 minima.
// * sigma2 divides after the minima: fl(x / s) is monotone in x for s > 0,
//   so min(d) / s == min(d / s) bit for bit.
// * best: the first row whose minimum is the least, then the first column
//   of that row whose metric equals it, recomputed with the same rounded
//   operations (__fsub_rn, __fmul_rn, __fmaf_rn: nothing is contracted
//   differently), so no index is tracked in the inner loop.
// * Receive antennas are padded with zeros to NRP (1, 2, 4 or 8): a zero
//   antenna adds exactly 0 to d.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;                       // REs per block
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float2* y;       // (n, nr)
  const float2* h;       // (n, nr, nl)
  const float2* syms;    // (q,)
  const float* sigma2;   // (n,)
  long long* best;       // (n,)
  float* min_lv;         // (n,)
  float* llr;            // (n, nl * qm)
  int n, nr, nl, qm;
  int lc;                // column groups (lanes of one row group)
  int g;                 // lanes holding distinct tiles, a power of two
};

__device__ __forceinline__ float inf_f() {
  return __int_as_float(0x7f800000);
}

__device__ __forceinline__ float2 cmul(float2 h, float2 c) {
  return make_float2(__fmaf_rn(-h.y, c.y, __fmul_rn(h.x, c.x)),
                     __fmaf_rn(h.y, c.x, __fmul_rn(h.x, c.y)));
}

// a = y - h0 c (NL = 2), a = y (NL = 1)
template <int NRP>
__device__ __forceinline__ void row_vec(float2 (&a)[NRP],
                                        const float2 (&y)[NRP],
                                        const float2 (&h0)[NRP], float2 c,
                                        bool two) {
#pragma unroll
  for (int r = 0; r < NRP; ++r) {
    if (two) {
      const float2 p = cmul(h0[r], c);
      a[r] = make_float2(__fsub_rn(y[r].x, p.x), __fsub_rn(y[r].y, p.y));
    } else {
      a[r] = y[r];
    }
  }
}

// this RE's y and layer-0 column of h, antennas padded with zeros
template <int NRP>
__device__ __forceinline__ void load_re(float2 (&y)[NRP], float2 (&h0)[NRP],
                                        const float2* yp, const float2* hp,
                                        int nr, int nl) {
#pragma unroll
  for (int r = 0; r < NRP; ++r) {
    y[r] = r < nr ? yp[r] : make_float2(0.f, 0.f);
    h0[r] = r < nr ? hp[r * nl] : make_float2(0.f, 0.f);
  }
}

template <int NRP>
__device__ __forceinline__ float dist(const float2 (&a)[NRP],
                                      const float2 (&b)[NRP]) {
  float d = 0.f;
#pragma unroll
  for (int r = 0; r < NRP; ++r) {
    const float er = __fsub_rn(a[r].x, b[r].x);
    const float ei = __fsub_rn(a[r].y, b[r].y);
    d = __fmaf_rn(er, er, d);
    d = __fmaf_rn(ei, ei, d);
  }
  return d;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The first index of arr[0, len) equal to its least value m (found by the
// whole warp); INT_MAX where none is.
__device__ __forceinline__ int first_equal(const float* arr, int len,
                                           float m, int lane) {
  int at = INT_MAX;
  for (int i = lane; i < len; i += 32)
    if (arr[i] == m) { at = i; break; }
  return warp_min(at);
}

// Shared memory: the q symbols, then per warp q NRP vectors b_j and
// (rows + q) floats of row and column minima (q float2 hold them).
template <int NRP>
__host__ __device__ constexpr int warp_smem_f2(int q) { return q * NRP + q; }

template <int NRP, int TA>
__global__ void __launch_bounds__(kWarps * 32)
ml2_maxlog_kernel(const Args a) {
  extern __shared__ float2 smem[];
  const int q = 1 << a.qm;
  const bool two = a.nl == 2;
  const int rows = two ? q : 1;
  for (int i = threadIdx.x; i < q; i += blockDim.x) smem[i] = a.syms[i];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long re = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (re >= a.n) return;                        // whole warps only
  const float2* syms = smem;
  float2* b_s = smem + q + warp * warp_smem_f2<NRP>(q);
  float* rowmin_s = reinterpret_cast<float*>(b_s + q * NRP);
  float* colmin_s = rowmin_s + rows;
  const float2* y = a.y + re * a.nr;
  const float2* h = a.h + re * a.nr * a.nl;

  // b_j = h_{nl-1} c_j, antennas padded with zeros
  const int lb = a.nl - 1;
  for (int idx = lane; idx < q * NRP; idx += 32) {
    const int j = idx / NRP, r = idx % NRP;
    b_s[idx] = r < a.nr ? cmul(h[r * a.nl + lb], syms[j])
                        : make_float2(0.f, 0.f);
  }
  float2 yv[NRP], h0[NRP];
  load_re(yv, h0, y, h, a.nr, a.nl);
  __syncwarp();

  const int t = lane & (a.g - 1);
  const int rg = t / a.lc, cg = t % a.lc;
  float2 av[TA][NRP];
  float rmin[TA];
#pragma unroll
  for (int ii = 0; ii < TA; ++ii) {
    row_vec(av[ii], yv, h0, syms[rg * TA + ii], two);
    rmin[ii] = inf_f();
  }
  // a lane's columns cg, cg + lc, ...: the column groups read neighbouring
  // vectors b_j at once, in different banks
  const int per_lane = q / a.lc;
#pragma unroll 2
  for (int u = 0; u < per_lane; ++u) {
    const int j = cg + u * a.lc;
    float2 bv[NRP];
#pragma unroll
    for (int r = 0; r < NRP; ++r) bv[r] = b_s[j * NRP + r];
    float m = inf_f();
#pragma unroll
    for (int ii = 0; ii < TA; ++ii) {
      const float d = dist(av[ii], bv);
      rmin[ii] = fminf(rmin[ii], d);
      m = fminf(m, d);
    }
    // the column's minimum over the row groups (lanes t ^ lc, t ^ 2 lc ...)
    for (int o = a.lc; o < a.g; o <<= 1)
      m = fminf(m, __shfl_xor_sync(kFull, m, o));
    if (lane < a.g && rg == 0) colmin_s[j] = m;
  }
#pragma unroll
  for (int ii = 0; ii < TA; ++ii) {
    float m = rmin[ii];
    for (int o = 1; o < a.lc; o <<= 1)
      m = fminf(m, __shfl_xor_sync(kFull, m, o));
    if (lane < a.g && cg == 0) rowmin_s[rg * TA + ii] = m;
  }
  __syncwarp();

  // least metric and its first candidate
  const float* lead = two ? rowmin_s : colmin_s;
  const int n_lead = two ? rows : q;
  float m = inf_f();
  for (int i = lane; i < n_lead; i += 32) m = fminf(m, lead[i]);
  const float gmin = warp_min(m);
  int best = first_equal(lead, n_lead, gmin, lane);
  if (two && best != INT_MAX) {
    // recompute that row with the same operations
    float2 ar[NRP];
    load_re(yv, h0, y, h, a.nr, a.nl);
    row_vec(ar, yv, h0, syms[best], true);
    int at = INT_MAX;
    for (int j = lane; j < q; j += 32) {
      float2 bv[NRP];
#pragma unroll
      for (int r = 0; r < NRP; ++r) bv[r] = b_s[j * NRP + r];
      if (dist(ar, bv) == gmin) { at = j; break; }
    }
    at = warp_min(at);
    best = at == INT_MAX ? INT_MAX : best * q + at;
  }
  if (best == INT_MAX) best = 0;                // every metric NaN
  const float s = a.sigma2[re];
  if (lane == 0) {
    a.best[re] = best;
    a.min_lv[re] = __fdiv_rn(gmin, s);
  }

  // per-bit minima: lane 2 (l qm + k) + v over the rows (layer 0 of two)
  // or the columns whose symbol has bit k equal to v
  const int n_bits = a.nl * a.qm;
  const int task = lane >> 1, v = lane & 1;
  float mb = inf_f();
  if (task < n_bits) {
    const int l = task / a.qm, k = task - l * a.qm;
    const float* arr = two && l == 0 ? rowmin_s : colmin_s;
    const int p = a.qm - 1 - k;
    const int lo = (1 << p) - 1;
    for (int u = 0; u < q / 2; ++u)
      mb = fminf(mb, arr[((u & ~lo) << 1) | (v << p) | (u & lo)]);
  }
  const float m0 = __shfl_xor_sync(kFull, mb, 1);
  if (task < n_bits && v == 1)
    a.llr[re * n_bits + task] = __fsub_rn(__fdiv_rn(mb, s),
                                          __fdiv_rn(m0, s));
}

template <int NRP, int TA>
int launch(const Args& a, cudaStream_t stream) {
  const int q = 1 << a.qm;
  const int smem = static_cast<int>(sizeof(float2)) *
                   (q + kWarps * warp_smem_f2<NRP>(q));
  auto kernel = ml2_maxlog_kernel<NRP, TA>;
  // above 48 KB only after opting in; once per instantiation and size
  static int opted = 48 * 1024;
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  const long long blocks =
      (static_cast<long long>(a.n) + kWarps - 1) / kWarps;
  kernel<<<static_cast<unsigned>(blocks), kWarps * 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int TA>
int by_antennas(const Args& a, cudaStream_t stream) {
  if (a.nr <= 1) return launch<1, TA>(a, stream);
  if (a.nr <= 2) return launch<2, TA>(a, stream);
  if (a.nr <= 4) return launch<4, TA>(a, stream);
  return launch<8, TA>(a, stream);
}

}  // namespace

// y (n, nr) and h (n, nr, nl) complex64, syms (2^qm,) complex64 indexed by
// the MSB-first integer of the bits, sigma2 (n,) float32 -> best (n,)
// int64, min_lv (n,) float32, llr (n, nl * qm) float32. nr 1..8, nl 1 or
// 2, qm 1, 2, 4, 6 or 8. Returns a cudaError_t code.
extern "C" int ml2_maxlog(const void* y, const void* h, const void* syms,
                          const float* sigma2, long long* best,
                          float* min_lv, float* llr, int n, int nr, int nl,
                          int qm, void* stream) {
  if (n == 0) return 0;
  if (n < 0 || nr < 1 || nr > 8 || (nl != 1 && nl != 2) ||
      (qm != 1 && qm != 2 && qm != 4 && qm != 6 && qm != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const int q = 1 << qm;
  // tiles: TA rows of a lane; LR = g / lc row groups, lc column groups
  int ta, lc, g;
  if (nl == 1) {                      // one row, the columns over the lanes
    ta = 1;
    lc = q < 32 ? q : 32;
    g = lc;
  } else if (q >= 64) {   // 8 rows a lane: 64 -> 8 x 4 groups, 256 -> 32 x 1
    ta = 8;
    g = 32;
    lc = 32 / (q / 8);
  } else if (q == 16) {               // 2 rows a lane, 8 x 4
    ta = 2;
    g = 32;
    lc = 4;
  } else {                            // q 2 or 4: one candidate a lane
    ta = 1;
    lc = q;
    g = q * q;
  }
  const Args a{static_cast<const float2*>(y), static_cast<const float2*>(h),
               static_cast<const float2*>(syms), sigma2, best, min_lv, llr,
               n, nr, nl, qm, lc, g};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ta) {
    case 8: return by_antennas<8>(a, s);
    case 2: return by_antennas<2>(a, s);
    default: return by_antennas<1>(a, s);
  }
}
