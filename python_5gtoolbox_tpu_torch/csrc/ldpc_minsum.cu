// Flooded min-sum LDPC decoder (min-sum / NMS / OMS / mixed by alpha,
// beta) with the reference's exact check-node semantics.
//
// Replaces the TPU kernel python_5gtoolbox_tpu/ops/ldpc/pallas_decode.py
// _make_kernel (schedule="flooded", semantics="exact"), and is bit for bit
// with python_5gtoolbox_tpu/ops/ldpc/decode.py:_ldpc_decode_jit:
//   * per iteration: hard bits (LQ < 0) and syndrome; a codeword whose
//     syndrome is zero freezes its bits and stops;
//   * check node per (row, z): ext = LQ[c][(z+p) mod Zc] - LR[e][z],
//     msg = (alpha * excl_sign) * max(min_excl - beta, 0) with sign(0) = 0
//     and the first-instance min tie rule;
//   * variable node per (column, z): LQ = llr0 + sum over the column's
//     edges, rows ascending, of LR[e][(z-p) mod Zc] -- the same order as
//     the JAX decoder, with no atomics;
//   * after n_iter iterations the final rule (LQ <= 0) and its syndrome.
// Built with --fmad=false so that no multiply-add is contracted.
//
// Design: one block per codeword; the iteration loop runs inside the
// block. LQ (ncols x Zc float: 73 KB for BG2/Zc 352, 104 KB for BG1/384)
// and the edge tables live in dynamic shared memory. LR (n_edges x Zc:
// 277 KB for BG2/352) does not fit and stays in a global scratch that the
// wrapper allocates; at the sweep's batches it is L2-resident. Bound on the
// H100: a few dozen float operations per edge per iteration against a
// few bytes of input, so it is operation-bound; with one block per
// codeword, B = 20 codewords fill only 20 of the 132 SMs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr float kInf = 1e30f;

struct Tables {
  const int* row_ptr;   // nrows + 1
  const int* e_col;     // ne, row-major, columns ascending within a row
  const int* e_shift;   // ne
  const int* col_ptr;   // ncols + 1
  const int* col_edge;  // ne, edge ids of each column, rows ascending
};

// 1 if some check row of the hard decision of LQ has odd parity
__device__ int syndrome_bad(const float* lq, const Tables& t, int nrows,
                            int zc, bool final_rule) {
  int bad = 0;
  for (int task = threadIdx.x; task < nrows * zc; task += blockDim.x) {
    const int r = task / zc;
    const int z = task - r * zc;
    int parity = 0;
    for (int e = t.row_ptr[r]; e < t.row_ptr[r + 1]; ++e) {
      int zz = z + t.e_shift[e];
      if (zz >= zc) zz -= zc;
      const float v = lq[t.e_col[e] * zc + zz];
      parity ^= final_rule ? (v <= 0.f) : (v < 0.f);
    }
    bad |= parity;
  }
  return bad;
}

template <int MAXD>
__global__ void __launch_bounds__(kThreads)
ldpc_minsum_flooded_kernel(const float* __restrict__ llr0,
                           const int* __restrict__ tab, int nrows, int ncols,
                           int ne, int zc, int n_iter, float alpha,
                           float beta, float* __restrict__ lr,
                           int8_t* __restrict__ bits, int* __restrict__ ok,
                           int* __restrict__ iters) {
  extern __shared__ float smem[];
  const int nv = ncols * zc;
  float* lq = smem;
  int* st = reinterpret_cast<int*>(smem + nv);
  const int ntab = nrows + 1 + 3 * ne + ncols + 1;
  Tables t;
  t.row_ptr = st;
  t.e_col = st + nrows + 1;
  t.e_shift = t.e_col + ne;
  t.col_ptr = t.e_shift + ne;
  t.col_edge = t.col_ptr + ncols + 1;

  const int cw = blockIdx.x;
  const float* l0 = llr0 + static_cast<size_t>(cw) * nv;
  float* lrc = lr + static_cast<size_t>(cw) * ne * zc;
  int8_t* bc = bits + static_cast<size_t>(cw) * nv;

  for (int k = threadIdx.x; k < ntab; k += blockDim.x) st[k] = tab[k];
  for (int k = threadIdx.x; k < nv; k += blockDim.x) lq[k] = l0[k];
  for (int k = threadIdx.x; k < ne * zc; k += blockDim.x) lrc[k] = 0.f;
  __syncthreads();

  bool done = false;
  int it = 0;
  for (; it < n_iter; ++it) {
    const int bad = syndrome_bad(lq, t, nrows, zc, false);
    if (!__syncthreads_or(bad)) {
      for (int k = threadIdx.x; k < nv; k += blockDim.x)
        bc[k] = lq[k] < 0.f ? 1 : 0;
      done = true;
      break;
    }
    // check nodes: each (row, z) reads and rewrites its own LR entries
    for (int task = threadIdx.x; task < nrows * zc; task += blockDim.x) {
      const int r = task / zc;
      const int z = task - r * zc;
      const int e0 = t.row_ptr[r];
      const int d = t.row_ptr[r + 1] - e0;
      float ext[MAXD];
      float m1 = kInf, m2 = kInf, prod = 1.f;
      int nzero = 0;
#pragma unroll
      for (int k = 0; k < MAXD; ++k) {
        if (k < d) {
          const int e = e0 + k;
          int zz = z + t.e_shift[e];
          if (zz >= zc) zz -= zc;
          const float v = __fsub_rn(lq[t.e_col[e] * zc + zz],
                                    lrc[e * zc + z]);
          ext[k] = v;
          const float mg = fabsf(v);
          if (mg < m1) {
            m2 = m1;
            m1 = mg;
          } else if (mg < m2) {
            m2 = mg;
          }
          if (v == 0.f)
            ++nzero;
          else if (v < 0.f)
            prod = -prod;
        }
      }
#pragma unroll
      for (int k = 0; k < MAXD; ++k) {
        if (k < d) {
          const float v = ext[k];
          const float mex = fabsf(v) == m1 ? m2 : m1;
          const float sg = v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
          const float es = nzero == 0
                               ? prod * sg
                               : ((nzero == 1 && v == 0.f) ? prod : 0.f);
          lrc[(e0 + k) * zc + z] =
              __fmul_rn(__fmul_rn(alpha, es), fmaxf(__fsub_rn(mex, beta), 0.f));
        }
      }
    }
    __syncthreads();
    // variable nodes
    for (int task = threadIdx.x; task < nv; task += blockDim.x) {
      const int c = task / zc;
      const int z = task - c * zc;
      float acc = l0[task];
      for (int q = t.col_ptr[c]; q < t.col_ptr[c + 1]; ++q) {
        const int e = t.col_edge[q];
        int zz = z - t.e_shift[e];
        if (zz < 0) zz += zc;
        acc = __fadd_rn(acc, lrc[e * zc + zz]);
      }
      lq[task] = acc;
    }
    __syncthreads();
  }
  if (iters != nullptr && threadIdx.x == 0) iters[cw] = it;
  if (done) {
    if (threadIdx.x == 0) ok[cw] = 1;
    return;
  }
  const int bad = __syncthreads_or(syndrome_bad(lq, t, nrows, zc, true));
  for (int k = threadIdx.x; k < nv; k += blockDim.x)
    bc[k] = lq[k] <= 0.f ? 1 : 0;
  if (threadIdx.x == 0) ok[cw] = bad ? 0 : 1;
}

template <int MAXD>
int launch(const float* llr0, const int* tab, int batch, int nrows,
           int ncols, int ne, int zc, int n_iter, float alpha, float beta,
           float* lr, int8_t* bits, int* ok, int* iters, cudaStream_t s) {
  const int ntab = nrows + 1 + 3 * ne + ncols + 1;
  const size_t smem = (static_cast<size_t>(ncols) * zc + ntab) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      ldpc_minsum_flooded_kernel<MAXD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ldpc_minsum_flooded_kernel<MAXD><<<batch, kThreads, smem, s>>>(
      llr0, tab, nrows, ncols, ne, zc, n_iter, alpha, beta, lr, bits, ok,
      iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// llr0 (batch, ncols*zc) float32 with the punctured columns as zeros;
// tab: int32 [row_ptr | e_col | e_shift | col_ptr | col_edge];
// lr (batch, ne*zc) float32 scratch; bits (batch, ncols*zc) int8 out;
// ok (batch) int32 out; iters (batch) int32 out, the number of
// check/variable updates each codeword ran, or null. maxd is the largest
// row degree. Returns the CUDA error of the launch (0 on success); does
// not synchronise.
extern "C" int ldpc_minsum_flooded(const float* llr0, const int* tab,
                                   int batch, int nrows, int ncols, int ne,
                                   int zc, int maxd, int n_iter, float alpha,
                                   float beta, float* lr, int8_t* bits,
                                   int* ok, int* iters, void* stream) {
  if (batch <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (maxd <= 10)
    return launch<10>(llr0, tab, batch, nrows, ncols, ne, zc, n_iter, alpha,
                      beta, lr, bits, ok, iters, s);
  if (maxd <= 19)
    return launch<19>(llr0, tab, batch, nrows, ncols, ne, zc, n_iter, alpha,
                      beta, lr, bits, ok, iters, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
