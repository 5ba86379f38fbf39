// Min-sum LDPC decoder (min-sum / NMS / OMS / mixed by alpha, beta), one
// block per codeword: flooded or layered schedule, exact or fast check
// node.
//
// Replaces the TPU kernel python_5gtoolbox_tpu/ops/ldpc/pallas_decode.py
// _make_kernel (both schedules, both check nodes), and is bit for bit
// with python_5gtoolbox_tpu/ops/ldpc/decode.py:_ldpc_decode_jit:
//   * per iteration: hard bits (LQ < 0) and syndrome; a codeword whose
//     syndrome is zero freezes its bits and stops (the TPU kernel goes on
//     updating it with its bits frozen: same bits, same ok);
//   * flooded: every check (row, z) reads the same LQ and rewrites its own
//     LR entries, then every variable (column, z) sums llr0 and its
//     messages;
//   * layered: the rows are swept in order, LQ[c] = ext + msg landing
//     before the next row reads it; one barrier per row, and only Zc of
//     the block's threads have work in a row;
//   * after n_iter iterations the final rule (LQ <= 0) and its syndrome.
// The arithmetic is in ldpc_common.cuh. Built with --fmad=false.
//
// Design: the iteration loop runs inside the block. LQ (ncols x Zc float:
// 73 KB for BG2/Zc 352, 104 KB for BG1/384) and the edge tables live in
// dynamic shared memory. LR (n_edges x Zc: 277 KB for BG2/352) does not
// fit and stays in a global scratch that the wrapper allocates; at the
// sweep's batches it is L2-resident. Bound on the H100: a few dozen float
// operations per edge per iteration against a few bytes of input, so it
// is operation-bound; with one block per codeword, B = 20 codewords fill
// only 20 of the 132 SMs, and the layered sweep is bound by its 46 (BG1)
// or 42 (BG2) barriers per iteration.
#include "ldpc_common.cuh"

namespace {

constexpr int kThreads = 1024;

// 1 if some check row of the hard decision of LQ has odd parity
__device__ int syndrome_bad(const float* lq, const ldpc::Tables& t, int nrows,
                            int zc, bool final_rule) {
  int bad = 0;
  for (int task = threadIdx.x; task < nrows * zc; task += blockDim.x) {
    const int r = task / zc;
    bad |= ldpc::check_parity(lq, t, r, task - r * zc, zc, final_rule);
  }
  return bad;
}

template <int MAXD, bool FAST, bool LAYERED>
__global__ void __launch_bounds__(kThreads)
ldpc_minsum_kernel(const float* __restrict__ llr0,
                   const int* __restrict__ tab, int nrows, int ncols, int ne,
                   int zc, int n_iter, float alpha, float beta,
                   float* __restrict__ lr, int8_t* __restrict__ bits,
                   int* __restrict__ ok, int* __restrict__ iters) {
  extern __shared__ float smem[];
  const int nv = ncols * zc;
  float* lq = smem;
  int* st = reinterpret_cast<int*>(smem + nv);
  const int ntab = ldpc::table_ints(nrows, ncols, ne);
  const ldpc::Tables t = ldpc::split_tables(st, nrows, ncols, ne);

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
    if (LAYERED) {
      for (int r = 0; r < nrows; ++r) {
        for (int z = threadIdx.x; z < zc; z += blockDim.x)
          ldpc::check_node<MAXD, FAST, true>(lq, lrc, t, r, z, zc, alpha,
                                             beta);
        __syncthreads();
      }
    } else {
      for (int task = threadIdx.x; task < nrows * zc; task += blockDim.x) {
        const int r = task / zc;
        ldpc::check_node<MAXD, FAST, false>(lq, lrc, t, r, task - r * zc, zc,
                                            alpha, beta);
      }
      __syncthreads();
      for (int task = threadIdx.x; task < nv; task += blockDim.x)
        lq[task] = ldpc::variable_node(l0, lrc, t, task, zc);
      __syncthreads();
    }
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

struct Launch {
  const float* llr0;
  const int* tab;
  int batch, nrows, ncols, ne, zc, n_iter;
  float alpha, beta;
  float* lr;
  int8_t* bits;
  int* ok;
  int* iters;
  cudaStream_t s;

  template <int MAXD, bool FAST, bool LAYERED>
  int run() const {
    const size_t smem =
        (static_cast<size_t>(ncols) * zc + ldpc::table_ints(nrows, ncols, ne))
        * 4;
    cudaError_t err = cudaFuncSetAttribute(
        ldpc_minsum_kernel<MAXD, FAST, LAYERED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    ldpc_minsum_kernel<MAXD, FAST, LAYERED><<<batch, kThreads, smem, s>>>(
        llr0, tab, nrows, ncols, ne, zc, n_iter, alpha, beta, lr, bits, ok,
        iters);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// llr0 (batch, ncols*zc) float32 with the punctured columns as zeros;
// tab: int32 [row_ptr | e_col | e_shift | col_ptr | col_edge];
// layered, fast: 0 or 1; lr (batch, ne*zc) float32 scratch; bits (batch,
// ncols*zc) int8 out; ok (batch) int32 out; iters (batch) int32 out, the
// number of check/variable updates each codeword ran, or null. maxd is
// the largest row degree. Returns the CUDA error of the launch (0 on
// success); does not synchronise.
extern "C" int ldpc_minsum(const float* llr0, const int* tab, int batch,
                           int nrows, int ncols, int ne, int zc, int maxd,
                           int n_iter, float alpha, float beta, int layered,
                           int fast, float* lr, int8_t* bits, int* ok,
                           int* iters, void* stream) {
  if (batch <= 0) return 0;
  const Launch launch{llr0, tab,  batch, nrows, ncols, ne, zc, n_iter, alpha,
                      beta, lr,   bits,  ok,    iters,
                      static_cast<cudaStream_t>(stream)};
  return ldpc::dispatch(maxd, fast, layered, launch);
}
