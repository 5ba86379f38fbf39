// Min-sum LDPC decoder for small liftings: a block decodes a group of G
// codewords whose whole state, LQ and LR, stays in its shared memory.
//
// Replaces the TPU kernel python_5gtoolbox_tpu/ops/ldpc/pallas_decode.py
// _make_kernel_packed (both schedules, both check nodes); same bits as
// ldpc_minsum.cu and as decode.py:_ldpc_decode_jit (the arithmetic is in
// ldpc_common.cuh; built with --fmad=false).
//
// What the TPU kernel is for: a small lifting wastes the machine in the
// layout of the large ones, and LQ and LR should both stay on chip for
// the whole decode. On this card the state of one codeword,
// (ncols + n_edges) * Zc floats, is 18.4 KB at BG1/Zc 12, 79.7 KB at
// BG2/Zc 80 and 184 KB at BG1/Zc 120: below the 227 KB a block may use for
// every Zc < 128, so LR needs no global scratch, and a block takes as
// many codewords as the caller asks for (the wrapper picks the smallest
// group that still gives every SM a block). Tasks are spread over the
// whole group: (codeword, row, z) in a flooded iteration, (codeword, z)
// in a layered row.
//
// Early exit is per codeword, the barriers are per block: done[g] is a
// flag in shared memory, a converged codeword's tasks are skipped, and
// every thread goes on to every barrier until no codeword of the block
// is active (a block-uniform test through __syncthreads_or). A batch
// that is not a multiple of G leaves the last block with fewer
// codewords (gcount).
//
// Bound on the H100: operations, as for ldpc_minsum.cu; the input is
// read once from device memory (llr0 again from L2 in every flooded
// variable-node pass).
#include "ldpc_common.cuh"

namespace {

template <int MAXD, bool FAST, bool LAYERED>
__global__ void __launch_bounds__(1024)
ldpc_minsum_packed_kernel(const float* __restrict__ llr0,
                          const int* __restrict__ tab, int batch, int group,
                          int nrows, int ncols, int ne, int zc, int n_iter,
                          float alpha, float beta, int8_t* __restrict__ bits,
                          int* __restrict__ ok, int* __restrict__ iters) {
  extern __shared__ float smem[];
  const int nv = ncols * zc;        // LQ floats per codeword
  const int nl = ne * zc;           // LR floats per codeword
  const int nc = nrows * zc;        // checks per codeword
  const int ntab = ldpc::table_ints(nrows, ncols, ne);
  int* st = reinterpret_cast<int*>(smem);
  int* done = st + ntab;            // group flags
  int* bad = done + group;          // group flags
  float* lq = smem + ntab + 2 * group;       // group x nv
  float* lr = lq + static_cast<size_t>(group) * nv;   // group x nl
  const ldpc::Tables t = ldpc::split_tables(st, nrows, ncols, ne);

  const int cw0 = blockIdx.x * group;
  const int gcount = min(group, batch - cw0);
  const float* l0 = llr0 + static_cast<size_t>(cw0) * nv;
  int8_t* bc = bits + static_cast<size_t>(cw0) * nv;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  for (int k = tid; k < ntab; k += nthr) st[k] = tab[k];
  for (int k = tid; k < gcount * nv; k += nthr) lq[k] = l0[k];
  for (int k = tid; k < gcount * nl; k += nthr) lr[k] = 0.f;
  if (tid < group) {
    done[tid] = 0;
    bad[tid] = 0;
  }
  __syncthreads();

  int it = 0;
  for (; it < n_iter; ++it) {
    // syndrome of the active codewords
    for (int task = tid; task < gcount * nc; task += nthr) {
      const int g = task / nc;
      if (done[g]) continue;
      const int rem = task - g * nc;
      const int r = rem / zc;
      if (ldpc::check_parity(lq + g * nv, t, r, rem - r * zc, zc, false))
        bad[g] = 1;
    }
    __syncthreads();
    // a codeword whose syndrome is zero freezes its bits now
    for (int k = tid; k < gcount * nv; k += nthr) {
      const int g = k / nv;
      if (!done[g] && !bad[g]) bc[k] = lq[k] < 0.f ? 1 : 0;
    }
    __syncthreads();
    int active = 0;
    if (tid < gcount && !done[tid]) {
      if (bad[tid]) {
        active = 1;
        bad[tid] = 0;
      } else {
        done[tid] = 1;
        ok[cw0 + tid] = 1;
        if (iters != nullptr) iters[cw0 + tid] = it;
      }
    }
    if (!__syncthreads_or(active)) break;

    if (LAYERED) {
      for (int r = 0; r < nrows; ++r) {
        for (int task = tid; task < gcount * zc; task += nthr) {
          const int g = task / zc;
          if (done[g]) continue;
          ldpc::check_node<MAXD, FAST, true>(lq + g * nv, lr + g * nl, t, r,
                                             task - g * zc, zc, alpha, beta);
        }
        __syncthreads();
      }
    } else {
      for (int task = tid; task < gcount * nc; task += nthr) {
        const int g = task / nc;
        if (done[g]) continue;
        const int rem = task - g * nc;
        const int r = rem / zc;
        ldpc::check_node<MAXD, FAST, false>(lq + g * nv, lr + g * nl, t, r,
                                            rem - r * zc, zc, alpha, beta);
      }
      __syncthreads();
      for (int k = tid; k < gcount * nv; k += nthr) {
        const int g = k / nv;
        if (done[g]) continue;
        lq[k] = ldpc::variable_node(l0 + g * nv, lr + g * nl, t, k - g * nv,
                                    zc);
      }
      __syncthreads();
    }
  }

  // codewords still active after n_iter updates: the final rule. (After
  // a break none is active and nothing below has work.)
  for (int task = tid; task < gcount * nc; task += nthr) {
    const int g = task / nc;
    if (done[g]) continue;
    const int rem = task - g * nc;
    const int r = rem / zc;
    if (ldpc::check_parity(lq + g * nv, t, r, rem - r * zc, zc, true))
      bad[g] = 1;
  }
  __syncthreads();
  for (int k = tid; k < gcount * nv; k += nthr) {
    const int g = k / nv;
    if (!done[g]) bc[k] = lq[k] <= 0.f ? 1 : 0;
  }
  if (tid < gcount && !done[tid]) {
    ok[cw0 + tid] = bad[tid] ? 0 : 1;
    if (iters != nullptr) iters[cw0 + tid] = n_iter;
  }
}

struct Launch {
  const float* llr0;
  const int* tab;
  int batch, group, threads, nrows, ncols, ne, zc, n_iter;
  float alpha, beta;
  int8_t* bits;
  int* ok;
  int* iters;
  cudaStream_t s;

  template <int MAXD, bool FAST, bool LAYERED>
  int run() const {
    const size_t smem =
        4 * (static_cast<size_t>(ldpc::table_ints(nrows, ncols, ne))
             + 2 * group
             + static_cast<size_t>(group) * (ncols + ne) * zc);
    int dev = 0, limit = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    // a group that does not fit is the caller's error, never a reason to
    // take another route
    if (smem > static_cast<size_t>(limit))
      return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(
        ldpc_minsum_packed_kernel<MAXD, FAST, LAYERED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = (batch + group - 1) / group;
    ldpc_minsum_packed_kernel<MAXD, FAST, LAYERED>
        <<<blocks, threads, smem, s>>>(llr0, tab, batch, group, nrows, ncols,
                                       ne, zc, n_iter, alpha, beta, bits, ok,
                                       iters);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// llr0 (batch, ncols*zc) float32 with the punctured columns as zeros;
// tab: int32 [row_ptr | e_col | e_shift | col_ptr | col_edge];
// layered, fast: 0 or 1; group: codewords per block (at most `threads`);
// threads: threads per block, a multiple of 32 up to 1024; bits (batch,
// ncols*zc) int8 out; ok (batch) int32 out; iters (batch) int32 out, the
// number of check/variable updates each codeword ran, or null. maxd is
// the largest row degree. Returns the CUDA error of the launch (0 on
// success; cudaErrorInvalidValue where the group's state exceeds the
// device's shared memory); does not synchronise.
extern "C" int ldpc_minsum_packed(const float* llr0, const int* tab,
                                  int batch, int nrows, int ncols, int ne,
                                  int zc, int maxd, int n_iter, float alpha,
                                  float beta, int layered, int fast,
                                  int group, int threads, int8_t* bits,
                                  int* ok, int* iters, void* stream) {
  if (batch <= 0) return 0;
  if (group < 1 || group > threads || threads > 1024 || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch launch{llr0,  tab,  batch, group, threads, nrows, ncols, ne,
                      zc,    n_iter, alpha, beta, bits,  ok,    iters,
                      static_cast<cudaStream_t>(stream)};
  return ldpc::dispatch(maxd, fast, layered, launch);
}
