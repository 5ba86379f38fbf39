// Min-sum LDPC decoder for small liftings: a block decodes a group of G
// codewords whose whole state, LQ and LR, stays in its shared memory.
//
// Replaces the TPU kernel python_5gtoolbox_tpu/ops/ldpc/pallas_decode.py
// _make_kernel_packed (both schedules, both check nodes); same bits as
// ldpc_minsum.cu and as decode.py:_ldpc_decode_jit. The kernels and their
// arithmetic are in ldpc_common.cuh; built with --fmad=false.
//
// What the TPU kernel is for: a small lifting wastes the machine in the
// layout of the large ones. Here a sub-task of 32 lanes holds 32 / S
// codewords side by side (S = pow2ceil(Zc) up to 32), so a warp stays
// uniform in its check row while its lanes cover several codewords; one
// codeword's state (18.4 KB at BG1 / Zc 12, 79.7 KB at BG2 / Zc 80) fits
// many times in a block. Bound: operations, as for ldpc_minsum.cu, and in
// practice the latency of an iteration. So the flooded iteration has three
// barriers (check nodes with the syndrome fused | decide | variable
// nodes), the layered sweep for Zc <= 32 is warp-local (a warp owns whole
// codewords, __syncwarp between rows, its own early exit: no block
// barrier at all), and above 32 it has one barrier per row phase. Where
// batch / G blocks would leave SMs idle (20 codewords of Zc 80), the
// wrapper splits each codeword over a cluster of blocks as ldpc_minsum
// does.
#include "ldpc_common.cuh"

// As ldpc_minsum (ldpc_minsum.cu), and: group, codewords per cluster (1 to
// 32); warp: 1 for the warp-per-codeword layered kernel (zc <= 32,
// cluster 1, layered).
extern "C" int ldpc_minsum_packed(const float* llr, const int* tab,
                                  int batch, int nrows, int ncols, int ne,
                                  int nphase, int zc, int n_iter, float alpha,
                                  float beta, int layered, int fast,
                                  int group, int cluster, int zl,
                                  int threads, float* lr_dev, int warp,
                                  int8_t* bits, int8_t* ok, int* iters,
                                  void* stream) {
  ldpc::Params p = {};
  p.llr = llr;
  p.tab = tab;
  p.bits = bits;
  p.ok = ok;
  p.iters = iters;
  p.lr_dev = lr_dev;
  p.batch = batch;
  p.nrows = nrows;
  p.ncols = ncols;
  p.ne = ne;
  p.nphase = nphase;
  p.zc = zc;
  p.n_iter = n_iter;
  p.alpha = alpha;
  p.beta = beta;
  p.group = group;
  return ldpc::launch<true>(p, fast, layered, cluster, zl, threads, warp,
                            static_cast<cudaStream_t>(stream));
}
