// Min-sum LDPC decoder (min-sum / NMS / OMS / mixed by alpha, beta), one
// codeword per thread-block cluster: flooded or layered schedule, exact or
// fast check node.
//
// Replaces the TPU kernel python_5gtoolbox_tpu/ops/ldpc/pallas_decode.py
// _make_kernel (both schedules, both check nodes), and is bit for bit
// with python_5gtoolbox_tpu/ops/ldpc/decode.py:_ldpc_decode_jit. The
// kernel and its arithmetic are in ldpc_common.cuh (G = 1 here); built
// with --fmad=false.
//
// Bound on the H100: a few dozen float operations per edge and iteration
// against a few bytes of input, so operations, not bytes. What the design
// does about the rest: the whole state of a codeword, LQ and LR ((ncols +
// n_edges) x Zc floats: 576 KiB for BG1 / Zc 384), is split by lifting
// index over the shared memory of a cluster of K blocks, so LR never
// goes through L2 or HBM (at 512 codewords it would be 248 MB); the
// wrapper raises K until batch x K blocks cover the SMs (20 codewords of
// Zc 352: K = 11, 220 blocks); warps are uniform in their check row; the
// flooded syndrome rides on the check-node pass; the layered sweep has
// one cluster barrier per row phase (32 for BG1, 28 for BG2) instead of
// one per row.
#include "ldpc_common.cuh"

// llr (batch, (ncols-2)*zc) float32, the punctured codeword (the 2*zc
// punctured LLRs count as zeros);
// tab: the int32 table blob of ldpc_common.cuh (rows, columns, nphase
// row phases); layered, fast: 0 or 1; cluster: blocks per codeword, zl
// the lifting indices each holds (zc for one block, else a power of two
// >= 8 with ceil(zc / zl) == cluster); threads per block, a multiple of
// 32 up to 1024; lr_dev: a (batch, ne*zc) float32 scratch that holds LR
// in device memory (one block per cluster), or null for LR in shared
// memory; bits (batch, ncols*zc) int8 out; ok (batch) int8 out;
// iters (batch) int32 out, the number of check/variable updates each
// codeword ran, or null. Returns the CUDA error of the launch (0 on
// success; cudaErrorInvalidValue for parameters the kernel does not take
// or a slice that exceeds the device's shared memory); does not
// synchronise.
extern "C" int ldpc_minsum(const float* llr, const int* tab, int batch,
                           int nrows, int ncols, int ne, int nphase, int zc,
                           int n_iter, float alpha, float beta, int layered,
                           int fast, int cluster, int zl, int threads,
                           float* lr_dev, int8_t* bits, int8_t* ok,
                           int* iters, void* stream) {
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
  p.group = 1;
  return ldpc::launch<false>(p, fast, layered, cluster, zl, threads, 0,
                             static_cast<cudaStream_t>(stream));
}
