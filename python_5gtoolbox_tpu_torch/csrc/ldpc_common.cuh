// Device routines shared by the two min-sum LDPC decoder kernels
// (ldpc_minsum.cu: one block per codeword, LR in device memory;
// ldpc_minsum_packed.cu: several codewords per block, LR in shared
// memory). Everything that decides a bit is here, so both kernels give
// the same bits as python_5gtoolbox_tpu/ops/ldpc/decode.py:
// _ldpc_decode_jit and as the TPU kernels of pallas_decode.py:
//   * ext = LQ[c][(z+p) mod Zc] - LR[e][z];
//   * exact check node: msg = (alpha * excl_sign) * max(min_excl - beta, 0)
//     with sign(0) = 0, the zero count, and only the first instance of the
//     minimum excluded (strict < in the running min1 / min2);
//   * fast check node (pallas_decode._check_node_minsum_fast):
//     sign(0) = +1, every instance of the minimum excluded from min2,
//     msg = ((alpha * prod) * sgn_k) * max(min_excl - beta, 0);
//   * layered schedule: LQ[c][(z+p) mod Zc] = ext + msg, written by the
//     thread that read it (a base-graph row touches a column at most
//     once, so the lanes of one row are independent);
//   * flooded variable node: LQ = llr0 + the column's messages, rows
//     ascending, no atomics.
// Compile with --fmad=false: no multiply-add may be contracted.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace ldpc {

constexpr float kInf = 1e30f;

struct Tables {
  const int* row_ptr;   // nrows + 1
  const int* e_col;     // ne, row-major, columns ascending within a row
  const int* e_shift;   // ne
  const int* col_ptr;   // ncols + 1
  const int* col_edge;  // ne, edge ids of each column, rows ascending
};

__host__ __device__ inline int table_ints(int nrows, int ncols, int ne) {
  return nrows + 1 + 3 * ne + ncols + 1;
}

__device__ inline Tables split_tables(const int* st, int nrows, int ncols,
                                      int ne) {
  Tables t;
  t.row_ptr = st;
  t.e_col = st + nrows + 1;
  t.e_shift = t.e_col + ne;
  t.col_ptr = t.e_shift + ne;
  t.col_edge = t.col_ptr + ncols + 1;
  return t;
}

// parity of check (r, z) on the hard decision of LQ
__device__ inline int check_parity(const float* lq, const Tables& t, int r,
                                   int z, int zc, bool final_rule) {
  int parity = 0;
  for (int e = t.row_ptr[r]; e < t.row_ptr[r + 1]; ++e) {
    int zz = z + t.e_shift[e];
    if (zz >= zc) zz -= zc;
    const float v = lq[t.e_col[e] * zc + zz];
    parity ^= final_rule ? (v <= 0.f) : (v < 0.f);
  }
  return parity;
}

// One check node (r, z): reads LQ and its own LR entries, rewrites those
// LR entries and, in the layered schedule, the LQ entries it read.
template <int MAXD, bool FAST, bool LAYERED>
__device__ __forceinline__ void check_node(float* lq, float* lr,
                                           const Tables& t, int r, int z,
                                           int zc, float alpha, float beta) {
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
      const float v = __fsub_rn(lq[t.e_col[e] * zc + zz], lr[e * zc + z]);
      ext[k] = v;
      const float mg = fabsf(v);
      if (mg < m1) {
        m2 = m1;
        m1 = mg;
      } else if (FAST ? (mg > m1 && mg < m2) : (mg < m2)) {
        m2 = mg;
      }
      if (!FAST && v == 0.f)
        ++nzero;
      else if (v < 0.f)
        prod = -prod;
    }
  }
  const float ap = __fmul_rn(alpha, prod);
#pragma unroll
  for (int k = 0; k < MAXD; ++k) {
    if (k < d) {
      const int e = e0 + k;
      const float v = ext[k];
      const float mag = fmaxf(__fsub_rn(fabsf(v) == m1 ? m2 : m1, beta), 0.f);
      float msg;
      if (FAST) {
        msg = __fmul_rn(__fmul_rn(ap, v < 0.f ? -1.f : 1.f), mag);
      } else {
        const float sg = v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
        const float es = nzero == 0
                             ? prod * sg
                             : ((nzero == 1 && v == 0.f) ? prod : 0.f);
        msg = __fmul_rn(__fmul_rn(alpha, es), mag);
      }
      lr[e * zc + z] = msg;
      if (LAYERED) {
        int zz = z + t.e_shift[e];
        if (zz >= zc) zz -= zc;
        lq[t.e_col[e] * zc + zz] = __fadd_rn(v, msg);
      }
    }
  }
}

// Flooded variable node (c, z), task = c * zc + z
__device__ inline float variable_node(const float* l0, const float* lr,
                                      const Tables& t, int task, int zc) {
  const int c = task / zc;
  const int z = task - c * zc;
  float acc = l0[task];
  for (int q = t.col_ptr[c]; q < t.col_ptr[c + 1]; ++q) {
    const int e = t.col_edge[q];
    int zz = z - t.e_shift[e];
    if (zz < 0) zz += zc;
    acc = __fadd_rn(acc, lr[e * zc + zz]);
  }
  return acc;
}

// Calls launch.template run<MAXD, FAST, LAYERED>() for the run-time
// (maxd, fast, layered); cudaErrorInvalidValue for a row degree above 19.
template <typename Launch>
int dispatch(int maxd, int fast, int layered, const Launch& launch) {
#define LDPC_CASE(D, F, L) \
  if (maxd <= D && !!fast == F && !!layered == L) \
    return launch.template run<D, F, L>();
  LDPC_CASE(10, false, false)
  LDPC_CASE(10, false, true)
  LDPC_CASE(10, true, false)
  LDPC_CASE(10, true, true)
  LDPC_CASE(19, false, false)
  LDPC_CASE(19, false, true)
  LDPC_CASE(19, true, false)
  LDPC_CASE(19, true, true)
#undef LDPC_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace ldpc
