// The min-sum LDPC decoder kernel shared by ldpc_minsum.cu (one codeword
// per cluster, G = 1) and ldpc_minsum_packed.cu (G codewords per block,
// and a warp-per-codeword layered sweep for liftings up to 32). Everything
// that decides a bit is here, so both entries give the same bits as
// python_5gtoolbox_tpu/ops/ldpc/decode.py:_ldpc_decode_jit and as the TPU
// kernels of pallas_decode.py:
//   * ext = LQ[c][(z+p) mod Zc] - LR[e][z];
//   * exact check node: msg = (alpha * excl_sign) * max(min_excl - beta, 0)
//     with sign(0) = 0, the zero count, and only the first instance of the
//     minimum excluded (strict < in the running min1 / min2);
//   * fast check node (pallas_decode._check_node_minsum_fast):
//     sign(0) = +1, every instance of the minimum excluded from min2,
//     msg = ((alpha * prod) * sgn_k) * max(min_excl - beta, 0);
//   * layered schedule: LQ[c][(z+p) mod Zc] = ext + msg, written by the
//     thread that read it (a base-graph row touches a column at most once);
//     consecutive rows that share no column form one phase and are swept
//     together, which reads and writes exactly what the row-by-row sweep
//     does;
//   * flooded variable node: LQ = llr0 + the column's messages, rows
//     ascending, no atomics;
//   * per iteration: the syndrome of LQ < 0 first; a codeword whose
//     syndrome is zero freezes its bits (LQ < 0) and stops; after n_iter
//     iterations the final rule LQ <= 0 and its syndrome.
// Compile with --fmad=false: no multiply-add may be contracted.
//
// Layout. A cluster of K blocks decodes G codewords; block k of the
// cluster holds the lifting indices [k*zl, (k+1)*zl) of LQ (ncols x zl
// floats per codeword) and LR (n_edges x zl) in its shared memory, so LR
// never touches device memory. K = 1 holds the whole lifting (zl = Zc);
// K > 1 uses power-of-two slices zl >= 8, so the owner of a lifting index
// is zz >> log2(zl) and its place zz & (zl - 1). Entries of another block
// are read and written through distributed shared memory; the barriers
// are cluster barriers (block barriers for K = 1). One exception, chosen
// by the wrapper: with K = 1 LR may sit in a device-memory scratch
// (p.lr_dev) while LQ stays in shared memory, for the layered schedule at
// batches whose clusters would not fit on the card at once.
//
// Work. A warp takes one (row or column, sub-task) at a time, so the row's
// degree, columns and shifts are warp-uniform: they come from the edge
// tables by broadcast loads, no integer division per task. A sub-task is
// 32 lanes: 32 consecutive lifting indices of one codeword, or, for a
// slice narrower than 32, S = pow2ceil(zl) lanes per codeword and 32 / S
// codewords side by side. The check node is compiled for degree 6 and
// 10 (unrolled, ext kept in registers) and as a compact loop for the
// wider rows (which reads its inputs again in the second pass), chosen
// per row.
//
// Flooded iteration, three barriers: check nodes with the syndrome fused
// (the pass reads every LQ entry the row's parity needs) | decide: the
// cluster's parity flags are ORed, converged codewords freeze | variable
// nodes (and the bits of the codewords that just converged). Layered
// iteration: syndrome | decide | one barrier per row phase.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ldpc {

namespace cg = cooperative_groups;

constexpr float kInf = 1e30f;
constexpr int kMaxCluster = 16;   // with non-portable cluster sizes allowed
constexpr int kMaxGroup = 32;
constexpr int kHold = 10;         // widest check node that keeps ext[]
// threads per block at most: a layered row phase keeps few warps busy, so
// its kernels trade threads for registers; the warp kernel more so
constexpr int kMaxThreadsFlooded = 1024;
constexpr int kMaxThreadsLayered = 512;
constexpr int kMaxThreadsWarp = 256;

struct Params {
  const float* llr;   // (batch, (ncols-2)*zc): the 2*zc punctured LLRs
                      // are not stored and count as zeros
  const int* tab;     // table blob, see table_ints
  int8_t* bits;       // (batch, ncols*zc) out
  int8_t* ok;         // (batch) out, 0 or 1
  int* iters;         // (batch) out, or null
  float* lr_dev;      // (batch, ne*zc) scratch for LR in device memory, or
                      // null: LR in shared memory
  int batch, nrows, ncols, ne, nphase, zc, n_iter;
  float alpha, beta;
  int group;          // G: codewords per block
  int zl;             // lifting indices per block
  int zl_shift;       // log2(zl) for K > 1
  int seg_shift;      // log2(S), S lanes per codeword in a sub-task
  int nchunk;         // sub-tasks along the slice: ceil(zl / S)
  int nsub;           // sub-tasks per row or column: ceil(G / (32/S)) * nchunk
};

// int32 table blob: row_ptr (nrows+1) | row_edge (ne): col | shift << 16,
// rows in order, columns ascending | col_ptr (ncols+1) | col_edge (ne):
// the edge ids of each column, rows ascending | phase_ptr (nphase+1) |
// row_order (nrows), col_order (ncols): rows and columns by degree,
// widest first, the order in which the flooded passes hand them to warps
// (warp w takes the w-th, then the (w + warps)-th, ...: each warp gets one
// of the wide ones at most, and lighter ones after it).
// In shared memory a block keeps col * zl in place of col and edge * zl in
// place of edge.
__host__ __device__ inline int table_ints(int nrows, int ncols, int ne,
                                          int nphase) {
  return nrows + 1 + ne + ncols + 1 + ne + nphase + 1 + nrows + ncols;
}

// ints before LQ in shared memory: tables, four flags per codeword and
// the sub-task table, rounded up to 16 bytes
__host__ __device__ inline int head_ints(const Params& p) {
  return (table_ints(p.nrows, p.ncols, p.ne, p.nphase) + 4 * p.group
          + p.nsub + 3) & ~3;
}

inline size_t smem_bytes(const Params& p) {
  return 4 * (static_cast<size_t>(head_ints(p))
              + static_cast<size_t>(p.group)
                    * (p.ncols + (p.lr_dev ? 0 : p.ne)) * p.zl);
}

struct Smem {
  const int* row_ptr;
  const int* row_edge;
  const int* col_ptr;
  const int* col_edge;
  const int* phase_ptr;
  const int* row_order;
  const int* col_order;
  int* done;   // G: 0 active, 2 converged in this iteration, 1 before
  int* bad;    // 2 x G parity flags, alternating between iterations
  int* act;    // G: some block of the cluster saw a bad parity, then
               // active in this iteration
  int* sub;    // nsub: first codeword | first lifting index << 16
  float* lq;   // G x ncols x zl
  float* lr;   // G x ne x zl: LR[e][z] at the check's lifting index z
               // (layered), at the variable's (z + shift) mod Zc (flooded);
               // in shared memory, or the block's rows of p.lr_dev
};

__device__ inline Smem carve(const Params& p, int* sm, int cw0) {
  Smem s;
  s.row_ptr = sm;
  s.row_edge = s.row_ptr + p.nrows + 1;
  s.col_ptr = s.row_edge + p.ne;
  s.col_edge = s.col_ptr + p.ncols + 1;
  s.phase_ptr = s.col_edge + p.ne;
  s.row_order = s.phase_ptr + p.nphase + 1;
  s.col_order = s.row_order + p.nrows;
  s.done = sm + table_ints(p.nrows, p.ncols, p.ne, p.nphase);
  s.bad = s.done + p.group;
  s.act = s.bad + 2 * p.group;
  s.sub = s.act + p.group;
  s.lq = reinterpret_cast<float*>(sm + head_ints(p));
  s.lr = p.lr_dev ? p.lr_dev + static_cast<size_t>(cw0) * p.ne * p.zl
                  : s.lq + p.group * p.ncols * p.zl;
  return s;
}

template <bool CL>
__device__ __forceinline__ void sync() {
  if constexpr (CL)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// entry zz (a lifting index of 0..Zc-1) of a row of LQ or LR whose slice
// in this block starts at base
template <bool CL>
__device__ __forceinline__ float* slot(float* base, int zz, const Params& p) {
  if constexpr (CL)
    return cg::this_cluster().map_shared_rank(base + (zz & (p.zl - 1)),
                                              zz >> p.zl_shift);
  else
    return base + zz;
}

// parity of check (r, z) on the hard decision of LQ
template <bool CL>
__device__ __forceinline__ int parity(const Params& p, const Smem& s, int r,
                                      float* lq, int z, bool final_rule) {
  int parity = 0;
  const int e1 = s.row_ptr[r + 1];
#pragma unroll 4
  for (int e = s.row_ptr[r]; e < e1; ++e) {
    const int w = s.row_edge[e];
    int zz = z + (w >> 16);
    if (zz >= p.zc) zz -= p.zc;
    const float q = *slot<CL>(lq + (w & 0xffff), zz, p);
    parity ^= final_rule ? (q <= 0.f) : (q < 0.f);
  }
  return parity;
}

// The messages of one check node from its pass over the inputs: msg_k =
// sel_k * mag_k with mag_k = max((|v_k| == m1 ? m2 : m1) - beta, 0) and
// sel_k the reference's alpha * sign factor, one of ap = alpha * prod, -ap
// or alpha * 0 (exact: -ap is alpha * -prod bit for bit), so each is
// formed once per row.
template <bool FAST>
struct Messages {
  float m1, mag1, mag2, ap, az;
  int nzero;
  __device__ __forceinline__ Messages(const Params& p, float m1_, float m2,
                                      int nzero_, int neg) {
    m1 = m1_;
    mag1 = fmaxf(__fsub_rn(m1_, p.beta), 0.f);
    mag2 = fmaxf(__fsub_rn(m2, p.beta), 0.f);
    ap = __fmul_rn(p.alpha, neg ? -1.f : 1.f);
    az = __fmul_rn(p.alpha, 0.f);
    nzero = nzero_;
  }
  __device__ __forceinline__ float operator()(float v) const {
    const float mag = fabsf(v) == m1 ? mag2 : mag1;
    float sel;
    if (FAST || nzero == 0)
      sel = v < 0.f ? -ap : ap;
    else
      sel = nzero == 1 && v == 0.f ? ap : az;
    return __fmul_rn(sel, mag);
  }
};

// One check node (r, z) of width D >= the row's degree, D <= kHold: reads
// LQ and its own LR entries, rewrites those LR entries and, LAYERED, the
// LQ entries it read. LR sits at the local index zi (LAYERED) or beside
// the LQ entry of the edge (flooded). SYN: returns the parity of LQ < 0 on
// the LQ read. ext stays in registers between the two passes.
template <int D, bool FAST, bool LAYERED, bool CL, bool SYN>
__device__ __forceinline__ int check_row(const Params& p, const Smem& s,
                                         int r, float* lq, float* lr, int z,
                                         int zi) {
  static_assert(D <= kHold, "wider rows take check_row_wide");
  const int e0 = s.row_ptr[r];
  const int d = s.row_ptr[r + 1] - e0;
  float* lrow = lr + e0 * p.zl;
  float ext[D];
  float m1 = kInf, m2 = kInf;
  int nzero = 0, neg = 0, parity = 0;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    if (k < d) {
      const int w = s.row_edge[e0 + k];
      int zz = z + (w >> 16);
      if (zz >= p.zc) zz -= p.zc;
      const float q = *slot<CL>(lq + (w & 0xffff), zz, p);
      if (SYN) parity ^= q < 0.f;
      const float v = __fsub_rn(
          q, LAYERED ? lrow[k * p.zl + zi] : *slot<CL>(lrow + k * p.zl, zz, p));
      ext[k] = v;
      const float mg = fabsf(v);
      m2 = fminf(m2, FAST && mg == m1 ? kInf : fmaxf(m1, mg));
      m1 = fminf(m1, mg);
      if (!FAST) nzero += v == 0.f;
      neg ^= v < 0.f;
    }
  }
  const Messages<FAST> msgs(p, m1, m2, nzero, neg);
#pragma unroll
  for (int k = 0; k < D; ++k) {
    if (k < d) {
      const int w = s.row_edge[e0 + k];
      int zz = z + (w >> 16);
      if (zz >= p.zc) zz -= p.zc;
      const float v = ext[k];
      const float msg = msgs(v);
      if (LAYERED) {
        lrow[k * p.zl + zi] = msg;
        *slot<CL>(lq + (w & 0xffff), zz, p) = __fadd_rn(v, msg);
      } else {
        *slot<CL>(lrow + k * p.zl, zz, p) = msg;
      }
    }
  }
  return parity;
}

// The same check node for rows wider than kHold (BG1's four rows of
// degree 19): a compact loop that reads its inputs again in the second
// pass, so that the kernel holds no 19-wide register arrays (which spilled
// under the 64 registers of a 1024-thread block).
template <bool FAST, bool LAYERED, bool CL, bool SYN>
__device__ __forceinline__ int check_row_wide(const Params& p,
                                              const Smem& s, int r,
                                              float* lq, float* lr, int z,
                                              int zi) {
  const int e0 = s.row_ptr[r];
  const int e1 = s.row_ptr[r + 1];
  float m1 = kInf, m2 = kInf;
  int nzero = 0, neg = 0, parity = 0;
#pragma unroll 4
  for (int e = e0; e < e1; ++e) {
    const int w = s.row_edge[e];
    int zz = z + (w >> 16);
    if (zz >= p.zc) zz -= p.zc;
    const float q = *slot<CL>(lq + (w & 0xffff), zz, p);
    if (SYN) parity ^= q < 0.f;
    const float v = __fsub_rn(
        q, LAYERED ? lr[e * p.zl + zi] : *slot<CL>(lr + e * p.zl, zz, p));
    const float mg = fabsf(v);
    m2 = fminf(m2, FAST && mg == m1 ? kInf : fmaxf(m1, mg));
    m1 = fminf(m1, mg);
    if (!FAST) nzero += v == 0.f;
    neg ^= v < 0.f;
  }
  const Messages<FAST> msgs(p, m1, m2, nzero, neg);
#pragma unroll 4
  for (int e = e0; e < e1; ++e) {
    const int w = s.row_edge[e];
    int zz = z + (w >> 16);
    if (zz >= p.zc) zz -= p.zc;
    float* qp = slot<CL>(lq + (w & 0xffff), zz, p);
    float* lp = LAYERED ? lr + e * p.zl + zi : slot<CL>(lr + e * p.zl, zz, p);
    const float v = __fsub_rn(*qp, *lp);
    const float msg = msgs(v);
    *lp = msg;
    if (LAYERED) *qp = __fadd_rn(v, msg);
  }
  return parity;
}

// the check node of row r at the width of the row's degree class
template <bool FAST, bool LAYERED, bool CL, bool SYN>
__device__ __forceinline__ int check(const Params& p, const Smem& s, int r,
                                     float* lq, float* lr, int z, int zi) {
  const int d = s.row_ptr[r + 1] - s.row_ptr[r];
  if (d <= 6) return check_row<6, FAST, LAYERED, CL, SYN>(p, s, r, lq, lr, z,
                                                          zi);
  if (d <= kHold)
    return check_row<kHold, FAST, LAYERED, CL, SYN>(p, s, r, lq, lr, z, zi);
  return check_row_wide<FAST, LAYERED, CL, SYN>(p, s, r, lq, lr, z, zi);
}

// Flooded variable node (c, z): llr0 + the column's messages, rows
// ascending; the messages sit at the variable's own lifting index, in this
// block (zi local, z global)
__device__ __forceinline__ float variable_node(const Params& p,
                                               const Smem& s, int c,
                                               const float* llr,
                                               const float* lr, int z,
                                               int zi) {
  float acc = c < 2 ? 0.f : __ldg(llr + (c - 2) * p.zc + z);
  const int q1 = s.col_ptr[c + 1];
#pragma unroll 8
  for (int q = s.col_ptr[c]; q < q1; ++q)
    acc = __fadd_rn(acc, lr[s.col_edge[q] + zi]);
  return acc;
}

// Copies the tables, builds the sub-task table, clears the flags, loads
// this block's slice of llr0 into LQ and zeroes LR.
__device__ inline void init_block(const Params& p, const Smem& s, int* sm,
                                  int cw0, int gcount, int z0, int zn) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int ntab = table_ints(p.nrows, p.ncols, p.ne, p.nphase);
  // the edge words with the slice width applied: LQ offset of the column
  // | shift << 16 per row edge, LR offset per column edge
  const int re0 = p.nrows + 1, ce0 = re0 + p.ne + p.ncols + 1;
  for (int k = tid; k < ntab; k += nthr) {
    const int w = p.tab[k];
    sm[k] = k >= re0 && k < re0 + p.ne
                ? (w & 0xffff) * p.zl | (w & ~0xffff)
                : (k >= ce0 && k < ce0 + p.ne ? w * p.zl : w);
  }
  const int cpw = 32 >> p.seg_shift;
  for (int k = tid; k < p.nsub; k += nthr)
    s.sub[k] = (k / p.nchunk) * cpw | ((k % p.nchunk) << p.seg_shift) << 16;
  for (int k = tid; k < 4 * p.group; k += nthr) s.done[k] = 0;
  const int per_cw = p.ncols * p.zl;
  for (int k = tid; k < p.group * per_cw; k += nthr) {
    const int g = k / per_cw;
    const int c = (k - g * per_cw) / p.zl;
    const int zi = k - g * per_cw - c * p.zl;
    s.lq[k] = g < gcount && zi < zn && c >= 2
                  ? p.llr[(static_cast<size_t>(cw0 + g) * (p.ncols - 2) + c
                           - 2) * p.zc + z0 + zi]
                  : 0.f;
  }
  for (int k = tid; k < gcount * p.ne * p.zl; k += nthr) s.lr[k] = 0.f;
}

// Calls f(a, sub) for this warp's share of the tasks a0 <= a < a1,
// 0 <= sub < nsub, in the order a * nsub + sub.
struct Tasks {
  int wa, ws, da, ds, nsub;
  __device__ Tasks(int nsub_) : nsub(nsub_) {
    const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    wa = warp / nsub;
    ws = warp - wa * nsub;
    da = nw / nsub;
    ds = nw - da * nsub;
  }
  template <typename F>
  __device__ __forceinline__ void run(int a0, int a1, F f) const {
    int a = a0 + wa, sb = ws;
    while (a < a1) {
      f(a, sb);
      a += da;
      sb += ds;
      if (sb >= nsub) {
        sb -= nsub;
        ++a;
      }
    }
  }
};

// Decide after a parity pass: ORs the parity flags of the cluster's
// blocks (one remote load per thread and block, all in flight together);
// a codeword with a zero syndrome converges (done = 2, ok = 1, iters =
// it), FINAL: ok = the final syndrome. Returns, block-uniformly, whether
// some codeword stays active. s.act must be zero on entry.
template <bool CL>
__device__ __forceinline__ int decide(const Params& p, const Smem& s,
                                      int cur, int cw0, int gcount, int rank,
                                      int nblk, int it, bool final_rule) {
  const int t = threadIdx.x;
  if constexpr (CL) {
    for (int i = t; i < gcount * nblk; i += blockDim.x) {
      const int g = i / nblk;
      if (*cg::this_cluster().map_shared_rank(s.bad + cur * p.group + g,
                                              i - g * nblk))
        atomicOr(s.act + g, 1);
    }
    __syncthreads();
  }
  int active = 0;
  if (t < gcount) {
    int d = s.done[t];
    if (d == 2) s.done[t] = d = 1;
    if (d == 0) {
      const int b = CL ? s.act[t] : s.bad[cur * p.group + t];
      if (final_rule) {
        if (rank == 0) {
          p.ok[cw0 + t] = b ? 0 : 1;
          if (p.iters != nullptr) p.iters[cw0 + t] = p.n_iter;
        }
      } else if (b) {
        active = 1;
      } else {
        s.done[t] = 2;
        if (rank == 0) {
          p.ok[cw0 + t] = 1;
          if (p.iters != nullptr) p.iters[cw0 + t] = it;
        }
      }
    }
    s.act[t] = active;
    s.bad[(cur ^ 1) * p.group + t] = 0;
  }
  return __syncthreads_or(active);
}

// One cluster of K blocks (K = 1 without CL) decodes G codewords.
template <bool FAST, bool LAYERED, bool CL>
__global__ void __launch_bounds__(LAYERED ? kMaxThreadsLayered
                                          : kMaxThreadsFlooded)
    decode_kernel(const Params p) {
  extern __shared__ __align__(16) int sm[];
  int nblk = 1, rank = 0;
  if constexpr (CL) {
    nblk = static_cast<int>(cg::this_cluster().num_blocks());
    rank = static_cast<int>(cg::this_cluster().block_rank());
  }
  const int G = p.group;
  const int cw0 = static_cast<int>(blockIdx.x) / nblk * G;
  const Smem s = carve(p, sm, cw0);
  const int gcount = min(G, p.batch - cw0);
  const int z0 = rank * p.zl;
  const int zn = min(p.zl, p.zc - z0);
  init_block(p, s, sm, cw0, gcount, z0, zn);
  sync<CL>();

  const int lane = threadIdx.x & 31;
  const int gsub = lane >> p.seg_shift;
  const int zsub = lane & ((1 << p.seg_shift) - 1);
  const Tasks tasks(p.nsub);
  const size_t cw_len = static_cast<size_t>(p.ncols) * p.zc;
  const size_t in_len = cw_len - 2 * p.zc;
  // this lane's codeword and local lifting index in sub-task sb
  auto lane_at = [&](int sb, int& g, int& zi) {
    const int info = s.sub[sb];
    g = (info & 0xffff) + gsub;
    zi = (info >> 16) + zsub;
    return g < gcount && zi < zn;
  };
  auto write_bits = [&](int want, bool final_rule) {
    tasks.run(0, p.ncols, [&](int c, int sb) {
      int g, zi;
      if (!lane_at(sb, g, zi) || s.done[g] != want) return;
      const float q = s.lq[(g * p.ncols + c) * p.zl + zi];
      p.bits[(cw0 + g) * cw_len + c * p.zc + z0 + zi] =
          (final_rule ? q <= 0.f : q < 0.f) ? 1 : 0;
    });
  };

  int it = 0;
  for (; it < p.n_iter; ++it) {
    const int cur = it & 1;
    // act was last read before the barrier that ended the last iteration
    if (threadIdx.x < G) s.act[threadIdx.x] = 0;
    tasks.run(0, p.nrows, [&](int a, int sb) {
      int g, zi;
      if (!lane_at(sb, g, zi) || s.done[g]) return;
      const int r = s.row_order[a];
      float* lq = s.lq + g * p.ncols * p.zl;
      int par;
      if constexpr (LAYERED)
        par = parity<CL>(p, s, r, lq, z0 + zi, false);
      else
        par = check<FAST, false, CL, true>(p, s, r, lq,
                                           s.lr + g * p.ne * p.zl, z0 + zi,
                                           zi);
      if (par) s.bad[cur * G + g] = 1;
    });
    sync<CL>();
    const int any = decide<CL>(p, s, cur, cw0, gcount, rank, nblk, it, false);
    if constexpr (LAYERED) {
      write_bits(2, false);
      if (!any) break;
      for (int ph = 0; ph < p.nphase; ++ph) {
        tasks.run(s.phase_ptr[ph], s.phase_ptr[ph + 1], [&](int r, int sb) {
          int g, zi;
          if (!lane_at(sb, g, zi) || !s.act[g]) return;
          check<FAST, true, CL, false>(p, s, r, s.lq + g * p.ncols * p.zl,
                                       s.lr + g * p.ne * p.zl, z0 + zi, zi);
        });
        sync<CL>();
      }
    } else {
      tasks.run(0, p.ncols, [&](int a, int sb) {
        int g, zi;
        if (!lane_at(sb, g, zi)) return;
        const int c = s.col_order[a];
        float* q = s.lq + (g * p.ncols + c) * p.zl + zi;
        if (s.act[g])
          *q = variable_node(p, s, c, p.llr + (cw0 + g) * in_len,
                             s.lr + g * p.ne * p.zl, z0 + zi, zi);
        else if (s.done[g] == 2)
          p.bits[(cw0 + g) * cw_len + c * p.zc + z0 + zi] = *q < 0.f ? 1 : 0;
      });
      if (!any) break;
      sync<CL>();
    }
  }
  if (it == p.n_iter) {
    // codewords still active after n_iter updates: the final rule
    const int cur = it & 1;
    if (threadIdx.x < G) s.act[threadIdx.x] = 0;
    tasks.run(0, p.nrows, [&](int a, int sb) {
      int g, zi;
      if (!lane_at(sb, g, zi) || s.done[g]) return;
      if (parity<CL>(p, s, s.row_order[a], s.lq + g * p.ncols * p.zl,
                     z0 + zi, true))
        s.bad[cur * G + g] = 1;
    });
    sync<CL>();
    decide<CL>(p, s, cur, cw0, gcount, rank, nblk, it, true);
    write_bits(0, true);
  }
  // no block leaves while another may still read its shared memory
  if constexpr (CL) cg::this_cluster().sync();
}

// Layered schedule for liftings up to 32 (K = 1, zl = Zc): a warp owns
// 32 / S whole codewords, sweeps the rows in order with only __syncwarp
// between them, and stops when its own codewords have converged.
template <bool FAST>
__global__ void __launch_bounds__(kMaxThreadsWarp)
    decode_warp_kernel(const Params p) {
  extern __shared__ __align__(16) int sm[];
  const int G = p.group;
  const int cw0 = static_cast<int>(blockIdx.x) * G;
  const Smem s = carve(p, sm, cw0);
  const int gcount = min(G, p.batch - cw0);
  init_block(p, s, sm, cw0, gcount, 0, p.zc);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int S = 1 << p.seg_shift;
  const int cpw = 32 / S;
  const int gsub = lane / S;
  const int zi = lane & (S - 1);
  const unsigned seg = S == 32 ? 0xffffffffu : ((1u << S) - 1) << (gsub * S);
  const size_t cw_len = static_cast<size_t>(p.ncols) * p.zc;
  for (int g0 = (threadIdx.x >> 5) * cpw; g0 < gcount;
       g0 += (blockDim.x >> 5) * cpw) {
    const int g = min(g0 + gsub, G - 1);
    bool done = !(g0 + gsub < gcount && zi < p.zc);
    float* lq = s.lq + g * p.ncols * p.zc;
    float* lr = s.lr + g * p.ne * p.zc;
    int8_t* bc = p.bits + (cw0 + g) * cw_len;
    int it = 0;
    for (; it < p.n_iter; ++it) {
      int par = 0;
      if (!done)
        for (int r = 0; r < p.nrows; ++r)
          par |= parity<false>(p, s, r, lq, zi, false);
      const bool bad = (__ballot_sync(0xffffffffu, par) & seg) != 0;
      if (!done && !bad) {
        for (int c = 0; c < p.ncols; ++c)
          bc[c * p.zc + zi] = lq[c * p.zc + zi] < 0.f ? 1 : 0;
        if (zi == 0) {
          p.ok[cw0 + g] = 1;
          if (p.iters != nullptr) p.iters[cw0 + g] = it;
        }
        done = true;
      }
      if (!__any_sync(0xffffffffu, !done)) break;
      for (int r = 0; r < p.nrows; ++r) {
        if (!done) check<FAST, true, false, false>(p, s, r, lq, lr, zi, zi);
        __syncwarp();
      }
    }
    int par = 0;
    if (!done)
      for (int r = 0; r < p.nrows; ++r)
        par |= parity<false>(p, s, r, lq, zi, true);
    const bool bad = (__ballot_sync(0xffffffffu, par) & seg) != 0;
    if (!done) {
      for (int c = 0; c < p.ncols; ++c)
        bc[c * p.zc + zi] = lq[c * p.zc + zi] <= 0.f ? 1 : 0;
      if (zi == 0) {
        p.ok[cw0 + g] = bad ? 0 : 1;
        if (p.iters != nullptr) p.iters[cw0 + g] = p.n_iter;
      }
    }
  }
}

using KernelFn = void (*)(Params);

template <bool FAST, bool LAYERED>
KernelFn pick_cluster(bool cl) {
  return cl ? decode_kernel<FAST, LAYERED, true>
            : decode_kernel<FAST, LAYERED, false>;
}

// Launches G = p.group codewords per cluster of `cluster` blocks of
// `threads` threads, with slices of zl lifting indices (zl = Zc for one
// block; else a power of two >= 8 with ceil(Zc / zl) == cluster); LR in
// p.lr_dev (one block per cluster only) or in shared memory. WARP:
// the warp-per-codeword layered kernel (Zc <= 32, one block per cluster);
// only entries compiled WITH_WARP have it. Returns the CUDA error (0 on
// success; cudaErrorInvalidValue for parameters the kernel does not take
// or state that does not fit the device's shared memory). Never retries
// with other parameters.
template <bool WITH_WARP>
int launch(Params p, int fast, int layered, int cluster, int zl, int threads,
           int warp, cudaStream_t stream) {
  if (p.batch <= 0) return 0;
  const cudaError_t bad_arg = cudaErrorInvalidValue;
  if (cluster < 1 || cluster > kMaxCluster || p.group < 1
      || p.group > kMaxGroup || threads < 32 || threads > 1024
      || threads % 32 || p.zc < 1 || p.zc > 0xffff)
    return bad_arg;
  p.zl = zl;
  p.zl_shift = 0;
  if (p.lr_dev && (cluster != 1 || warp)) return bad_arg;
  if (threads > (warp ? kMaxThreadsWarp
                      : layered ? kMaxThreadsLayered : kMaxThreadsFlooded))
    return bad_arg;
  if (cluster == 1) {
    if (zl != p.zc) return bad_arg;
  } else {
    if (zl < 8 || (zl & (zl - 1)) || (p.zc + zl - 1) / zl != cluster)
      return bad_arg;
    while ((1 << p.zl_shift) < zl) ++p.zl_shift;
  }
  int seg = 1;
  p.seg_shift = 0;
  while (seg < zl && seg < 32) {
    seg *= 2;
    ++p.seg_shift;
  }
  const int cpw = 32 / seg;
  p.nchunk = (zl + seg - 1) / seg;
  p.nsub = (p.group + cpw - 1) / cpw * p.nchunk;

  KernelFn kernel;
  if (warp) {
    if constexpr (WITH_WARP) {
      if (cluster != 1 || !layered || p.zc > 32) return bad_arg;
      kernel = fast ? decode_warp_kernel<true> : decode_warp_kernel<false>;
    } else {
      return bad_arg;
    }
  } else if (fast) {
    kernel = layered ? pick_cluster<true, true>(cluster > 1)
                     : pick_cluster<true, false>(cluster > 1);
  } else {
    kernel = layered ? pick_cluster<false, true>(cluster > 1)
                     : pick_cluster<false, false>(cluster > 1);
  }

  const size_t smem = smem_bytes(p);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a share that does not fit is the caller's error, never a reason to
  // take another route
  if (smem > static_cast<size_t>(limit)) return bad_arg;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int nclusters = (p.batch + p.group - 1) / p.group;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nclusters * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  if (cluster > 1) {
    // a cluster the card cannot place is an error, not a slower launch
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (active < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ldpc
