"""Batched flooded min-sum LDPC decoder (min-sum / NMS / OMS / mixed).

Port of python_5gtoolbox_tpu/ops/ldpc/decode.py (flooded schedule,
exact semantics). The per-edge check-node message is

    msg_j = alpha * (prod_{i!=j} sign(Lq_i)) * max(min_{i!=j}|Lq_i| - beta, 0)

with sign(0) = 0 and exactly one instance of the minimum excluded on ties
(the first). Each iteration first checks the syndrome of the hard
decision (LQ < 0) and freezes converged codewords; after n_iter
iterations the final rule (LQ <= 0) applies.

On a CUDA tensor ldpc_decode launches the hand-written kernel
csrc/ldpc_minsum.cu (ldpc_minsum_flooded); on a CPU tensor it runs
_ldpc_decode_plain, which mirrors the JAX _ldpc_decode_jit op for op and
is bit-identical to it. The layered schedule, the relaxed "fast" check
node, belief propagation and bit flipping are not ported yet.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from python_5gtoolbox_tpu_torch import kernels
from python_5gtoolbox_tpu_torch.ops.ldpc.tables import BG_DIMS, shift_table

_INF = 1e30


@functools.lru_cache(maxsize=None)
def _graph(bgn: int, zc: int):
    """Static edge list grouped by check row: [[(col, shift), ...], ...]."""
    nrows, ncols = BG_DIMS[bgn]
    st = shift_table(bgn, zc)
    rows = [[(int(c), int(st[r, c])) for c in range(ncols) if st[r, c] >= 0]
            for r in range(nrows)]
    return rows, nrows, ncols


@functools.lru_cache(maxsize=None)
def _kernel_tables(bgn: int, zc: int) -> np.ndarray:
    """int32 [row_ptr | e_col | e_shift | col_ptr | col_edge] for the
    kernel; col_edge lists each column's edges in ascending row order,
    the JAX decoder's variable-node summation order."""
    rows, nrows, ncols = _graph(bgn, zc)
    row_ptr = np.cumsum([0] + [len(r) for r in rows])
    e_col = np.array([c for r in rows for c, _ in r])
    e_shift = np.array([p for r in rows for _, p in r])
    col_edge = np.concatenate([np.nonzero(e_col == c)[0]
                               for c in range(ncols)])
    col_ptr = np.cumsum([0] + [int((e_col == c).sum())
                               for c in range(ncols)])
    return np.concatenate([row_ptr, e_col, e_shift, col_ptr, col_edge]
                          ).astype(np.int32)


def _fwd(x, p):
    """Check-node view of a variable block with edge shift p: roll(v, -p)."""
    return x if p == 0 else torch.roll(x, -p, dims=-1)


def _bwd(x, p):
    return x if p == 0 else torch.roll(x, p, dims=-1)


def _check_node_minsum(lq, alpha, beta):
    """lq: (B, d, Zc) extrinsic inputs -> (B, d, Zc) messages."""
    sign = torch.sign(lq)
    mag = torch.abs(lq)
    m1 = torch.amin(mag, dim=1, keepdim=True)
    is_min = mag == m1
    first = (torch.cumsum(is_min.to(torch.int32), dim=1) * is_min) == 1
    m2 = torch.amin(torch.where(first, torch.full_like(mag, _INF), mag),
                    dim=1, keepdim=True)
    min_excl = torch.where(is_min, m2, m1)
    zero = sign == 0
    nzero = zero.to(torch.int32).sum(dim=1, keepdim=True)
    prod_nz = torch.prod(torch.where(zero, torch.ones_like(sign), sign),
                         dim=1, keepdim=True)
    excl_sign = torch.where(
        nzero == 0, prod_nz * sign,
        torch.where((nzero == 1) & zero, prod_nz, torch.zeros_like(sign)))
    return alpha * excl_sign * torch.clamp(min_excl - beta, min=0.0)


def _syndrome_ok(bits: torch.Tensor, rows) -> torch.Tensor:
    """bits (B, ncols, Zc) bool -> (B,) True where every check holds."""
    b32 = bits.to(torch.int32)
    ok = None
    for edges in rows:
        acc = None
        for c, p in edges:
            v = _fwd(b32[:, c], p)
            acc = v if acc is None else acc + v
        row_ok = torch.all(acc % 2 == 0, dim=-1)
        ok = row_ok if ok is None else ok & row_ok
    return ok


def _ldpc_decode_plain(llr_in: torch.Tensor, zc: int, bgn: int,
                       n_iter: int, alpha: float, beta: float):
    """Plain-torch flooded min-sum; mirrors decode._ldpc_decode_jit."""
    rows, _, ncols = _graph(bgn, zc)
    b = llr_in.shape[0]
    k = (22 if bgn == 1 else 10) * zc
    llr0 = torch.cat([llr_in.new_zeros((b, 2 * zc)), llr_in], dim=-1
                     ).reshape(b, ncols, zc).to(torch.float32)
    alpha = torch.tensor(alpha, dtype=torch.float32, device=llr_in.device)
    beta = torch.tensor(beta, dtype=torch.float32, device=llr_in.device)
    n_edges = sum(len(e) for e in rows)
    lq_post = llr0
    lr = llr0.new_zeros((b, n_edges, zc))
    done = torch.zeros(b, dtype=torch.bool, device=llr_in.device)
    out_bits = torch.zeros((b, ncols, zc), dtype=torch.bool,
                           device=llr_in.device)
    for _ in range(n_iter):
        bits = lq_post < 0
        ok = _syndrome_ok(bits, rows)
        newly = ok & ~done
        out_bits = torch.where(newly[:, None, None], bits, out_bits)
        done = done | ok

        new_lr_rows = []
        e0 = 0
        for edges in rows:
            lq_edges = torch.stack([_fwd(lq_post[:, c], p)
                                    for c, p in edges], dim=1)
            lr_row = lr[:, e0:e0 + len(edges)]
            new_lr_rows.append(_check_node_minsum(lq_edges - lr_row,
                                                  alpha, beta))
            e0 += len(edges)
        new_lr = torch.cat(new_lr_rows, dim=1)

        acc = [llr0[:, c] for c in range(ncols)]
        e0 = 0
        for edges in rows:
            for j, (c, p) in enumerate(edges):
                acc[c] = acc[c] + _bwd(new_lr[:, e0 + j], p)
            e0 += len(edges)
        new_lq = torch.stack(acc, dim=1)

        keep = done[:, None, None]
        lq_post = torch.where(keep, lq_post, new_lq)
        lr = torch.where(keep, lr, new_lr)

    fbits = lq_post <= 0
    fok = _syndrome_ok(fbits, rows)
    out_bits = torch.where(done[:, None, None], out_bits, fbits)
    ok = done | fok
    full = out_bits.reshape(b, ncols * zc).to(torch.int8)
    return full[:, :k], ok, full


@functools.lru_cache(maxsize=16)
def _device_tables(bgn: int, zc: int, device: torch.device):
    return torch.as_tensor(_kernel_tables(bgn, zc), device=device)


def ldpc_minsum_flooded(llr_in: torch.Tensor, zc: int, bgn: int,
                        n_iter: int, alpha: float = 1.0, beta: float = 0.0,
                        iters_out: torch.Tensor | None = None):
    """Decode (B, N) punctured-codeword LLRs on the card with the
    hand-written kernel; replaces
    python_5gtoolbox_tpu/ops/ldpc/pallas_decode.py:_make_kernel
    (flooded, exact). Returns (bits (B, K) int8, ok (B,) bool,
    full_bits (B, ncols*Zc) int8). iters_out, a (B,) int32 CUDA tensor,
    receives the number of updates each codeword ran (it stops once its
    syndrome is zero)."""
    if llr_in.device.type != "cuda":
        raise ValueError("ldpc_minsum_flooded needs a CUDA tensor")
    if llr_in.dtype != torch.float32 or llr_in.dim() != 2:
        raise ValueError("ldpc_minsum_flooded: llr_in must be 2-D float32")
    rows, nrows, ncols = _graph(bgn, zc)
    if llr_in.shape[1] != (ncols - 2) * zc:
        raise ValueError(f"llr_in has {llr_in.shape[1]} columns, expected "
                         f"{(ncols - 2) * zc}")
    b = llr_in.shape[0]
    n_edges = sum(len(e) for e in rows)
    maxd = max(len(e) for e in rows)
    dev = llr_in.device
    llr0 = torch.cat([llr_in.new_zeros((b, 2 * zc)), llr_in],
                     dim=-1).contiguous()
    tab = _device_tables(bgn, zc, dev)
    lr = torch.empty((b, n_edges * zc), dtype=torch.float32, device=dev)
    full = torch.empty((b, ncols * zc), dtype=torch.int8, device=dev)
    ok = torch.empty(b, dtype=torch.int32, device=dev)
    if iters_out is not None and (iters_out.shape != (b,)
                                  or iters_out.dtype != torch.int32
                                  or iters_out.device != dev):
        raise ValueError("iters_out must be a (B,) int32 tensor on the "
                         "input's device")
    fn = kernels.library("ldpc_minsum").ldpc_minsum_flooded
    rc = fn(llr0.data_ptr(), tab.data_ptr(), b, nrows, ncols, n_edges, zc,
            maxd, n_iter, float(alpha), float(beta), lr.data_ptr(),
            full.data_ptr(), ok.data_ptr(),
            None if iters_out is None else iters_out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    kernels.check("ldpc_minsum_flooded", rc)
    kernels.LAUNCHES["ldpc_minsum_flooded"] += 1
    k = (22 if bgn == 1 else 10) * zc
    return full[:, :k], ok.to(torch.bool), full


def ldpc_decode(llr_in: torch.Tensor, zc: int, bgn: int, n_iter: int,
                algo: str = "min-sum", alpha: float = 1.0, beta: float = 0.0,
                schedule: str = "flooded", semantics: str = "exact"):
    """Decode (B, N) LLRs (punctured codeword, LLR>0 => bit 0).

    Returns (bits (B, K) int8, ok (B,) bool, full_bits (B, ncols*Zc)).
    The 2*Zc punctured systematic LLRs are internally re-inserted as 0.
    Only the flooded exact min-sum family is ported; other schedules,
    semantics and algorithms raise NotImplementedError.
    """
    if algo != "min-sum" or schedule != "flooded" or semantics != "exact":
        raise NotImplementedError(
            f"ldpc_decode: only flooded exact min-sum is ported (got "
            f"algo={algo!r}, schedule={schedule!r}, semantics={semantics!r})")
    llr_in = llr_in.to(torch.float32)
    if llr_in.device.type == "cpu":
        return _ldpc_decode_plain(llr_in, zc, bgn, n_iter, alpha, beta)
    return ldpc_minsum_flooded(llr_in, zc, bgn, n_iter, alpha, beta)
