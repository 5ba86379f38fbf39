"""Min-sum LDPC decoding, plain PyTorch (frozen copy).

A frozen copy of the port's ops/ldpc/decode.py, cut to its plain decoder
(flooded or layered schedule, the exact or the relaxed check node, BP):
the loop of tensor operations that the port's CUDA kernels reproduce bit
for bit. Here it runs on whatever device the LLRs are on.
"""
from __future__ import annotations

import functools

import torch

from portbench.reference.frozen.ops.ldpc.tables import BG_DIMS, shift_table

_INF = 1e30
_ATANH_CLAMP = 19.07   # the reference's atanh saturation


@functools.lru_cache(maxsize=None)
def _graph(bgn: int, zc: int):
    """Static edge list grouped by check row: [[(col, shift), ...], ...]."""
    nrows, ncols = BG_DIMS[bgn]
    st = shift_table(bgn, zc)
    rows = [[(int(c), int(st[r, c])) for c in range(ncols) if st[r, c] >= 0]
            for r in range(nrows)]
    return rows, nrows, ncols


def _fwd(x, p):
    """Check-node view of a variable block with edge shift p: roll(v, -p)."""
    return x if p == 0 else torch.roll(x, -p, dims=-1)


def _bwd(x, p):
    return x if p == 0 else torch.roll(x, p, dims=-1)


def _excl_sign(sign):
    """Product of the other edges' signs with sign(0) = 0, from
    sign (B, d, Zc); also the zero mask and the zero count."""
    zero = sign == 0
    nzero = zero.to(torch.int32).sum(dim=1, keepdim=True)
    prod_nz = torch.prod(torch.where(zero, torch.ones_like(sign), sign),
                         dim=1, keepdim=True)
    excl = torch.where(
        nzero == 0, prod_nz * sign,
        torch.where((nzero == 1) & zero, prod_nz, torch.zeros_like(sign)))
    return excl, zero, nzero


def _check_node_minsum(lq, alpha, beta):
    """lq: (B, d, Zc) extrinsic inputs -> (B, d, Zc) messages."""
    mag = torch.abs(lq)
    m1 = torch.amin(mag, dim=1, keepdim=True)
    is_min = mag == m1
    first = (torch.cumsum(is_min.to(torch.int32), dim=1) * is_min) == 1
    m2 = torch.amin(torch.where(first, torch.full_like(mag, _INF), mag),
                    dim=1, keepdim=True)
    min_excl = torch.where(is_min, m2, m1)
    excl_sign, _, _ = _excl_sign(torch.sign(lq))
    return alpha * excl_sign * torch.clamp(min_excl - beta, min=0.0)


def _check_node_minsum_fast(lq, alpha, beta):
    """The relaxed check node, in the TPU kernel's order of operations:
    ((alpha * prod) * sgn_k) * max(min_excl - beta, 0)."""
    sgn = torch.where(lq < 0, -torch.ones_like(lq), torch.ones_like(lq))
    mag = torch.abs(lq)
    m1 = torch.amin(mag, dim=1, keepdim=True)
    is_min = mag == m1
    m2 = torch.amin(torch.where(is_min, torch.full_like(mag, _INF), mag),
                    dim=1, keepdim=True)
    prod = torch.prod(sgn, dim=1, keepdim=True)
    min_excl = torch.where(is_min, m2, m1)
    return alpha * prod * sgn * torch.clamp(min_excl - beta, min=0.0)


def _check_node_bp(lq, alpha=None, beta=None):
    """Sum-product check node with the reference's atanh clamping."""
    t = torch.tanh(lq / 2.0)
    mag = torch.abs(t)
    # the floor stays above the float32 denormal range
    logm = torch.log(torch.clamp(mag, min=1e-30))
    excl_mag = torch.exp(logm.sum(dim=1, keepdim=True) - logm)
    excl_sign, zero, nzero = _excl_sign(torch.sign(t))
    v = excl_sign * torch.where(
        nzero > 0, torch.where(zero, excl_mag, torch.zeros_like(excl_mag)),
        excl_mag)
    # with a zero input present the reference writes the raw tanh product
    bp_main = 2.0 * torch.atanh(torch.clamp(v, -1 + 1e-16, 1 - 1e-16))
    bp_main = torch.clamp(bp_main, -2 * _ATANH_CLAMP, 2 * _ATANH_CLAMP)
    return torch.where(nzero == 0, bp_main, v)


def _syndrome(bits: torch.Tensor, rows) -> torch.Tensor:
    """bits (B, ncols, Zc) -> (B, nrows, Zc) int32 parity of each check."""
    b32 = bits.to(torch.int32)
    out = []
    for edges in rows:
        acc = None
        for c, p in edges:
            v = _fwd(b32[:, c], p)
            acc = v if acc is None else acc + v
        out.append(acc % 2)
    return torch.stack(out, dim=1)


def _syndrome_ok(bits: torch.Tensor, rows) -> torch.Tensor:
    """bits (B, ncols, Zc) bool -> (B,) True where every check holds."""
    return torch.all(_syndrome(bits, rows).flatten(1) == 0, dim=-1)


def _ldpc_decode_plain(llr_in: torch.Tensor, zc: int, bgn: int,
                       n_iter: int, alpha: float, beta: float,
                       schedule: str = "flooded", semantics: str = "exact",
                       algo: str = "min-sum"):
    """Plain-torch decoder; mirrors decode._ldpc_decode_jit (both
    schedules, min-sum family and BP) and, with semantics="fast", the TPU
    kernels' relaxed check node. On the CPU the loop stops once every
    codeword has converged (the later iterations would change nothing);
    on the card it runs n_iter times without reading done on the host."""
    rows, _, ncols = _graph(bgn, zc)
    b = llr_in.shape[0]
    k = (22 if bgn == 1 else 10) * zc
    llr0 = torch.cat([llr_in.new_zeros((b, 2 * zc)), llr_in], dim=-1
                     ).reshape(b, ncols, zc).to(torch.float32)
    alpha = torch.tensor(alpha, dtype=torch.float32, device=llr_in.device)
    beta = torch.tensor(beta, dtype=torch.float32, device=llr_in.device)
    if algo == "BP":
        check_node = _check_node_bp
    else:
        check_node = (_check_node_minsum_fast if semantics == "fast"
                      else _check_node_minsum)
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
        if not llr_in.is_cuda and bool(done.all()):
            break

        new_lr_rows = []
        e0 = 0
        if schedule == "flooded":
            for edges in rows:
                lq_edges = torch.stack([_fwd(lq_post[:, c], p)
                                        for c, p in edges], dim=1)
                lr_row = lr[:, e0:e0 + len(edges)]
                new_lr_rows.append(check_node(lq_edges - lr_row, alpha,
                                              beta))
                e0 += len(edges)
            new_lr = torch.cat(new_lr_rows, dim=1)

            acc = [llr0[:, c] for c in range(ncols)]
            e0 = 0
            for edges in rows:
                for j, (c, p) in enumerate(edges):
                    acc[c] = acc[c] + _bwd(new_lr[:, e0 + j], p)
                e0 += len(edges)
            new_lq = torch.stack(acc, dim=1)
        else:
            # layered: each row reads the LQ the rows before it wrote
            cur = list(lq_post.unbind(dim=1))
            for edges in rows:
                lq_edges = torch.stack([_fwd(cur[c], p) for c, p in edges],
                                       dim=1)
                ext = lq_edges - lr[:, e0:e0 + len(edges)]
                msg = check_node(ext, alpha, beta)
                new_lr_rows.append(msg)
                upd = ext + msg
                for j, (c, p) in enumerate(edges):
                    cur[c] = _bwd(upd[:, j], p)
                e0 += len(edges)
            new_lq = torch.stack(cur, dim=1)
            new_lr = torch.cat(new_lr_rows, dim=1)

        keep = done[:, None, None]
        lq_post = torch.where(keep, lq_post, new_lq)
        lr = torch.where(keep, lr, new_lr)

    fbits = lq_post <= 0
    fok = _syndrome_ok(fbits, rows)
    out_bits = torch.where(done[:, None, None], out_bits, fbits)
    ok = done | fok
    full = out_bits.reshape(b, ncols * zc).to(torch.int8)
    return full[:, :k], ok, full


def ldpc_decode(llr_in: torch.Tensor, zc: int, bgn: int, n_iter: int,
                algo: str = "min-sum", alpha: float = 1.0, beta: float = 0.0,
                schedule: str = "flooded", semantics: str = "exact"):
    """Decode (B, N) LLRs (punctured codeword, LLR>0 => bit 0) ->
    (bits (B, K) int8, ok (B,) bool, full_bits (B, ncols*Zc))."""
    return _ldpc_decode_plain(llr_in.to(torch.float32), zc, bgn, n_iter,
                              alpha, beta, schedule, semantics, algo)
