"""Batched LDPC decoders: the min-sum family (min-sum / NMS / OMS / mixed),
belief propagation and hard-decision bit flipping.

Port of python_5gtoolbox_tpu/ops/ldpc/decode.py and of the two TPU
kernels of python_5gtoolbox_tpu/ops/ldpc/pallas_decode.py. The per-edge
check-node message of the min-sum family is

    msg_j = alpha * (prod_{i!=j} sign(Lq_i)) * max(min_{i!=j}|Lq_i| - beta, 0)

semantics="exact": sign(0) = 0 and exactly one instance of the minimum
(the first) excluded on ties, the reference's rules. semantics="fast":
sign(0) = +1 and every instance of the minimum excluded
(pallas_decode._check_node_minsum_fast); BLER-equivalent, not
bit-identical to "exact".

schedule="flooded": every check row of an iteration reads the same LQ,
then LQ = llr0 + sum of the new messages. schedule="layered": the rows
are swept in order over a live LQ, LQ[c] = ext + msg landing before the
next row reads it.

Each iteration first checks the syndrome of the hard decision (LQ < 0)
and freezes converged codewords; after n_iter iterations the final rule
(LQ <= 0) applies.

On a CUDA tensor the min-sum family launches a hand-written kernel:
csrc/ldpc_minsum_packed.cu (ldpc_minsum_packed: the whole state of
several codewords in one block's shared memory) for liftings below 128
whose state fits, csrc/ldpc_minsum.cu (ldpc_minsum: one block per
codeword) otherwise; both give the same bits. On a CPU tensor it runs
_ldpc_decode_plain, which mirrors the JAX _ldpc_decode_jit op for op and
is bit-identical to it and to the TPU kernels. Belief propagation and
bit flipping have no TPU kernel in the JAX package; they are plain
tensor code on either device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from python_5gtoolbox_tpu_torch import kernels
from python_5gtoolbox_tpu_torch.ops.ldpc.tables import BG_DIMS, shift_table

_INF = 1e30
_ATANH_CLAMP = 19.07   # the reference's atanh saturation
# dynamic shared memory a block may opt in to on sm_90 (227 KB)
_SMEM_OPTIN_BYTES = 232448
_PACKED_MAX_GROUP = 32


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
    kernels; col_edge lists each column's edges in ascending row order,
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
    kernels' relaxed check node."""
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


# ---------------------------------------------------------------------------
# The two CUDA kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _device_tables(bgn: int, zc: int, device: torch.device):
    return torch.as_tensor(_kernel_tables(bgn, zc), device=device)


def _kernel_args(name, llr_in, zc, bgn, schedule, semantics, iters_out):
    """Checked inputs shared by both wrappers -> (llr0, tab, full, ok,
    iters pointer, nrows, ncols, n_edges, maxd)."""
    if llr_in.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor")
    if llr_in.dtype != torch.float32 or llr_in.dim() != 2:
        raise ValueError(f"{name}: llr_in must be 2-D float32")
    if schedule not in ("flooded", "layered"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if semantics not in ("exact", "fast"):
        raise ValueError(f"unknown semantics {semantics!r}")
    rows, nrows, ncols = _graph(bgn, zc)
    if llr_in.shape[1] != (ncols - 2) * zc:
        raise ValueError(f"llr_in has {llr_in.shape[1]} columns, expected "
                         f"{(ncols - 2) * zc}")
    b, dev = llr_in.shape[0], llr_in.device
    if iters_out is not None and (iters_out.shape != (b,)
                                  or iters_out.dtype != torch.int32
                                  or iters_out.device != dev):
        raise ValueError("iters_out must be a (B,) int32 tensor on the "
                         "input's device")
    llr0 = torch.cat([llr_in.new_zeros((b, 2 * zc)), llr_in],
                     dim=-1).contiguous()
    full = torch.empty((b, ncols * zc), dtype=torch.int8, device=dev)
    ok = torch.empty(b, dtype=torch.int32, device=dev)
    return (llr0, _device_tables(bgn, zc, dev), full, ok,
            None if iters_out is None else iters_out.data_ptr(),
            nrows, ncols, sum(len(e) for e in rows),
            max(len(e) for e in rows))


def ldpc_minsum(llr_in: torch.Tensor, zc: int, bgn: int, n_iter: int,
                alpha: float = 1.0, beta: float = 0.0,
                iters_out: torch.Tensor | None = None,
                schedule: str = "flooded", semantics: str = "exact"):
    """Decode (B, N) punctured-codeword LLRs on the card with the
    hand-written kernel csrc/ldpc_minsum.cu, one block per codeword;
    replaces python_5gtoolbox_tpu/ops/ldpc/pallas_decode.py:_make_kernel
    (both schedules, both check nodes). Returns (bits (B, K) int8, ok (B,)
    bool, full_bits (B, ncols*Zc) int8). iters_out, a (B,) int32 CUDA
    tensor, receives the number of updates each codeword ran (it stops
    once its syndrome is zero). The launch is counted in
    kernels.LAUNCHES["ldpc_minsum_<schedule>[_fast]"]."""
    llr0, tab, full, ok, iters, nrows, ncols, n_edges, maxd = _kernel_args(
        "ldpc_minsum", llr_in, zc, bgn, schedule, semantics, iters_out)
    b = llr_in.shape[0]
    lr = torch.empty((b, n_edges * zc), dtype=torch.float32,
                     device=llr_in.device)
    fn = kernels.library("ldpc_minsum").ldpc_minsum
    rc = fn(llr0.data_ptr(), tab.data_ptr(), b, nrows, ncols, n_edges, zc,
            maxd, n_iter, float(alpha), float(beta),
            int(schedule == "layered"), int(semantics == "fast"),
            lr.data_ptr(), full.data_ptr(), ok.data_ptr(), iters,
            torch.cuda.current_stream(llr_in.device).cuda_stream)
    kernels.check("ldpc_minsum", rc)
    kernels.LAUNCHES[f"ldpc_minsum_{schedule}"
                     + ("_fast" if semantics == "fast" else "")] += 1
    k = (22 if bgn == 1 else 10) * zc
    return full[:, :k], ok.to(torch.bool), full


def ldpc_minsum_flooded(llr_in: torch.Tensor, zc: int, bgn: int,
                        n_iter: int, alpha: float = 1.0, beta: float = 0.0,
                        iters_out: torch.Tensor | None = None):
    """ldpc_minsum with the flooded schedule and the exact check node."""
    return ldpc_minsum(llr_in, zc, bgn, n_iter, alpha, beta, iters_out)


def packed_group_limit(zc: int, bgn: int) -> int:
    """How many codewords' whole decode state (LQ and LR, float32) one
    block's shared memory holds beside the edge tables and two flags per
    codeword; 0 where not even one fits."""
    rows, nrows, ncols = _graph(bgn, zc)
    n_edges = sum(len(e) for e in rows)
    ntab = nrows + 1 + 3 * n_edges + ncols + 1
    per_cw = 4 * (ncols + n_edges) * zc + 8
    return min(_PACKED_MAX_GROUP, (_SMEM_OPTIN_BYTES - 4 * ntab) // per_cw)


def ldpc_minsum_packed(llr_in: torch.Tensor, zc: int, bgn: int, n_iter: int,
                       alpha: float = 1.0, beta: float = 0.0,
                       iters_out: torch.Tensor | None = None,
                       schedule: str = "flooded", semantics: str = "exact",
                       group: int | None = None, threads: int | None = None):
    """The small-lifting decoder csrc/ldpc_minsum_packed.cu; replaces
    python_5gtoolbox_tpu/ops/ldpc/pallas_decode.py:_make_kernel_packed.
    Same contract and same bits as ldpc_minsum. A block decodes `group`
    codewords whose LQ and LR all stay in its shared memory; by default
    the group is the smallest that still gives every SM a block, at most
    packed_group_limit(zc, bgn). group and threads (per block) override
    the defaults, for measurements. Raises ValueError where the state of
    one codeword does not fit."""
    llr0, tab, full, ok, iters, nrows, ncols, n_edges, maxd = _kernel_args(
        "ldpc_minsum_packed", llr_in, zc, bgn, schedule, semantics,
        iters_out)
    b, dev = llr_in.shape[0], llr_in.device
    g_max = packed_group_limit(zc, bgn)
    if g_max < 1:
        raise ValueError(f"ldpc_minsum_packed: the decode state of BG{bgn} / "
                         f"Zc {zc} does not fit in shared memory")
    if group is None:
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        group = min(g_max, max(1, -(-b // n_sm)))
    if not 1 <= group <= g_max:
        raise ValueError(f"group must be in 1..{g_max}")
    if threads is None:
        # one task per (codeword, row, lifting index) in a flooded
        # iteration. A layered row has only group * zc tasks, but the
        # syndrome and bit passes between the sweeps have nrows times as
        # many, and a barrier costs more the more warps wait at it: four
        # threads per row task, at least 256, measured best on the H100
        # (sim/tune_ldpc_packed.py)
        tasks = group * zc * (nrows if schedule == "flooded" else 4)
        floor = 32 if schedule == "flooded" else 256
        threads = min(1024, max(floor, -(-tasks // 32) * 32))
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError("threads must be a multiple of 32 in 32..1024")
    fn = kernels.library("ldpc_minsum_packed").ldpc_minsum_packed
    rc = fn(llr0.data_ptr(), tab.data_ptr(), b, nrows, ncols, n_edges, zc,
            maxd, n_iter, float(alpha), float(beta),
            int(schedule == "layered"), int(semantics == "fast"), group,
            threads, full.data_ptr(), ok.data_ptr(), iters,
            torch.cuda.current_stream(dev).cuda_stream)
    kernels.check("ldpc_minsum_packed", rc)
    kernels.LAUNCHES["ldpc_minsum_packed"] += 1
    k = (22 if bgn == 1 else 10) * zc
    return full[:, :k], ok.to(torch.bool), full


def ldpc_decode(llr_in: torch.Tensor, zc: int, bgn: int, n_iter: int,
                algo: str = "min-sum", alpha: float = 1.0, beta: float = 0.0,
                schedule: str = "flooded", semantics: str = "exact",
                layout: str = "auto"):
    """Decode (B, N) LLRs (punctured codeword, LLR>0 => bit 0).

    Returns (bits (B, K) int8, ok (B,) bool, full_bits (B, ncols*Zc)).
    The 2*Zc punctured systematic LLRs are internally re-inserted as 0.

    schedule "layered" and semantics "fast" are min-sum family only
    (ValueError with algo="BP"). layout chooses the kernel on a CUDA
    tensor: "packed" is ldpc_minsum_packed, "batch" is ldpc_minsum,
    "auto" takes the packed kernel for zc < 128 where the state fits in
    shared memory; the bits are the same either way. algo="BP" runs as
    plain tensor code on the tensor's device (the JAX package has no
    kernel for it either), and a CPU tensor always takes the plain
    version.
    """
    if schedule not in ("flooded", "layered"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if semantics not in ("exact", "fast"):
        raise ValueError(f"unknown semantics {semantics!r}")
    if layout not in ("auto", "batch", "packed"):
        raise ValueError(f"unknown layout {layout!r}")
    if semantics != "exact" and algo == "BP":
        raise ValueError("fast semantics is min-sum family only")
    if schedule == "layered" and algo == "BP":
        raise ValueError("layered schedule is min-sum family only")
    llr_in = llr_in.to(torch.float32)
    if llr_in.device.type == "cpu" or algo == "BP":
        return _ldpc_decode_plain(llr_in, zc, bgn, n_iter, alpha, beta,
                                  schedule, semantics, algo)
    if layout == "auto":
        layout = ("packed" if zc < 128 and packed_group_limit(zc, bgn) >= 1
                  else "batch")
    fn = ldpc_minsum_packed if layout == "packed" else ldpc_minsum
    return fn(llr_in, zc, bgn, n_iter, alpha, beta, schedule=schedule,
              semantics=semantics)


def ldpc_decode_bf(llr_full: torch.Tensor, zc: int, bgn: int, n_iter: int):
    """Hard-decision bit-flipping decoder over the FULL codeword.

    Syndrome, En = (2S-1) @ H accumulation on the lifted graph, flip all
    bits at max(En), early exit on zero syndrome. llr_full: (B, ncols*Zc)
    (unpunctured). Returns (bits (B, ncols*Zc) int8, ok (B,) bool). Plain
    tensor code on the tensor's device, as in the JAX package.
    """
    rows, _, ncols = _graph(bgn, zc)
    b = llr_full.shape[0]
    bits = (llr_full < 0).to(torch.int8).reshape(b, ncols, zc)
    done = torch.zeros(b, dtype=torch.bool, device=llr_full.device)
    for _ in range(n_iter):
        s = _syndrome(bits, rows)
        done = done | torch.all(s.flatten(1) == 0, dim=-1)
        e = 2 * s - 1
        en = [None] * ncols
        for r, edges in enumerate(rows):
            for c, p in edges:
                v = _bwd(e[:, r], p)
                en[c] = v if en[c] is None else en[c] + v
        en = torch.stack(en, dim=1)                        # (B, ncols, Zc)
        mx = torch.amax(en.flatten(1), dim=-1)[:, None, None]
        flipped = torch.where(en == mx, 1 - bits, bits)
        bits = torch.where(done[:, None, None], bits, flipped)
    ok = done | torch.all(_syndrome(bits, rows).flatten(1) == 0, dim=-1)
    return bits.reshape(b, -1), ok
