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

On a CUDA tensor the min-sum family launches a hand-written kernel, one
template in csrc/ldpc_common.cuh with two entries:
csrc/ldpc_minsum_packed.cu (ldpc_minsum_packed: several codewords per
block) for liftings below 128 whose state fits, csrc/ldpc_minsum.cu
(ldpc_minsum: one codeword per cluster of blocks) otherwise; plan_launch
chooses each launch, and both give the same bits. On a CPU tensor it runs
_ldpc_decode_plain, which mirrors the JAX _ldpc_decode_jit op for op and
is bit-identical to it and to the TPU kernels. Belief propagation and
bit flipping have no TPU kernel in the JAX package; they are plain
tensor code on either device.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from python_5gtoolbox_tpu_torch import kernels
from python_5gtoolbox_tpu_torch.kernels import H100_SMS, SMEM_OPTIN_BYTES
from python_5gtoolbox_tpu_torch.ops.ldpc.tables import BG_DIMS, shift_table

_INF = 1e30
_ATANH_CLAMP = 19.07   # the reference's atanh saturation
_PACKED_MAX_GROUP = 32
_MAX_CLUSTER = 16          # blocks per cluster, non-portable sizes allowed
# threads per block the kernels are compiled for (csrc/ldpc_common.cuh):
# flooded, layered, warp-per-codeword layered
_MAX_THREADS = {"flooded": 1024, "layered": 512, "warp": 256}
# check-node widths of the kernels (csrc/ldpc_common.cuh:check): 6 and 10
# unrolled, wider rows (BG1's four of degree 19) in a compact loop
DEGREE_CLASSES = (6, 10, 19)


@functools.lru_cache(maxsize=None)
def _graph(bgn: int, zc: int):
    """Static edge list grouped by check row: [[(col, shift), ...], ...]."""
    nrows, ncols = BG_DIMS[bgn]
    st = shift_table(bgn, zc)
    rows = [[(int(c), int(st[r, c])) for c in range(ncols) if st[r, c] >= 0]
            for r in range(nrows)]
    return rows, nrows, ncols


@functools.lru_cache(maxsize=None)
def row_phases(bgn: int, zc: int) -> tuple[int, ...]:
    """Phase boundaries of the layered sweep on the card: consecutive
    check rows that share no column form one phase (phase k is rows
    [ptr[k], ptr[k+1])). No entry is read by one row of a phase and written
    by another, so sweeping a phase's rows at once gives the bits of the
    row-by-row sweep. 32 phases for BG1, 28 for BG2, at every lifting."""
    rows, nrows, _ = _graph(bgn, zc)
    ptr, seen = [0], set()
    for r, edges in enumerate(rows):
        cols = {c for c, _ in edges}
        if cols & seen:
            ptr.append(r)
            seen = set()
        seen |= cols
    return tuple(ptr + [nrows])


def row_degree_classes(bgn: int, zc: int) -> tuple[int, ...]:
    """The check-node width each row runs at in the kernels: the smallest
    of DEGREE_CLASSES (csrc/ldpc_common.cuh:check) that holds its degree."""
    rows, _, _ = _graph(bgn, zc)
    return tuple(min(w for w in DEGREE_CLASSES if w >= len(e)) for e in rows)


@functools.lru_cache(maxsize=None)
def _kernel_tables(bgn: int, zc: int) -> np.ndarray:
    """int32 [row_ptr | row_edge | col_ptr | col_edge | phase_ptr |
    row_order | col_order] for the kernels (csrc/ldpc_common.cuh): row_edge
    = col | shift << 16, columns ascending within a row; col_edge the edge
    ids of each column in ascending row order, the JAX decoder's
    variable-node summation order; phase_ptr from row_phases; the rows and
    the columns by degree, widest first (ties in order)."""
    rows, nrows, ncols = _graph(bgn, zc)
    row_ptr = np.cumsum([0] + [len(r) for r in rows])
    e_col = np.array([c for r in rows for c, _ in r])
    e_shift = np.array([p for r in rows for _, p in r])
    col_edge = np.concatenate([np.nonzero(e_col == c)[0]
                               for c in range(ncols)])
    col_ptr = np.cumsum([0] + [int((e_col == c).sum())
                               for c in range(ncols)])
    return np.concatenate([
        row_ptr, e_col | e_shift << 16, col_ptr, col_edge,
        row_phases(bgn, zc), np.argsort(-np.diff(row_ptr), kind="stable"),
        np.argsort(-np.diff(col_ptr), kind="stable")]).astype(np.int32)


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


# ---------------------------------------------------------------------------
# The two CUDA kernels and their launch planner
# ---------------------------------------------------------------------------

def _lanes(zl: int, group: int) -> tuple[int, int, int]:
    """(S, codewords per sub-task, sub-tasks per row): a sub-task is 32
    lanes, S = pow2ceil(zl) up to 32 lanes per codeword
    (csrc/ldpc_common.cuh:launch)."""
    seg = min(32, 1 << max(0, (zl - 1).bit_length()))
    cpw = 32 // seg
    return seg, cpw, -(-group // cpw) * -(-zl // seg)


@functools.lru_cache(maxsize=None)
def smem_bytes(bgn: int, zc: int, group: int, zl: int,
               lr_on_chip: bool = True) -> int:
    """Shared memory per block of the decoder kernels for G = group
    codewords and slices of zl lifting indices: the table blob, four flags
    per codeword and the sub-task table, then LQ and (lr_on_chip) LR in
    float32 (csrc/ldpc_common.cuh:smem_bytes)."""
    rows, nrows, ncols = _graph(bgn, zc)
    n_edges = sum(len(e) for e in rows)
    ntab = (nrows + 1 + 2 * n_edges + ncols + 1
            + len(row_phases(bgn, zc)) + nrows + ncols)
    head = (ntab + 4 * group + _lanes(zl, group)[2] + 3) & ~3
    return 4 * (head + group * (ncols + (n_edges if lr_on_chip else 0)) * zl)


def cluster_slices(zc: int) -> dict[int, int]:
    """Blocks per codeword K -> lifting indices per block zl: K = 1 holds
    the whole lifting; K > 1 cuts it into power-of-two slices of at least
    8 (the kernel finds an entry's block by a shift), K <= 16."""
    out, zl = {1: zc}, 8
    while zl < zc:
        k = -(-zc // zl)
        if k <= _MAX_CLUSTER:
            out[k] = zl
        zl *= 2
    return dict(sorted(out.items()))


@functools.lru_cache(maxsize=None)
def packed_group_limit(zc: int, bgn: int) -> int:
    """How many codewords' whole decode state (LQ and LR, float32) one
    block's shared memory holds beside the tables and flags; 0 where not
    even one fits."""
    g = 0
    while g < _PACKED_MAX_GROUP and \
            smem_bytes(bgn, zc, g + 1, zc) <= SMEM_OPTIN_BYTES:
        g += 1
    return g


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One launch of a decoder kernel: `cluster` blocks of `threads`
    threads per cluster, `group` codewords per cluster, `zl` lifting
    indices per block, `smem` bytes of shared memory per block; `warp`:
    the warp-per-codeword layered kernel; `lr_on_chip`: LR in shared
    memory (else in a device-memory scratch); `barriers`: block or cluster
    barriers per iteration (3 flooded; 2 + row phases layered; 0 warp)."""
    cluster: int
    group: int
    zl: int
    threads: int
    warp: bool
    blocks: int
    smem: int
    barriers: int
    lr_on_chip: bool = True


@functools.lru_cache(maxsize=1024)
def plan_launch(bgn: int, zc: int, batch: int, schedule: str = "flooded",
                layout: str = "batch", n_sm: int = H100_SMS,
                group: int | None = None, cluster: int | None = None,
                threads: int | None = None,
                lr_on_chip: bool | None = None) -> LaunchPlan:
    """The launch of ldpc_minsum (layout "batch": one codeword per
    cluster) or ldpc_minsum_packed ("packed"). Defaults, from
    sim/tune_ldpc_packed.py on the H100:
      * group (packed only): as many codewords per block as spread the
        batch over at most n_sm blocks, at most packed_group_limit; for the
        warp-per-codeword layered kernel (Zc <= 32) the codewords one warp
        holds side by side (32 / pow2ceil(Zc));
      * cluster: the smallest K whose slice fits; flooded, raised while
        the blocks still fit one per SM (a second wave of 1024-thread
        blocks costs more than the wider cluster saves); layered stays at
        the smallest K, whose cluster barriers (one per row phase) are the
        cheapest;
      * LR stays in shared memory, except in the layered schedule where
        one block does not hold a codeword and its clusters would not fit
        in one wave (the decoder bench's BG1 / Zc 384 / B 512): there a
        row phase costs the latency of a check node and a barrier whatever
        its width, so a block holds LQ only (the whole lifting, two blocks
        per SM) and LR goes to a device-memory scratch;
      * threads: one warp per (row or column, sub-task), at most 1024
        flooded and 512 layered (the kernels' launch bounds); one warp per
        block's codeword group for the warp kernel (at most 256).
    group, cluster and threads override the defaults; lr_on_chip=False
    forces LR into device memory (ldpc_minsum only, one block per
    cluster). ValueError where they do not fit. A plan with forced values
    goes to the wrappers' `plan` argument (checked_plan)."""
    rows, nrows, ncols = _graph(bgn, zc)
    packed = layout == "packed"
    slices = cluster_slices(zc)
    warp = packed and schedule == "layered" and zc <= 32
    if packed:
        g_max = packed_group_limit(zc, bgn)
        if g_max < 1:
            raise ValueError(f"ldpc_minsum_packed: the decode state of "
                             f"BG{bgn} / Zc {zc} does not fit in shared "
                             f"memory")
        if group is None:
            group = min(g_max, _lanes(zc, 1)[1] if warp
                        else max(1, -(-batch // n_sm)))
        if not 1 <= group <= g_max:
            raise ValueError(f"group must be in 1..{g_max}")
    elif group not in (None, 1):
        raise ValueError("ldpc_minsum decodes one codeword per cluster")
    else:
        group = 1
    fit = [k for k, zl in slices.items()
           if smem_bytes(bgn, zc, group, zl) <= SMEM_OPTIN_BYTES]
    if warp:
        fit = [k for k in fit if k == 1]
    n_clusters = -(-batch // group)
    if lr_on_chip is None:
        lr_on_chip = not (schedule == "layered" and cluster in (None, 1)
                          and 1 not in fit
                          and n_clusters * min(fit, default=n_sm) > n_sm)
    max_threads = _MAX_THREADS["warp" if warp else schedule]
    if not lr_on_chip:
        if packed:
            raise ValueError("ldpc_minsum_packed keeps LR in shared memory")
        if (cluster not in (None, 1) or smem_bytes(
                bgn, zc, group, zc, False) > SMEM_OPTIN_BYTES):
            raise ValueError("LR in device memory takes one block per "
                             "cluster whose LQ fits in shared memory")
        threads = threads or min(512, 32 * ncols * group)
        if threads % 32 or not 32 <= threads <= max_threads:
            raise ValueError(f"threads must be a multiple of 32 in "
                             f"32..{max_threads}")
        return LaunchPlan(1, group, zc, threads, False,
                          n_clusters, smem_bytes(bgn, zc, group, zc, False),
                          3 if schedule == "flooded"
                          else 2 + len(row_phases(bgn, zc)) - 1, False)
    if cluster is None:
        if not fit:
            raise ValueError(f"BG{bgn} / Zc {zc}: no cluster of at most "
                             f"{_MAX_CLUSTER} blocks holds the state")
        cluster = fit[0]
        if schedule == "flooded":
            cluster = max([k for k in fit if n_clusters * k <= n_sm],
                          default=cluster)
    if cluster not in fit:
        raise ValueError(f"cluster {cluster} does not fit BG{bgn} / Zc "
                         f"{zc} with group {group}: one of {fit}")
    zl = slices[cluster]
    _, cpw, nsub = _lanes(zl, group)
    if threads is None:
        threads = min(max_threads, 32 * (-(-group // cpw) if warp
                                         else ncols * nsub))
    if threads % 32 or not 32 <= threads <= max_threads:
        raise ValueError(f"threads must be a multiple of 32 in "
                         f"32..{max_threads}")
    barriers = (0 if warp else 3 if schedule == "flooded"
                else 2 + len(row_phases(bgn, zc)) - 1)
    return LaunchPlan(cluster, group, zl, threads, warp,
                      n_clusters * cluster,
                      smem_bytes(bgn, zc, group, zl), barriers)


@functools.lru_cache(maxsize=16)
def _device_tables(bgn: int, zc: int, device: torch.device):
    return torch.as_tensor(_kernel_tables(bgn, zc), device=device)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def checked_plan(plan: LaunchPlan | None, bgn: int, zc: int, batch: int,
                 schedule: str, layout: str, n_sm: int) -> LaunchPlan:
    """plan_launch's choice where plan is None; else plan itself, once
    plan_launch, forced to its cluster, group, threads and LR placement,
    gives it back for this decode (ValueError where it does not: a plan
    made for another code, batch or schedule)."""
    if plan is None:
        return plan_launch(bgn, zc, batch, schedule, layout, n_sm)
    if plan != plan_launch(bgn, zc, batch, schedule, layout, n_sm,
                           plan.group, plan.cluster, plan.threads,
                           plan.lr_on_chip):
        raise ValueError(f"{plan} was not made for BG{bgn} / Zc {zc} / "
                         f"B {batch}, {schedule}, layout {layout!r}")
    return plan


def _decode_on_card(name, llr_in, zc, bgn, n_iter, alpha, beta, iters_out,
                    schedule, semantics, layout, plan):
    """Checks the inputs, plans and launches one of the two kernels ->
    (bits (B, K) int8, ok (B,) bool, full_bits (B, ncols*Zc) int8)."""
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
    plan = checked_plan(plan, bgn, zc, b, schedule, layout, _sm_count(dev))
    llr_in = llr_in.contiguous()
    full = torch.empty((b, ncols * zc), dtype=torch.int8, device=dev)
    ok = torch.empty(b, dtype=torch.bool, device=dev)
    n_edges = sum(len(e) for e in rows)
    lr = (None if plan.lr_on_chip else
          torch.empty((b, n_edges * zc), dtype=torch.float32, device=dev))
    args = [llr_in.data_ptr(), _device_tables(bgn, zc, dev).data_ptr(), b,
            nrows, ncols, sum(len(e) for e in rows),
            len(row_phases(bgn, zc)) - 1, zc, n_iter, float(alpha),
            float(beta), int(schedule == "layered"),
            int(semantics == "fast")]
    lr_ptr = None if lr is None else lr.data_ptr()
    if layout == "packed":
        args += [plan.group, plan.cluster, plan.zl, plan.threads, lr_ptr,
                 int(plan.warp)]
    else:
        args += [plan.cluster, plan.zl, plan.threads, lr_ptr]
    rc = getattr(kernels.library(name), name)(
        *args, full.data_ptr(), ok.data_ptr(),
        None if iters_out is None else iters_out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(name, rc)
    k = (22 if bgn == 1 else 10) * zc
    return full[:, :k], ok, full


def ldpc_minsum(llr_in: torch.Tensor, zc: int, bgn: int, n_iter: int,
                alpha: float = 1.0, beta: float = 0.0,
                iters_out: torch.Tensor | None = None,
                schedule: str = "flooded", semantics: str = "exact",
                plan: LaunchPlan | None = None):
    """Decode (B, N) punctured-codeword LLRs on the card with the
    hand-written kernel csrc/ldpc_minsum.cu, one codeword per cluster of
    blocks (plan_launch); replaces
    python_5gtoolbox_tpu/ops/ldpc/pallas_decode.py:_make_kernel (both
    schedules, both check nodes). Returns (bits (B, K) int8, ok (B,) bool,
    full_bits (B, ncols*Zc) int8). iters_out, a (B,) int32 CUDA tensor,
    receives the number of updates each codeword ran (it stops once its
    syndrome is zero). plan, a plan_launch result for this decode with
    its cluster, threads or LR placement forced, replaces the planner's
    choice (ValueError where it does not fit; a launch the card refuses
    raises RuntimeError). The launch is counted in
    kernels.LAUNCHES["ldpc_minsum_<schedule>[_fast]"]."""
    out = _decode_on_card("ldpc_minsum", llr_in, zc, bgn, n_iter, alpha,
                          beta, iters_out, schedule, semantics, "batch",
                          plan)
    kernels.LAUNCHES[f"ldpc_minsum_{schedule}"
                     + ("_fast" if semantics == "fast" else "")] += 1
    return out


def ldpc_minsum_flooded(llr_in: torch.Tensor, zc: int, bgn: int,
                        n_iter: int, alpha: float = 1.0, beta: float = 0.0,
                        iters_out: torch.Tensor | None = None):
    """ldpc_minsum with the flooded schedule and the exact check node."""
    return ldpc_minsum(llr_in, zc, bgn, n_iter, alpha, beta, iters_out)


def ldpc_minsum_packed(llr_in: torch.Tensor, zc: int, bgn: int, n_iter: int,
                       alpha: float = 1.0, beta: float = 0.0,
                       iters_out: torch.Tensor | None = None,
                       schedule: str = "flooded", semantics: str = "exact",
                       plan: LaunchPlan | None = None):
    """The small-lifting decoder csrc/ldpc_minsum_packed.cu; replaces
    python_5gtoolbox_tpu/ops/ldpc/pallas_decode.py:_make_kernel_packed.
    Same contract and same bits as ldpc_minsum. A cluster (one block by
    default) decodes `group` codewords whose LQ and LR all stay in shared
    memory; plan_launch gives the launch, and plan (a plan_launch result
    for this decode, layout "packed", with its group, cluster or threads
    forced) replaces it. Raises ValueError where the state of one codeword
    does not fit one block."""
    out = _decode_on_card("ldpc_minsum_packed", llr_in, zc, bgn, n_iter,
                          alpha, beta, iters_out, schedule, semantics,
                          "packed", plan)
    kernels.LAUNCHES["ldpc_minsum_packed"] += 1
    return out


def ldpc_decode(llr_in: torch.Tensor, zc: int, bgn: int, n_iter: int,
                algo: str = "min-sum", alpha: float = 1.0, beta: float = 0.0,
                schedule: str = "flooded", semantics: str = "exact",
                layout: str = "auto", iters_out: torch.Tensor | None = None):
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
    version. iters_out, a (B,) int32 tensor on the card, is handed to the
    kernel, which writes the number of updates each codeword ran
    (ldpc_minsum); the plain version counts none and refuses it
    (ValueError).
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
        if iters_out is not None:
            raise ValueError("iters_out needs the card's min-sum kernels; "
                             "the plain decoder counts no iterations")
        return _ldpc_decode_plain(llr_in, zc, bgn, n_iter, alpha, beta,
                                  schedule, semantics, algo)
    if layout == "auto":
        layout = ("packed" if zc < 128 and packed_group_limit(zc, bgn) >= 1
                  else "batch")
    fn = ldpc_minsum_packed if layout == "packed" else ldpc_minsum
    return fn(llr_in, zc, bgn, n_iter, alpha, beta, iters_out,
              schedule=schedule, semantics=semantics)


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
