"""Batched CA-PC-SCL polar decoder (LLR-based min-sum f/g).

Port of python_5gtoolbox_tpu/ops/polar/decode.py, bit for bit with its
unrolled decoder (_scl_jit) and so with its scan and chunked ones:
bit-reversed LLR layout, min-sum f, LLR-domain g, the hard path metric of
"LLR-Based Successive Cancellation List Decoding of Polar Codes" (eq.
12), frozen, parity-check and (iIL = 1, CA-SCL) distributed-CRC bits as
forced bits that never fork the list, and the final CRC-ranked choice of
a path.

Design. One Python step per leaf (the SC schedule is static, so every
f/g update is a static slice). The per-path state is one float32 tensor
(B, L, 3N): the f/g values of tree levels 0..n-1 (level l at columns
[2^l, 2^(l+1))), the partial sums of the same levels as signs +-1 (at
N + 2^l) and the decided bits u as signs (at 2N). Signs make g one fused
multiply-add, a XOR a product and the path permutation of a data leaf a
single gather. The channel level is (B, N) and shared by all paths. The
schedule is some 20-40 small operations per leaf; on the card the leaf
loop is captured once per shape as a CUDA graph and replayed, so the host
launches it as one.

Ties. The list keeps the L best of 2L candidates in the order of XLA's
top_k, which returns equal metrics lowest index first: a stable ascending
sort. Ties are the rule, not the exception: a dead path's metric is 1e30,
and 1e30 + penalty rounds back to 1e30 in float32.
"""
from __future__ import annotations

import collections
import functools

import numpy as np
import torch

from python_5gtoolbox_tpu_torch.ops import crc as crc_ops
from python_5gtoolbox_tpu_torch.ops.polar.construct import construct
from python_5gtoolbox_tpu_torch.ops.polar.interleave import \
    input_deinterleave_table
from python_5gtoolbox_tpu_torch.utils import profiling

_BIG = 1e30
_POLY = {6: "6", 11: "11", 24: "24C"}


@functools.lru_cache(maxsize=None)
def _decode_plan(K: int, E: int, n_max: int, i_il: int, crc_len: int,
                 force_crc: bool):
    """Static leaf schedule -> (N, leaves, ckbar_pos, deintl or None).

    leaves[p] is ("frozen",), ("data",), ("pc", src u positions) or
    ("crc", src u positions, CRC column j): a forced bit is the XOR of
    the decided bits at src, and of the RNTI mask bit j for a CRC bit."""
    F, qpc, N, _, _ = construct(K, E, n_max)
    qpc_set = {int(x) for x in qpc}
    ckbar_pos = [i for i in range(N) if F[i] == 0 and i not in qpc_set]
    assert len(ckbar_pos) == K

    crc_forced = {}
    deintl = None
    if i_il:
        deintl = input_deinterleave_table(K)
        if force_crc:
            A = K - crc_len
            R = crc_ops._remainder_matrix(A, "24C")         # (A, 24)
            for j in range(crc_len):
                p = ckbar_pos[int(deintl[A + j])]
                src = [ckbar_pos[int(deintl[i])]
                       for i in np.nonzero(R[:, j])[0]]
                assert all(s < p for s in src), "distributed CRC violated"
                crc_forced[p] = (src, j)

    leaves = []
    for p in range(N):
        if F[p] == 1:
            leaves.append(("frozen",))
        elif p in qpc_set:
            leaves.append(("pc", [q for q in ckbar_pos
                                  if q < p and q % 5 == p % 5]))
        elif p in crc_forced:
            leaves.append(("crc",) + crc_forced[p])
        else:
            leaves.append(("data",))
    return N, tuple(leaves), np.asarray(ckbar_pos, np.int64), deintl


@functools.lru_cache(maxsize=None)
def _bitrev_perm(N: int) -> np.ndarray:
    n = N.bit_length() - 1
    return np.asarray([int(format(i, f"0{n}b")[::-1], 2) for i in range(N)],
                      np.int64)


def _crc_mask_bits(K: int, crc_len: int, pad_crc: int, rnti, dev
                   ) -> torch.Tensor:
    """The reference's gen_crc_mask: CRC24C of [1]*24 + zeros(A) with the
    RNTI mask -> (24,) or (B, 24) int8 (zeros without pad_crc)."""
    if not pad_crc:
        return torch.zeros(crc_len, dtype=torch.int8, device=dev)
    bits = torch.cat([torch.ones(24, dtype=torch.int8, device=dev),
                      torch.zeros(K - crc_len, dtype=torch.int8,
                                  device=dev)])
    if not isinstance(rnti, (int, np.integer)):
        bits = bits.expand(rnti.shape + bits.shape)
    return crc_ops.crc_compute(bits, "24C", rnti)


def _f(a0: torch.Tensor, a1: torch.Tensor) -> torch.Tensor:
    """min-sum f = sign(a0) sign(a1) min(|a0|, |a1|). The sign of a
    product is exact even where the product underflows or overflows, and
    a zero operand makes the minimum zero."""
    return torch.copysign(torch.minimum(a0.abs(), a1.abs()), a0 * a1)


def _leaf_loop(chan: torch.Tensor, mask_sign: torch.Tensor, leaves,
               srcs: dict, L: int):
    """The SC list schedule, one step per leaf: chan (B, 1, N) bit-reversed
    LLRs, mask_sign (1 or B, 24 or crc_len) the RNTI mask bits as signs,
    srcs the forced bits' source positions as index tensors on chan's
    device -> (u (B, L, N) decided bits as signs, pm (B, L)). No host
    transfer and no synchronisation, so the loop can be captured."""
    B, _, N = chan.shape
    n = N.bit_length() - 1
    dev = chan.device
    S = torch.ones((B, L, 3 * N), dtype=torch.float32, device=dev)
    alpha, beta, u = S[:, :, :N], S[:, :, N:2 * N], S[:, :, 2 * N:]
    pm = torch.full((B, L), _BIG, dtype=torch.float32, device=dev)
    pm[:, 0] = 0.0
    bidx = torch.arange(B, device=dev)[:, None]

    def level(buf, lv):
        return buf[:, :, 1 << lv: 2 << lv]

    for phi in range(N):
        # --- f/g propagation down to the leaf
        if phi == 0:
            a, top = chan, n - 1
        else:
            t = (phi & -phi).bit_length() - 1
            a = chan if t + 1 == n else level(alpha, t + 1)
            g = torch.addcmul(a[..., 1::2], level(beta, t), a[..., 0::2])
            level(alpha, t).copy_(g)
            a, top = g, t - 1
        for lv in range(top, -1, -1):
            fv = _f(a[..., 0::2], a[..., 1::2])
            level(alpha, lv).copy_(fv)
            a = fv
        leaf = a[..., 0].expand(B, L)                      # (B, L)

        kind = leaves[phi]
        if kind[0] == "data":
            if L > 1:
                # choose 0: penalty where the LLR says 1, and vice versa
                cand = torch.cat([pm + torch.relu(-leaf),
                                  pm + torch.relu(leaf)], 1)
                pm, sel = torch.sort(cand, dim=1, stable=True)
                pm, sel = pm[:, :L], sel[:, :L]
                S = S[bidx, sel % L]
                alpha, beta, u = (S[:, :, :N], S[:, :, N:2 * N],
                                  S[:, :, 2 * N:])
                sign = 1.0 - 2.0 * (sel >= L).to(torch.float32)
            else:
                sign = 1.0 - 2.0 * (leaf < 0).to(torch.float32)
        else:
            sign = u[:, :, srcs[phi]].prod(-1) if phi in srcs \
                else torch.ones_like(leaf)
            if kind[0] == "crc":
                sign = sign * mask_sign[:, kind[2]: kind[2] + 1]
            # penalty where the LLR disagrees with the forced bit
            pm = pm + torch.relu(-(sign * leaf))

        u[:, :, phi] = sign
        # --- partial sums up
        cur = sign[..., None]
        lv, ph = 0, phi
        while lv < n:
            if not ph & 1:
                level(beta, lv).copy_(cur)
                break
            cur = torch.stack([level(beta, lv) * cur, cur],
                              dim=-1).reshape(B, L, 2 << lv)
            lv += 1
            ph >>= 1
    return u, pm


# captured leaf loops on the card: key -> (graph, static chan, static
# mask, u, pm, the source index tensors the graph reads); the oldest is
# dropped beyond _GRAPHS_KEPT
_GRAPHS: collections.OrderedDict = collections.OrderedDict()
_GRAPHS_KEPT = 16


def _leaf_loop_cuda(key, chan, mask_sign, leaves, srcs, L):
    """_leaf_loop on the card as one CUDA graph per (plan, B, L, device):
    captured on the first call (after one warm-up run on a side stream),
    replayed after copying the inputs into its static buffers. Every
    tensor the graph reads stays referenced by its cache entry. The
    outputs are the graph's buffers: read them before the next call. Each
    call adds to the open profiler's counter polar_graph_captures (1 for
    a capture, 0 for a replay; utils.profiling.count, nothing without a
    profiler)."""
    key = key + (tuple(chan.shape), tuple(mask_sign.shape), L,
                 chan.device.index)
    captured = key not in _GRAPHS
    if captured:
        st_chan, st_mask = chan.clone(), mask_sign.clone()
        side = torch.cuda.Stream(device=chan.device)
        side.wait_stream(torch.cuda.current_stream(chan.device))
        with torch.cuda.stream(side):
            _leaf_loop(st_chan, st_mask, leaves, srcs, L)
        torch.cuda.current_stream(chan.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            u, pm = _leaf_loop(st_chan, st_mask, leaves, srcs, L)
        _GRAPHS[key] = (graph, st_chan, st_mask, u, pm, srcs)
        while len(_GRAPHS) > _GRAPHS_KEPT:
            _GRAPHS.popitem(last=False)
    profiling.count("polar_graph_captures", int(captured))
    graph, st_chan, st_mask, u, pm, _ = _GRAPHS[key]
    _GRAPHS.move_to_end(key)
    st_chan.copy_(chan)
    st_mask.copy_(mask_sign)
    graph.replay()
    return u, pm


def polar_decode_scl(llr: torch.Tensor, E: int, K: int, list_size: int,
                     n_max: int, i_il: int, crc_len: int = 24,
                     pad_crc: int = 0, rnti=0, force_crc: bool | None = None):
    """Decode (B, N) LLRs -> (ck (B, K) int8, ok (B,) bool).

    LLR convention: positive -> bit 0. rnti: an int, or an int tensor
    (B,) of one RNTI per row (PDCCH blind decoding). force_crc defaults to
    True for iIL = 1 with list_size > 1 (CA-SCL with the distributed CRC
    forced) and False otherwise (plain SC, or the CRC checked at the end
    only). Runs where llr lies: on the card the leaf loop is a CUDA graph
    (the same operations, launched as one), on the CPU it runs eagerly."""
    if force_crc is None:
        force_crc = bool(i_il) and list_size > 1
    plan_key = (K, E, n_max, int(i_il), crc_len, bool(force_crc))
    N, leaves, ckbar_pos, deintl = _decode_plan(*plan_key)
    assert llr.shape[-1] == N, (llr.shape, N)
    dev = llr.device
    B, L = llr.shape[0], list_size
    if not isinstance(rnti, (int, np.integer)):
        rnti = torch.as_tensor(rnti, device=dev).to(torch.int64).reshape(B)
    mask_bits = _crc_mask_bits(K, crc_len, pad_crc, rnti, dev)
    # the mask bits of the forced CRC bits as signs, (1 or B, 24 or crc_len)
    mask_sign = (1.0 - 2.0 * mask_bits.to(torch.float32)).reshape(
        -1, mask_bits.shape[-1])
    srcs = {phi: torch.as_tensor(kind[1], dtype=torch.int64, device=dev)
            for phi, kind in enumerate(leaves)
            if kind[0] in ("pc", "crc") and len(kind[1])}
    chan = llr.to(torch.float32)[:, torch.as_tensor(_bitrev_perm(N),
                                                    device=dev)][:, None]
    if dev.type == "cuda":
        u, pm = _leaf_loop_cuda(plan_key, chan, mask_sign, leaves, srcs, L)
    else:
        u, pm = _leaf_loop(chan, mask_sign, leaves, srcs, L)

    # --- CRC-check every path (with the RNTI mask), rank by metric
    ckbar = (u[:, :, torch.as_tensor(ckbar_pos, device=dev)] < 0
             ).to(torch.int8)
    ck = ckbar[..., torch.as_tensor(deintl, dtype=torch.int64, device=dev)] \
        if i_il else ckbar
    msg = torch.cat([torch.ones((B, L, 24), dtype=torch.int8, device=dev),
                     ck], -1) if pad_crc else ck
    mask = rnti if isinstance(rnti, (int, np.integer)) \
        else rnti[:, None].expand(B, L)
    err = crc_ops.crc_check(msg, _POLY[crc_len], mask)
    best = torch.argmin(pm + err.to(torch.float32) * _BIG, dim=1)
    rows = torch.arange(B, device=dev)
    return ck[rows, best], err[rows, best] == 0
