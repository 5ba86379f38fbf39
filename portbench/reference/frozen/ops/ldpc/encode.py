"""LDPC encoder, TS 38.212 5.3.2 — shift-table formulation, batched.

Frozen copy of the PyTorch port of python_5gtoolbox_tpu/ops/ldpc/encode.py: a base-graph block with
shift P acts on a Zc-vector v as roll(v, -P), so the encoder works on a
(codewords, block_cols, Zc) tensor with cyclic shifts only, never a dense
lifted H. Summing the four core check rows leaves one shift s on p1, so
p1 = roll(L2, s); p2..p4 follow from a plan-time triangular solve of the
core rows, and the extension parities from rows 4.. directly.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from portbench.reference.frozen.ops.ldpc.tables import (
    BG_DIMS, BG_INFO_COLS, shift_table)


@functools.lru_cache(maxsize=None)
def _encode_plan(bgn: int, zc: int):
    """Static encoding recipe for (bgn, Zc): kb, p1_shift, core_solve
    [(target col, row, [(col, shift), ...])] and rows[r] = [(col, shift)]
    over the systematic + core-parity columns."""
    nrows, _ = BG_DIMS[bgn]
    kb = BG_INFO_COLS[bgn]
    st = shift_table(bgn, zc)

    surviving: dict[int, int] = {}
    for r in range(4):
        if st[r, kb] >= 0:
            s = int(st[r, kb])
            surviving[s] = surviving.get(s, 0) ^ 1
    live = [s for s, c in surviving.items() if c]
    if len(live) != 1:
        raise ValueError(f"unexpected p1 core structure for BG{bgn}/Zc{zc}")
    p1_shift = live[0]

    known = {kb}
    order = []
    rows_used = set()
    while len(known) < 4:
        progressed = False
        for r in range(4):
            if r in rows_used:
                continue
            pcols = [c for c in range(kb, kb + 4) if st[r, c] >= 0]
            unknown = [c for c in pcols if c not in known]
            if len(unknown) == 1:
                tgt = unknown[0]
                terms = [(c, int(st[r, c])) for c in range(kb + 4)
                         if st[r, c] >= 0 and c != tgt]
                order.append((tgt, r, terms))
                known.add(tgt)
                rows_used.add(r)
                progressed = True
        if not progressed:
            raise ValueError("LDPC core solve did not progress")

    rows = [[(c, int(st[r, c])) for c in range(kb + 4) if st[r, c] >= 0]
            for r in range(nrows)]
    return dict(kb=kb, p1_shift=p1_shift, core_solve=order, rows=rows,
                nrows=nrows)


def _roll(x, shift):
    """roll(v, -P) == action of a base-graph block with shift P."""
    if shift % x.shape[-1] == 0:
        return x
    return torch.roll(x, -shift, dims=-1)


def ldpc_encode(ck: torch.Tensor, bgn: int) -> torch.Tensor:
    """Encode (C, K) systematic bits -> (C, N) rate-2Zc-punctured codeword.

    ck: int8 0/1 with filler bits set to 0. Returns dn (C, N):
    [c_(2Zc..K) | parity (4Zc core + extension)], fillers still zero.
    """
    C, K = ck.shape
    kb_sys = 22 if bgn == 1 else 10
    zc = K // kb_sys
    plan = _encode_plan(bgn, zc)
    u = ck.to(torch.int8).reshape(C, kb_sys, zc)
    blocks = {c: u[:, c, :] for c in range(kb_sys)}

    def row_sum(terms):
        acc = None
        for col, shift in terms:
            v = _roll(blocks[col], shift)
            acc = v if acc is None else acc ^ v
        return acc

    l1 = [row_sum([(c, s) for (c, s) in plan["rows"][r] if c < kb_sys])
          for r in range(4)]
    l2 = l1[0] ^ l1[1] ^ l1[2] ^ l1[3]
    kb = plan["kb"]
    blocks[kb] = torch.roll(l2, plan["p1_shift"], dims=-1)
    for tgt, _, terms in plan["core_solve"]:
        blocks[tgt] = row_sum(terms)
    core_parity = torch.stack([blocks[kb + i] for i in range(4)], dim=1)
    ext_parity = torch.stack([row_sum(plan["rows"][r])
                              for r in range(4, plan["nrows"])], dim=1)
    return torch.cat([u[:, 2:, :].reshape(C, -1),
                      core_parity.reshape(C, -1),
                      ext_parity.reshape(C, -1)], dim=-1)


def ldpc_encode_np(ck_row: np.ndarray, bgn: int) -> np.ndarray:
    """Reference-compatible single-codeword wrapper: (K,) with -1 filler
    sentinels -> dn (N,) with -1 at the filler positions."""
    ck = np.asarray(ck_row)
    zc = ck.size // (22 if bgn == 1 else 10)
    filler = ck == -1
    clean = np.where(filler, 0, ck).astype(np.int8)
    out = ldpc_encode(torch.as_tensor(clean[None]), bgn)[0].numpy().copy()
    out[: ck.size - 2 * zc][filler[2 * zc:]] = -1
    return out
