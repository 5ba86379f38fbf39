"""LDPC base-graph tables and code-block parameters, TS 38.212 5.2.2/5.3.2.

Behavior parity target: py5gphy/ldpc/ldpc_info.py (get_cbs_info, find_iLS,
getH). Unlike the reference, the dense lifted H matrix is NEVER
materialized: everything downstream (encoder, decoder, rate matching)
works from the (rows x cols) base-graph shift table, which is the natural
representation for cyclic-shift (torch.roll / CUDA kernel) arithmetic.
"""
from __future__ import annotations

import dataclasses
import functools
import pathlib

import numpy as np

_DATA = pathlib.Path(__file__).resolve().parents[2] / "data"

# TS 38.212 Table 5.3.2-1 lifting sizes by set index iLS.
ZSETS = [
    [2, 4, 8, 16, 32, 64, 128, 256],
    [3, 6, 12, 24, 48, 96, 192, 384],
    [5, 10, 20, 40, 80, 160, 320],
    [7, 14, 28, 56, 112, 224],
    [9, 18, 36, 72, 144, 288],
    [11, 22, 44, 88, 176, 352],
    [13, 26, 52, 104, 208],
    [15, 30, 60, 120, 240],
]
ZLIST = sorted(z for s in ZSETS for z in s)

BG_DIMS = {1: (46, 68), 2: (42, 52)}  # (check rows, total cols) in blocks
BG_INFO_COLS = {1: 22, 2: 10}         # systematic block-columns (Kb max)


def find_ils(zc: int) -> int:
    for i, s in enumerate(ZSETS):
        if zc in s:
            return i
    raise ValueError(f"invalid lifting size {zc}")


@functools.lru_cache(maxsize=None)
def base_graph(bgn: int, ils: int) -> np.ndarray:
    """Raw V(i,j) table (-1 = no edge), TS 38.212 Tables 5.3.2-2/3."""
    with np.load(_DATA / "ldpc_basegraphs.npz") as z:
        return z[f"BG{bgn}S{ils}"].copy()


@functools.lru_cache(maxsize=None)
def shift_table(bgn: int, zc: int) -> np.ndarray:
    """Per-edge cyclic shifts P(i,j) = V(i,j) mod Zc (-1 = no edge)."""
    bg = base_graph(bgn, find_ils(zc))
    shifts = bg % zc
    shifts[bg < 0] = -1
    return shifts


@dataclasses.dataclass(frozen=True)
class CBInfo:
    """Code-block segmentation parameters (38.212 5.2.2)."""
    C: int      # number of code blocks
    cbz: int    # payload bits per code block (excl. CB-CRC, filler)
    L: int      # CB-CRC length (0 or 24)
    F: int      # filler bits per code block
    K: int      # LDPC input size (incl. CB-CRC + filler) = Kb_sys * Zc
    Zc: int     # lifting size
    bgn: int

    @property
    def N(self) -> int:
        return (66 if self.bgn == 1 else 50) * self.Zc

    @property
    def Kd(self) -> int:
        return self.K - self.F


def get_cbs_info(B: int, bgn: int) -> CBInfo:
    kcb = 8448 if bgn == 1 else 3840
    if B <= kcb:
        L, C = 0, 1
        Bd = B
    else:
        L = 24
        C = int(np.ceil(B / (kcb - L)))
        Bd = B + C * L
    assert B % C == 0, "B not divisible by C (matches reference assumption)"
    cbz = B // C
    Kd = Bd // C
    if bgn == 1:
        kb = 22
    else:
        kb = 10 if B > 640 else 9 if B > 560 else 8 if B > 192 else 6
    zc = next(z for z in ZLIST if z * kb >= Kd)
    K = (22 if bgn == 1 else 10) * zc
    return CBInfo(C=C, cbz=cbz, L=L, F=K - Kd, K=K, Zc=zc, bgn=bgn)
