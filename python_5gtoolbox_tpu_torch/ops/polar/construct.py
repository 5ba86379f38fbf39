"""Polar code construction, TS 38.212 5.3.1 / 5.4.1.1.

Port of python_5gtoolbox_tpu/ops/polar/construct.py: mother code size N,
frozen mask F and parity-check bit positions qPC (UL K in [18, 25]),
including the row-weight-selected nPCwm bit. Host numpy; every table is a
function of (K, E, nMax) and is cached.
"""
from __future__ import annotations

import functools
import math
import pathlib

import numpy as np

_DATA = pathlib.Path(__file__).resolve().parents[2] / "data"

# Sub-block interleaver pattern, TS 38.212 Table 5.4.1.1-1.
PI_SUBBLOCK = [0, 1, 2, 4, 3, 5, 6, 7, 8, 16, 9, 17, 10, 18, 11, 19,
               12, 20, 13, 21, 14, 22, 15, 23, 24, 25, 26, 28, 27, 29, 30, 31]


@functools.lru_cache(maxsize=None)
def reliability_sequence() -> np.ndarray:
    """Q_0^Nmax-1 universal reliability sequence, Table 5.3.1.2-1."""
    with np.load(_DATA / "polar_reliability.npz") as z:
        return z["sequence"].copy()


def gen_n_value(K: int, E: int, n_max: int) -> tuple[int, int]:
    """(N, n) mother code size selection, 38.212 5.3.1."""
    clog2e = int(math.ceil(math.log2(E)))
    if E <= (9 / 8) * 2 ** (clog2e - 1) and (K / E) < (9 / 16):
        n1 = clog2e - 1
    else:
        n1 = clog2e
    n2 = int(math.ceil(math.log2(K / (1 / 8))))
    n = max(min(n1, n2, n_max), 5)
    return 2 ** n, n


@functools.lru_cache(maxsize=None)
def subblock_jn(N: int) -> np.ndarray:
    """J(n) sub-block interleaver indices: y[n] = u[J(n)]."""
    m = np.arange(N)
    return (np.asarray(PI_SUBBLOCK)[(32 * m) // N] * (N // 32)
            + m % (N // 32)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def construct(K: int, E: int, n_max: int):
    """-> (F frozen mask (N,) int8, qPC positions, N, nPC, nPCwm)."""
    assert n_max in (9, 10)
    N, n = gen_n_value(K, E, n_max)
    if n_max == 9:          # DL (iIL = 1): no PC bits
        nPC = nPCwm = 0
    else:                   # UL (iIL = 0)
        assert K in range(18, 26) or K > 30
        if 18 <= K <= 25:
            nPC = 3
            nPCwm = 1 if (E - K + 3) > 192 else 0
        else:
            nPC = nPCwm = 0
    assert K + nPC <= E

    qn = reliability_sequence()
    qn = qn[qn < N]
    jn = subblock_jn(N)

    # pre-frozen set from rate matching (5.4.1.1)
    qf_pre: set[int] = set()
    if E < N:
        if (K / E) <= 7 / 16:          # puncturing
            qf_pre.update(jn[: N - E].tolist())
            if E >= 3 * N / 4:
                qf_pre.update(range(math.ceil(3 * N / 4 - E / 2)))
            else:
                qf_pre.update(range(math.ceil(9 * N / 16 - E / 4)))
        else:                          # shortening
            qf_pre.update(jn[E:N].tolist())

    qi = []
    for idx in qn[::-1]:               # most reliable first
        if int(idx) in qf_pre:
            continue
        qi.append(int(idx))
        if len(qi) == K + nPC:
            break
    qi = np.asarray(qi, np.int32)

    F = np.ones(N, np.int8)
    F[qi] = 0
    qpc = np.zeros(nPC, np.int32)
    if nPC:
        qpc[: nPC - nPCwm] = qi[-(nPC - nPCwm):]
        if nPCwm:
            # row weights of G_N = F^{kron n} are 2^popcount(i); the PC bit
            # is the most reliable of the minimum-weight candidates
            wg = 2 ** np.array([bin(x).count("1") for x in range(N)])
            qtilde = qi[: qi.size - nPC]
            w = wg[qtilde]
            qpc[nPC - 1] = qtilde[int(np.where(w == np.min(w))[0][0])]
    return F, qpc, N, nPC, nPCwm
