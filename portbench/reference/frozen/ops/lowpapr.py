"""Low-PAPR (Zadoff-Chu / phi-table) sequences, TS 38.211 5.2.2.

Frozen copy of the PyTorch port of python_5gtoolbox_tpu/ops/lowpapr.py (reference:
py5gphy/common/lowPAPR_seq.py:5-42; base sequence r_uv with cyclic shift
alpha, used by the DFT-s-OFDM PUSCH DMRS). Host numpy: the parameters
(u, v, alpha, M_ZC) depend only on the configuration and the slot, so
the sequences are made at plan time and moved to the device once.
"""
from __future__ import annotations

import functools
import math
import pathlib

import numpy as np

_DATA = pathlib.Path(__file__).resolve().parents[1] / "data"


@functools.lru_cache(maxsize=None)
def _phi_tables():
    with np.load(_DATA / "lowpapr_phi.npz") as z:
        return {int(k.split("_")[1]): z[k].copy() for k in z.files}


@functools.lru_cache(maxsize=None)
def largest_prime_below(m: int) -> int:
    n = m - 1
    while n > 1:
        if all(n % d for d in range(2, int(math.isqrt(n)) + 1)):
            return n
        n -= 1
    return 1


def base_sequence(u: int, v: int, mzc: int) -> np.ndarray:
    """r_bar_uv: length-M_ZC base sequence (no cyclic shift)."""
    assert u in range(30)
    assert mzc % 6 == 0
    if mzc in (6, 12, 18, 24):
        phi = _phi_tables()[mzc][u].astype(np.float64)
        return np.exp(1j * phi * np.pi / 4).astype(np.complex64)
    if mzc == 30:
        n = np.arange(1, mzc + 1)
        return np.exp(-1j * np.pi * (u + 1) * n * (n + 1) / 31
                      ).astype(np.complex64)
    nzc = largest_prime_below(mzc)
    q_bar = nzc * (u + 1) / 31
    q = math.floor(q_bar + 0.5) + v * ((-1) ** math.floor(2 * q_bar))
    m = np.arange(nzc)
    xq = np.exp(-1j * np.pi * q * m * (m + 1) / nzc)
    reps = -(-mzc // nzc)
    return np.tile(xq, reps)[:mzc].astype(np.complex64)


def lowpapr_seq(u: int, v: int, alpha: float, mzc: int) -> np.ndarray:
    """r_uv(alpha): cyclic-shifted low-PAPR sequence, complex64."""
    n = np.arange(mzc)
    return (np.exp(1j * alpha * n) * base_sequence(u, v, mzc)
            ).astype(np.complex64)
