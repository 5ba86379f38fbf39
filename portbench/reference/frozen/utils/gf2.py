"""Plan-time GF(2) linear algebra helpers (NumPy, host side).

These power the O(log N) jump-ahead constructions for CRC remainder
matrices and Gold-sequence state advance used throughout the framework.
Everything here runs at plan (config-trace) time; the device side only
sees the resulting small dense tables.
"""
from __future__ import annotations

import numpy as np


def gf2_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Matrix product over GF(2). Inputs are 0/1 uint8/int arrays."""
    return (a.astype(np.int64) @ b.astype(np.int64)) % 2


def gf2_matpow(m: np.ndarray, e: int) -> np.ndarray:
    """m**e over GF(2) by square-and-multiply."""
    n = m.shape[0]
    result = np.eye(n, dtype=np.uint8)
    base = m.astype(np.uint8)
    while e > 0:
        if e & 1:
            result = gf2_matmul(result, base).astype(np.uint8)
        base = gf2_matmul(base, base).astype(np.uint8)
        e >>= 1
    return result

