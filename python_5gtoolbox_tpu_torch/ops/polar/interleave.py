"""Polar input (K-) interleaver, TS 38.212 5.3.1.1 Table 5.3.1.1-1.

Port of python_5gtoolbox_tpu/ops/polar/interleave.py: host index tables,
applied as gathers.
"""
from __future__ import annotations

import functools

import numpy as np

# TS 38.212 Table 5.3.1.1-1 interleaving pattern for K_IL_max = 164.
PI_IL_MAX = [
    0, 2, 4, 7, 9, 14, 19, 20, 24, 25, 26, 28, 31, 34,
    42, 45, 49, 50, 51, 53, 54, 56, 58, 59, 61, 62, 65, 66, 67, 69,
    70, 71, 72, 76, 77, 81, 82, 83, 87, 88, 89, 91, 93, 95, 98, 101,
    104, 106, 108, 110, 111, 113, 115, 118, 119, 120, 122, 123, 126,
    127, 129, 132, 134, 138, 139, 140, 1, 3, 5, 8, 10, 15, 21, 27, 29,
    32, 35, 43, 46, 52, 55, 57, 60, 63, 68, 73, 78, 84, 90, 92, 94, 96,
    99, 102, 105, 107, 109, 112, 114, 116, 121, 124, 128, 130, 133,
    135, 141, 6, 11, 16, 22, 30, 33, 36, 44, 47, 64, 74, 79, 85, 97,
    100, 103, 117, 125, 131, 136, 142, 12, 17, 23, 37, 48, 75, 80, 86,
    137, 143, 13, 18, 38, 144, 39, 145, 40, 146, 41, 147, 148, 149,
    150, 151, 152, 153, 154, 155, 156, 157, 158, 159, 160, 161, 162, 163,
]
K_IL_MAX = 164


@functools.lru_cache(maxsize=None)
def input_interleave_table(K: int) -> np.ndarray:
    """pi such that interleaved[k] = bits[pi[k]]."""
    assert K <= K_IL_MAX
    return np.asarray([p - (K_IL_MAX - K) for p in PI_IL_MAX
                       if p >= K_IL_MAX - K], np.int32)


@functools.lru_cache(maxsize=None)
def input_deinterleave_table(K: int) -> np.ndarray:
    pi = input_interleave_table(K)
    inv = np.zeros(K, np.int32)
    inv[pi] = np.arange(K, dtype=np.int32)
    return inv
