"""Carrier numerology and slot grid.

Behavior parity target: py5gphy/common/nr_slot.py (carrier
PRB tables per 38.101, the 0.85-occupancy IFFT size rule, CP tables and
per-symbol timing offsets).

These are pure plan-time helpers: everything is a function of (scs, BW)
and returns static Python/NumPy values baked into compiled programs.
"""
from __future__ import annotations

import numpy as np

# TS 38.101-1 Table 5.3.2-1 max transmission bandwidth N_RB, FR1.
_PRB_SCS15 = {5: 25, 10: 52, 15: 79, 20: 106, 25: 133, 30: 160, 35: 188,
              40: 216, 45: 242, 50: 270}
_PRB_SCS30 = {5: 11, 10: 24, 15: 38, 20: 51, 25: 65, 30: 78, 35: 92,
              40: 106, 45: 119, 50: 133, 60: 162, 70: 189, 80: 217,
              90: 245, 100: 273}

SYMBOLS_PER_SLOT = 14
SC_PER_PRB = 12


def carrier_prb_size(scs: int, bw: int) -> int:
    table = _PRB_SCS15 if scs == 15 else _PRB_SCS30
    return table[bw]


def fft_size(prb_size: int) -> int:
    """IFFT size with 0.85 occupancy headroom for the channel filter
    transition band (same rule as the reference / Matlab 5G toolbox)."""
    return int(2 ** np.ceil(np.log2(prb_size * SC_PER_PRB / 0.85)))


def cp_sizes(scs: int, bw: int) -> tuple[int, list[int]]:
    """(sample_rate_hz, 14 per-symbol CP lengths) at the carrier's native
    IFFT rate. Normal CP: first symbol of each half-subframe is longer."""
    nfft = fft_size(carrier_prb_size(scs, bw))
    if scs == 15:
        base = np.array([160] + [144] * 6 + [160] + [144] * 6)
        cps = base * nfft // 2048
    else:
        base = np.array([352] + [288] * 13)
        cps = base * nfft // 4096
    return nfft * scs * 1000, [int(x) for x in cps]


def symbol_timing_offsets(scs: int):
    """Per-symbol data-section offsets from slot start, at the canonical
    rate (30.72 Msps for scs15 / 2048-FFT, 122.88 Msps for scs30 / 4096-FFT).
    Returns (seconds array, samples array) of length 14."""
    if scs == 15:
        cps, nfft, fs = [160] + [144] * 6 + [160] + [144] * 6, 2048, 30.72e6
    else:
        cps, nfft, fs = [352] + [288] * 13, 4096, 122.88e6
    samples = np.zeros(SYMBOLS_PER_SLOT)
    off = 0
    for m in range(SYMBOLS_PER_SLOT):
        off += cps[m]
        samples[m] = off
        off += nfft
    return samples / fs, samples


def slots_per_frame(scs: int) -> int:
    return 10 * (scs // 15)


def slot_samples(scs: int, bw: int) -> int:
    """Time-domain samples per slot at the carrier native rate."""
    _, cps = cp_sizes(scs, bw)
    nfft = fft_size(carrier_prb_size(scs, bw))
    return sum(cps) + SYMBOLS_PER_SLOT * nfft

