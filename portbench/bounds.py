"""Peaks of the card and the least time a kernel's work needs.

Published peaks of one NVIDIA H100 SXM (data sheet, dense, at the full
700 W power limit); a card set to a lower limit is slower, so every
share is printed beside the card's power limit.

The operation and byte count of banded_fir is a copy of the arithmetic
that chip_smoke.py (bound_ms) and PERF.md's kernel table use: the
inputs, the outputs and the taps moved once each, and two operations
(a multiply and an add) per tap per output, half of them for `up2`
(whose zero-stuffed inputs are never multiplied).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, HBM3
FP32_OPS_PER_S = 67e12         # H100 SXM, FP32 outside the tensor cores


def banded_fir_work(planes: int, t_in: int, taps: int, mode: str = "same"
                    ) -> tuple[float, float]:
    """(operations, bytes) of one banded_fir launch on (planes, t_in)
    float32 planes."""
    t_out = {"same": t_in, "up2": 2 * t_in, "down2": t_in // 2}[mode]
    n_bytes = 4 * (planes * t_in + planes * t_out + taps)
    n_ops = 2 * taps * planes * t_out * (0.5 if mode == "up2" else 1.0)
    return n_ops, n_bytes


def least_seconds(n_ops: float, n_bytes: float) -> tuple[float, str]:
    """(the least time on the card, "operations" or "bytes", whichever
    bounds it)."""
    t_ops = n_ops / FP32_OPS_PER_S
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
