"""Polar code-block segmentation for UCI, TS 38.212 6.3.1.2.1 / 5.2.1.

Port of python_5gtoolbox_tpu/ops/polar/segment.py: the optional split into
two code blocks (an odd-length payload gets one zero in front) and the
per-block CRC6 or CRC11.
"""
from __future__ import annotations

import numpy as np
import torch

from python_5gtoolbox_tpu_torch.ops import crc as crc_ops


def polar_cb_segment(uci_bits: np.ndarray, e_uci: int):
    """(A,) UCI bits -> (cbs (C, A/C + L) int8 numpy, C, Er)."""
    uci_bits = np.asarray(uci_bits, np.int8)
    A = uci_bits.size
    assert 12 <= A <= 1706
    if A >= 1013 or (A >= 360 and e_uci >= 1088):
        assert e_uci % 2 == 0
        C = 2
        padded = uci_bits if A % 2 == 0 else np.concatenate(
            [np.zeros(1, np.int8), uci_bits])
        cbs_in = padded.reshape(2, -1)
        poly = "11"
    else:
        C = 1
        cbs_in = uci_bits.reshape(1, -1)
        poly = "6" if A <= 19 else "11"
    out = crc_ops.crc_encode(torch.as_tensor(cbs_in), poly).numpy()
    return out, C, e_uci // C
