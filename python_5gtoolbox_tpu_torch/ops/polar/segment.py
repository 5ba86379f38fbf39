"""Polar code-block segmentation for UCI, TS 38.212 6.3.1.2.1 / 5.2.1.

Port of python_5gtoolbox_tpu/ops/polar/segment.py: the optional split into
two code blocks (an odd-length payload gets one zero in front) and the
per-block CRC6 or CRC11; polar_cb_segment_rows does the same for a batch
of payloads on their device.
"""
from __future__ import annotations

import numpy as np
import torch

from python_5gtoolbox_tpu_torch.ops import crc as crc_ops


def polar_cb_segment_rows(uci_bits: torch.Tensor, e_uci: int):
    """(S, A) UCI bits -> (cbs (S, C, A/C + L) int8 on their device, C,
    Er): every row segmented and CRC-attached as polar_cb_segment."""
    uci_bits = uci_bits.to(torch.int8)
    A = uci_bits.shape[-1]
    assert 12 <= A <= 1706
    if A >= 1013 or (A >= 360 and e_uci >= 1088):
        assert e_uci % 2 == 0
        C = 2
        padded = uci_bits if A % 2 == 0 else torch.cat(
            [uci_bits.new_zeros(uci_bits.shape[:-1] + (1,)), uci_bits], -1)
        cbs_in = padded.reshape(padded.shape[:-1] + (2, -1))
        poly = "11"
    else:
        C = 1
        cbs_in = uci_bits[..., None, :]
        poly = "6" if A <= 19 else "11"
    return crc_ops.crc_encode(cbs_in, poly), C, e_uci // C


def polar_cb_segment(uci_bits: np.ndarray, e_uci: int):
    """(A,) UCI bits -> (cbs (C, A/C + L) int8 numpy, C, Er)."""
    cbs, C, er = polar_cb_segment_rows(
        torch.as_tensor(np.asarray(uci_bits, np.int8))[None], e_uci)
    return cbs[0].numpy(), C, er
