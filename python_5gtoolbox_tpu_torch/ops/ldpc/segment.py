"""Code-block segmentation + CB-CRC attach, TS 38.212 5.2.2.

Port of python_5gtoolbox_tpu/ops/ldpc/segment.py. Fillers are zeros in
the bit tensor (their positions are a plan-time property of CBInfo); the
reference's -1 sentinel convention is reproduced only by cb_segment_np.
"""
from __future__ import annotations

import numpy as np
import torch

from python_5gtoolbox_tpu_torch.ops import crc as crc_ops
from python_5gtoolbox_tpu_torch.ops.ldpc.tables import CBInfo, get_cbs_info


def cb_segment(inbits: torch.Tensor, info: CBInfo) -> torch.Tensor:
    """(..., B) bits -> (..., C, K) code blocks with CB-CRC24B (C > 1)
    and zero filler bits."""
    lead = inbits.shape[:-1]
    cbs = inbits.to(torch.int8).reshape(lead + (info.C, info.cbz))
    if info.C > 1:
        cbs = crc_ops.crc_encode(cbs, "24B")
    pad = info.K - (info.cbz + info.L)
    if pad:
        cbs = torch.cat([cbs, cbs.new_zeros(lead + (info.C, pad))], dim=-1)
    return cbs


def cb_segment_np(inbits: np.ndarray, bgn: int):
    """Reference-compatible wrapper: returns (cbs with -1 fillers, Zc)."""
    info = get_cbs_info(int(np.asarray(inbits).size), bgn)
    cbs = cb_segment(torch.as_tensor(np.asarray(inbits)), info).numpy().copy()
    if info.F:
        cbs[:, info.Kd:] = -1
    return cbs, info.Zc
