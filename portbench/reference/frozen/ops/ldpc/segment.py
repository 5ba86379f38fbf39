"""Code-block segmentation + CB-CRC attach, TS 38.212 5.2.2, and the
transport-block sizing shared by the DL-SCH / UL-SCH encoders and the
batched RX (sch_plan).

Frozen copy of the PyTorch port of python_5gtoolbox_tpu/ops/ldpc/segment.py. Fillers are zeros in
the bit tensor (their positions are a plan-time property of CBInfo); the
reference's -1 sentinel convention is reproduced only by cb_segment_np.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.frozen.ops import crc as crc_ops
from portbench.reference.frozen.ops.ldpc.ratematch import get_er_ldpc
from portbench.reference.frozen.ops.ldpc.tables import CBInfo, get_cbs_info


def sch_crc_bg(tbsize: int, rate1024: float) -> tuple[str, int]:
    """TB-CRC polynomial and LDPC base graph of a DL-SCH or UL-SCH
    transport block (38.212 7.2.1-7.2.2, 6.2.1-6.2.2)."""
    poly = "24A" if tbsize > 3824 else "16"
    bg2 = (tbsize <= 292 or (tbsize <= 3824 and rate1024 <= 0.67 * 1024)
           or rate1024 <= 0.25 * 1024)
    return poly, 2 if bg2 else 1


def sch_plan(tbsize: int, rate1024: float, G: int, qm: int, nl: int,
             tbs_lbrm: int | None):
    """(tb_poly, B, bgn, info, ncb, er_list) of a transport block coded
    into G bits. tbs_lbrm None => Ncb = N (UL-SCH: no LBRM)."""
    tb_poly, bgn = sch_crc_bg(tbsize, rate1024)
    B = tbsize + (24 if tb_poly == "24A" else 16)
    info = get_cbs_info(B, bgn)
    ncb = info.N if tbs_lbrm is None else \
        min(info.N, math.floor(tbs_lbrm / (info.C * 2 / 3)))
    return tb_poly, B, bgn, info, ncb, get_er_ldpc(G, info.C, qm, nl)


def er_groups(er_list):
    """(c0, c1, E): the runs of code blocks of equal rate-match length
    (at most two, 38.212 5.4.2.1)."""
    c0 = 0
    while c0 < len(er_list):
        c1 = c0
        while c1 < len(er_list) and er_list[c1] == er_list[c0]:
            c1 += 1
        yield c0, c1, er_list[c0]
        c0 = c1


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
