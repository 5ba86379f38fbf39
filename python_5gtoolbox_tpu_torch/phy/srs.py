"""SRS generation and mapping, TS 38.211 6.4.1.4.

Port of python_5gtoolbox_tpu/phy/srs.py: ZC-sequence SRS on 1/2/4
ports, comb KTC 2/4, periodicity gating, the PUSCH collision assertion
on the first SRS symbol and the skip of symbols that PDCCH code points
occupy (as the reference), the C_SRS bandwidth table from data npz.
Frequency hopping is not supported (as the reference).

The sequences of a slot are built on the host and written into the
slot's grid tensor with one phy/grid.py:write_res; the RE-usage map is
a host array.
"""
from __future__ import annotations

import functools
import math
import pathlib

import numpy as np
import torch

from python_5gtoolbox_tpu_torch import resolve_device
from python_5gtoolbox_tpu_torch.ops.lowpapr import lowpapr_seq
from python_5gtoolbox_tpu_torch.ops.prbs import gen_prbs_np
from python_5gtoolbox_tpu_torch.phy.grid import write_res
from python_5gtoolbox_tpu_torch.utils.numerology import (RE_USAGE,
                                                         carrier_prb_size)

_DATA = pathlib.Path(__file__).resolve().parents[1] / "data"


@functools.lru_cache(maxsize=None)
def srs_bw_config(c_srs: int) -> np.ndarray:
    with np.load(_DATA / "srs_bw_config.npz") as z:
        return z["table"][c_srs].copy()


def get_srs_info(srs_config: dict, slot: int) -> dict:
    """Mirrors nr_srs_info.get_nrsrs_info."""
    cfg = srs_config
    n_ap = cfg["nrofSRSPorts"]
    ktc = cfg["KTC"]
    ktc_bar = cfg["combOffset"]
    n_cs = cfg["cyclicShift"]
    l0 = 14 - 1 - cfg["startPosition"]
    nsym = cfg["nrofSymbols"]
    n_rrc = cfg["freqDomainPosition"]
    nshift = cfg["freqDomainShift"]
    c_srs, b_srs, bhop = cfg["cSRS"], cfg["bSRS"], cfg["bhop"]
    assert bhop >= b_srs, "frequency hopping not supported"
    hopping = cfg["groupOrSequenceHopping"]
    seq_id = cfg["sequenceId"]

    row = srs_bw_config(c_srs)
    msrs_bs = np.array([row[1], row[3], row[5], row[7]])
    nbs_div = np.array([row[2], row[4], row[6], row[8]])
    nbs = np.floor(4 * n_rrc / msrs_bs) % nbs_div

    ncs_max = 8 if ktc == 2 else 12
    ktc_pis = np.array([ktc_bar] * n_ap, float)
    if n_cs >= ncs_max / 2 and n_ap == 4:
        ktc_pis[1] = (ktc_bar + ktc / 2) % ktc
        ktc_pis[3] = (ktc_bar + ktc / 2) % ktc
    k0_bars = nshift * 12 + ktc_pis
    msrs_sc_bs = msrs_bs * 12 / ktc
    k0_pis = k0_bars + np.sum(ktc * msrs_sc_bs[: b_srs + 1]
                              * nbs[: b_srs + 1])

    msrs_sc_b = int(msrs_sc_bs[b_srs])
    srs_symbols = [l0 + m for m in range(nsym)]
    ncs_i = [(n_cs + ncs_max * p / n_ap) % ncs_max for p in range(n_ap)]
    alpha_list = 2 * np.pi * np.asarray(ncs_i) / ncs_max

    fgh = [0] * nsym
    v_list = np.zeros(nsym, np.int16)
    if hopping == "groupHopping":
        seq = gen_prbs_np(seq_id, 8 * 20 * 14)
        for lq in range(nsym):
            sel = seq[8 * (slot * 14 + l0 + lq): 8 * (slot * 14 + l0 + lq) + 8]
            fgh[lq] = int(np.sum(sel * (2 ** np.arange(8)))) % 30
    elif hopping == "sequenceHopping":
        if msrs_sc_b >= 72:
            seq = gen_prbs_np(seq_id, 20 * 14)
            for lq in range(nsym):
                v_list[lq] = seq[slot * 14 + l0 + lq]
    u_list = (np.asarray(fgh) + seq_id) % 30
    return dict(alpha_list=alpha_list, u_list=u_list.astype(np.int16),
                v_list=v_list, MSRS_sc_b=msrs_sc_b,
                k0_pis=k0_pis.astype(np.int16), srs_symbols=srs_symbols)


class NrSRS:
    """SRS channel object with the reference process() protocol: fd_slot
    (ant, 14*n_sc) complex64, a tensor, and usage the host (ant,
    14*n_sc) int8 map, written in place and returned. device (None ->
    cuda) is where gen_ul_waveform builds the grid of a list led by
    this channel."""

    def __init__(self, carrier_config: dict, srs_config: dict, device=None):
        self.carrier = carrier_config
        self.cfg = srs_config
        self.device = resolve_device(device)
        self.prb_size = carrier_prb_size(carrier_config["scs"],
                                         carrier_config["BW"])

    def process(self, fd_slot: torch.Tensor, usage: np.ndarray, sfn: int,
                slot: int):
        cfg = self.cfg
        n_sc = 12 * self.prb_size
        n_slot_frame = 10 * self.carrier["scs"] // 15
        if (n_slot_frame * sfn + slot - cfg["SRSOffset"]) \
                % cfg["SRSPeriodicity"]:
            return fd_slot, usage
        info = get_srs_info(cfg, slot)
        ktc = cfg["KTC"]
        n_ap = cfg["nrofSRSPorts"]
        m_sc = info["MSRS_sc_b"]

        first = info["srs_symbols"][0]
        seg = usage[0, first * n_sc:(first + 1) * n_sc]
        if np.any(np.isin(seg, [RE_USAGE["PDSCH-DATA"],
                                RE_USAGE["PDSCH-DMRS"]])):
            raise AssertionError("PUSCH occupies first SRS symbol")

        ants, res, vals = [], [], []
        for lq in range(cfg["nrofSymbols"]):
            sym = info["srs_symbols"][lq]
            seg = usage[0, sym * n_sc:(sym + 1) * n_sc]
            # drop SRS symbols colliding with PUCCH (the reference checks
            # the PDCCH code points, nr_srs.py:73-76)
            if np.any(np.isin(seg, [RE_USAGE["PDCCH-DATA"],
                                    RE_USAGE["PDCCH-DMRS"]])):
                continue
            for port in range(n_ap):
                k0 = int(info["k0_pis"][port])
                assert k0 + ktc * m_sc <= n_sc
                re = sym * n_sc + k0 + ktc * np.arange(m_sc)
                usage[port, re] = RE_USAGE["SRS"]
                ants.append(np.full(m_sc, port))
                res.append(re)
                vals.append(lowpapr_seq(int(info["u_list"][lq]),
                                        int(info["v_list"][lq]),
                                        float(info["alpha_list"][port]),
                                        m_sc) / math.sqrt(n_ap))
        if res:
            write_res(fd_slot, np.concatenate(ants), np.concatenate(res),
                      np.concatenate(vals))
        return fd_slot, usage
