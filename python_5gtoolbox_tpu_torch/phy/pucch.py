"""PUCCH formats 0-4, TS 38.211 6.3.2 / 6.4.1.3.

Port of python_5gtoolbox_tpu/phy/pucch.py:
  format 0: sequence-selection ZC with mcs from the HARQ/SR tables
  format 1: ZC + time-domain OCC spreading + alternating DMRS
  format 2: UCI -> QPSK with DMRS on every 3rd RE
  format 3: DFT-s-OFDM pi/2-BPSK or QPSK
  format 4: like 3 plus block-wise OCC spreading
with the shared group/sequence/cyclic-shift hopping and the UCI coding
of phy/pusch_uci.py.

A slot's few values (sequences, coded UCI, the DFT of formats 3 and 4,
in float64 as NumPy computes it) are built on the host, as the JAX
package builds them; process() writes them into the slot's grid tensor
with one phy/grid.py:write_res per slot and marks them in the host
RE-usage map.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from python_5gtoolbox_tpu_torch import resolve_device
from python_5gtoolbox_tpu_torch.ops.lowpapr import lowpapr_seq
from python_5gtoolbox_tpu_torch.ops.modulation import modulate_np
from python_5gtoolbox_tpu_torch.ops.prbs import gen_prbs_np
from python_5gtoolbox_tpu_torch.phy.grid import write_res
from python_5gtoolbox_tpu_torch.phy.pusch_uci import encode_uci_on_ulsch
from python_5gtoolbox_tpu_torch.phy.validate import validate_pucch_config
from python_5gtoolbox_tpu_torch.utils.numerology import (RE_USAGE,
                                                         carrier_prb_size)

_DATA = RE_USAGE["PUCCH-DATA"]
_DMRS = RE_USAGE["PUCCH-DMRS"]


def encode_uci(uci_bits, n_bits: int, e_tot: int) -> np.ndarray:
    """PUCCH UCI coding (38.212 6.3.1), small-block path uses Qm=2."""
    return encode_uci_on_ulsch(uci_bits, n_bits, e_tot, qm=2)


def group_and_sequence_hopping(mode: str, hopping_id: int, slot: int,
                               nhop: int):
    """(u, v), 38.211 6.3.2.2.1."""
    fss = hopping_id % 30
    if mode == "neither":
        return fss, 0
    if mode == "enable":
        seq = gen_prbs_np(hopping_id // 30, 8, offset=8 * (slot * 2 + nhop))
        fgh = int(np.sum(seq * (2 ** np.arange(8)))) % 30
        return (fgh + fss) % 30, 0
    if mode == "disable":
        cinit = 32 * (hopping_id // 30) + fss
        v = int(gen_prbs_np(cinit, 1, offset=2 * slot + nhop)[0])
        return fss, v
    raise ValueError(mode)


def cyclic_shift_hopping(m0: int, mcs: int, slot: int, sym: int,
                         hopping_id: int) -> float:
    """alpha, 38.211 6.3.2.2.2."""
    seq = gen_prbs_np(hopping_id, 8, offset=8 * 14 * slot + 8 * sym)
    ncs = int(np.sum(seq * (2 ** np.arange(8))))
    return 2 * np.pi * ((m0 + mcs + ncs) % 12) / 12


# 38.211 Table 6.4.1.3.3.2-1 DMRS positions for formats 3/4, nsym 5..14.
_F34_DMRS = [
    ([0, 3], [0, 3]), ([1, 4], [1, 4]), ([1, 4], [1, 4]),
    ([1, 5], [1, 5]), ([1, 6], [1, 6]), ([2, 7], [1, 3, 6, 8]),
    ([2, 7], [1, 3, 6, 9]), ([2, 8], [1, 4, 7, 10]),
    ([2, 9], [1, 4, 7, 11]), ([3, 10], [1, 5, 8, 12]),
]


def format34_sym_info(nsym: int, start: int, additional_dmrs: str,
                      hopping: str):
    """(DMRS symbols, data symbols) of a format 3/4 allocation."""
    if nsym == 4:
        dmrs = [1] if hopping == "disabled" else [0, 2]
    else:
        pair = _F34_DMRS[nsym - 5]
        dmrs = pair[1] if additional_dmrs == "true" else pair[0]
    dmrs_syms = [x + start for x in dmrs]
    data_syms = [x + start for x in range(nsym) if x not in dmrs]
    return dmrs_syms, data_syms


# 38.211 Table 6.3.2.4.1-2 orthogonal phase sequences.
_OCC_PH = [
    [[0]],
    [[0, 0], [0, 1]],
    [[0, 0, 0], [0, 1, 2], [0, 2, 1]],
    [[0, 0, 0, 0], [0, 2, 0, 2], [0, 0, 2, 2], [0, 2, 2, 0]],
    [[0, 0, 0, 0, 0], [0, 1, 2, 3, 4], [0, 2, 4, 1, 3], [0, 3, 1, 4, 2],
     [0, 4, 3, 2, 1]],
    [[0, 0, 0, 0, 0, 0], [0, 1, 2, 3, 4, 5], [0, 2, 4, 0, 2, 4],
     [0, 3, 0, 3, 0, 3], [0, 4, 2, 0, 4, 2], [0, 5, 4, 3, 2, 1]],
    [[0, 0, 0, 0, 0, 0, 0], [0, 1, 2, 3, 4, 5, 6], [0, 2, 4, 6, 1, 3, 5],
     [0, 3, 6, 2, 5, 1, 4], [0, 4, 1, 5, 2, 6, 3], [0, 5, 3, 1, 6, 4, 2],
     [0, 6, 5, 4, 3, 2, 1]],
]


def format1_wm_list(hopping: str, nsym: int, occ: int):
    """Per-symbol OCC weights for format 1 (data odd / DMRS even syms)."""
    n_data = nsym // 2
    if hopping == "enabled":
        sf0 = n_data // 2
        sf1 = n_data - sf0
        dmrs_m0 = [1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4]
        dsf0 = dmrs_m0[nsym - 4]
        dsf1 = (nsym - n_data) - dsf0
    else:
        sf0, sf1 = n_data, 0
        dsf0, dsf1 = nsym - n_data, 0
    wm = np.zeros(nsym, np.complex64)

    def w(n):
        ph = np.asarray(_OCC_PH[n - 1][occ])
        return np.exp(1j * 2 * np.pi * ph / n)

    wm[1: sf0 * 2: 2] = w(sf0)
    if sf1 > 0:
        wm[sf0 * 2 + 1: nsym: 2] = w(sf1)
    wm[0: dsf0 * 2: 2] = w(dsf0)
    if dsf1 > 0:
        wm[dsf0 * 2: nsym: 2] = w(dsf1)
    return wm, sf0, dsf0


class _PucchBase:
    """Shared protocol: process(fd_slot, usage, sfn, slot) writes one slot
    of the first antenna: fd_slot (ant, 14*n_sc) complex64, a tensor;
    usage the host (ant, 14*n_sc) int8 map. Both are written in place and
    returned; inactive slots are left as they are. The configuration is
    validated first (phy/validate.py:validate_pucch_config, ValueError
    naming the field), as in the JAX package. device (None -> cuda) is
    where gen_ul_waveform builds the grid of a list led by this
    channel."""

    FMT = None

    def __init__(self, carrier_config, cfg, device=None):
        validate_pucch_config(self.FMT, carrier_config, cfg)
        self.carrier = carrier_config
        self.cfg = cfg
        self.device = resolve_device(device)
        self.prb_size = carrier_prb_size(carrier_config["scs"],
                                         carrier_config["BW"])

    def _active(self, sfn, slot):
        n_slot_frame = 10 * self.carrier["scs"] // 15
        return not ((n_slot_frame * sfn + slot - self.cfg["slotoffset"])
                    % self.cfg["Periodicity_in_slot"])

    def _off(self, sym: int, prb: int) -> int:
        return 12 * self.prb_size * sym + prb * 12

    def _prb(self, hop2: bool) -> int:
        return self.cfg["secondHopPRB"] if hop2 else self.cfg["startingPRB"]

    def process(self, fd_slot: torch.Tensor, usage: np.ndarray, sfn: int,
                slot: int):
        if not self._active(sfn, slot):
            return fd_slot, usage
        pieces = self._slot_res(slot)     # [(REs, values, usage code)]
        if pieces:
            res = np.concatenate([np.asarray(r, np.int64)
                                  for r, _, _ in pieces])
            for r, _, code in pieces:
                usage[0, r] = code
            write_res(fd_slot, 0, res,
                      np.concatenate([np.asarray(v, np.complex64)
                                      for _, v, _ in pieces]))
        return fd_slot, usage

    def _slot_res(self, slot: int) -> list:
        raise NotImplementedError


class NrPUCCHFormat0(_PucchBase):
    """38.211 6.3.2.3 — sequence selection."""

    FMT = 0

    def __init__(self, carrier_config, cfg, device=None):
        super().__init__(carrier_config, cfg, device)
        harq = cfg["HARQbits"]
        n = cfg["numHARQbits"]
        if cfg["SR"] == "negative":
            if n == 0:
                mcs = 0
            elif n == 1:
                mcs = harq[0] * 6
            else:
                mcs = [0, 3, 9, 6][harq[0] * 2 + harq[1]]
        else:
            if n == 0:
                mcs = 0
            elif n == 1:
                mcs = 3 + harq[0] * 6
            else:
                mcs = [1, 4, 10, 7][harq[0] * 2 + harq[1]]
        self.mcs = mcs
        self.m0 = cfg["initialCyclicShift"]

    def _slot_res(self, slot):
        cfg = self.cfg
        if cfg["numHARQbits"] == 0 and cfg["SR"] == "negative":
            return []
        out = []
        for m in range(cfg["nrofSymbols"]):
            hop2 = m == 1 and cfg["intraSlotFrequencyHopping"] == "enabled"
            sym = m + cfg["startingSymbolIndex"]
            u, v = group_and_sequence_hopping(cfg["pucch_GroupHopping"],
                                              cfg["hoppingId"], slot,
                                              1 if hop2 else 0)
            alpha = cyclic_shift_hopping(self.m0, self.mcs, slot, sym,
                                         cfg["hoppingId"])
            off = self._off(sym, self._prb(hop2))
            out.append((np.arange(off, off + 12), lowpapr_seq(u, v, alpha, 12),
                        _DATA))
        return out


class NrPUCCHFormat1(_PucchBase):
    """38.211 6.3.2.4 — ZC + OCC spreading + DMRS."""

    FMT = 1

    def __init__(self, carrier_config, cfg, device=None):
        super().__init__(carrier_config, cfg, device)
        n = cfg["numHARQbits"]
        harq = np.asarray(cfg["HARQbits"], np.int8)
        d0 = modulate_np(harq[:1], "bpsk") if n == 1 else \
            modulate_np(harq[:2], "qpsk")
        nsym = cfg["nrofSymbols"]
        d_list = np.zeros(nsym, np.complex64)
        d_list[0::2] = 1
        d_list[1::2] = d0
        self.d_list = d_list
        self.wm_list, self.sf0, self.dsf0 = format1_wm_list(
            cfg["intraSlotFrequencyHopping"], nsym, cfg["timeDomainOCC"])
        self.m0 = cfg["initialCyclicShift"]

    def _slot_res(self, slot):
        cfg = self.cfg
        out = []
        for m in range(cfg["nrofSymbols"]):
            hop2 = (m >= self.sf0 + self.dsf0
                    and cfg["intraSlotFrequencyHopping"] == "enabled")
            sym = m + cfg["startingSymbolIndex"]
            u, v = group_and_sequence_hopping(cfg["pucch_GroupHopping"],
                                              cfg["hoppingId"], slot,
                                              1 if hop2 else 0)
            alpha = cyclic_shift_hopping(self.m0, 0, slot, sym,
                                         cfg["hoppingId"])
            zn = self.wm_list[m] * self.d_list[m] * lowpapr_seq(u, v, alpha,
                                                                 12)
            off = self._off(sym, self._prb(hop2))
            out.append((np.arange(off, off + 12), zn, _DATA))
        return out


class NrPUCCHFormat2(_PucchBase):
    """38.211 6.3.2.5 — UCI QPSK + DMRS every 3rd RE."""

    FMT = 2

    def _slot_res(self, slot):
        cfg = self.cfg
        nprb, nsym = cfg["nrofPRBs"], cfg["nrofSymbols"]
        e_tot = nprb * 8 * 2 * nsym
        g_seq = encode_uci(cfg["UCIbits"], cfg["NumUCIBits"], e_tot)
        cinit = cfg["RNTI"] * (2 ** 15) + cfg["NID"]
        scr = gen_prbs_np(cinit, e_tot)
        d_seq = modulate_np((g_seq + scr) % 2, "qpsk")
        nid0 = cfg["NID0"]
        out = []
        for m in range(nsym):
            sym = m + cfg["startingSymbolIndex"]
            hop2 = m == 1 and cfg["intraSlotFrequencyHopping"] == "enabled"
            prb = self._prb(hop2)
            dcinit = ((2 ** 17) * (14 * slot + sym + 1) * (2 * nid0 + 1)
                      + 2 * nid0) % (2 ** 31)
            rm = modulate_np(
                gen_prbs_np(dcinit, nprb * 4 * 2, offset=prb * 4 * 2),
                "qpsk")
            off = self._off(sym, prb)
            re = np.arange(off, off + nprb * 12)
            d0 = m * nprb * 8
            out += [(re[1::3], rm, _DMRS),
                    (re[0::3], d_seq[d0: d0 + nprb * 8: 2], _DATA),
                    (re[2::3], d_seq[d0 + 1: d0 + nprb * 8: 2], _DATA)]
        return out


class _Format34Base(_PucchBase):
    def _mod(self, g_seq):
        cfg = self.cfg
        cinit = cfg["RNTI"] * (2 ** 15) + cfg["NID"]
        scr = gen_prbs_np(cinit, g_seq.size)
        b = (g_seq + scr) % 2
        mod = "qpsk" if cfg["pi2BPSK"] == "disabled" else "pi/2-bpsk"
        return modulate_np(b, mod)

    def _hop2(self, sym: int) -> bool:
        cfg = self.cfg
        return (cfg["intraSlotFrequencyHopping"] == "enabled"
                and sym - cfg["startingSymbolIndex"]
                >= cfg["nrofSymbols"] // 2)

    def _syms(self):
        cfg = self.cfg
        return format34_sym_info(cfg["nrofSymbols"],
                                 cfg["startingSymbolIndex"],
                                 cfg["additionalDMRS"],
                                 cfg["intraSlotFrequencyHopping"])

    def _data_res(self, data_syms, blocks, msc):
        """Each data symbol's block through the M_sc-point DFT (float64
        on the host, as NumPy)."""
        out = []
        for sym, ym in zip(data_syms, blocks):
            off = self._off(sym, self._prb(self._hop2(sym)))
            out.append((np.arange(off, off + msc),
                        np.fft.fft(ym) / math.sqrt(msc), _DATA))
        return out

    def _dmrs_res(self, slot, dmrs_syms, msc, m0):
        cfg = self.cfg
        out = []
        for sym in dmrs_syms:
            hop2 = self._hop2(sym)
            u, v = group_and_sequence_hopping(cfg["pucch_GroupHopping"],
                                              cfg["hoppingId"], slot,
                                              1 if hop2 else 0)
            alpha = cyclic_shift_hopping(m0, 0, slot, sym, cfg["hoppingId"])
            off = self._off(sym, self._prb(hop2))
            out.append((np.arange(off, off + msc),
                        lowpapr_seq(u, v, alpha, msc), _DMRS))
        return out


class NrPUCCHFormat3(_Format34Base):
    """38.211 6.3.2.6 — DFT-s-OFDM."""

    FMT = 3

    def _slot_res(self, slot):
        cfg = self.cfg
        nprb = cfg["nrofPRBs"]
        dmrs_syms, data_syms = self._syms()
        per_sym = 24 if cfg["pi2BPSK"] == "disabled" else 12
        e_tot = per_sym * len(data_syms) * nprb
        d_seq = self._mod(encode_uci(cfg["UCIbits"], cfg["NumUCIBits"],
                                     e_tot))
        msc = nprb * 12
        blocks = [d_seq[k * msc: (k + 1) * msc]
                  for k in range(len(data_syms))]
        return (self._data_res(data_syms, blocks, msc)
                + self._dmrs_res(slot, dmrs_syms, msc, 0))


class NrPUCCHFormat4(_Format34Base):
    """38.211 6.3.2.6 with block-wise OCC — single PRB."""

    FMT = 4

    _OCC2 = [[1, 1], [1, -1]]
    _OCC4 = [[1, 1, 1, 1], [1, -1j, -1, 1j], [1, -1, 1, -1], [1, 1j, -1, -1j]]

    def _slot_res(self, slot):
        cfg = self.cfg
        occ_len, occ_idx = cfg["occ_Length"], cfg["occ_index"]
        dmrs_syms, data_syms = self._syms()
        per_sym = 24 if cfg["pi2BPSK"] == "disabled" else 12
        e_tot = per_sym * len(data_syms) // occ_len
        d_seq = self._mod(encode_uci(cfg["UCIbits"], cfg["NumUCIBits"],
                                     e_tot))
        msc = 12
        wnk = (self._OCC2 if occ_len == 2 else self._OCC4)[occ_idx]
        chunk = msc // occ_len
        blocks = [np.concatenate([w * d_seq[k * chunk: (k + 1) * chunk]
                                  for w in wnk])
                  for k in range(len(data_syms))]
        return (self._data_res(data_syms, blocks, msc)
                + self._dmrs_res(slot, dmrs_syms, msc,
                                 [0, 6, 3, 9][occ_idx]))
