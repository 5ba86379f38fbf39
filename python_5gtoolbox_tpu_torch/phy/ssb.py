"""SSB / PBCH chain: MIB -> BCH -> PBCH + PSS/SSS + DMRS -> RE mapping.

Port of python_5gtoolbox_tpu/phy/ssb.py. Behavior parity targets:
  py5gphy/nr_ssb/nrBCH.py        (MIB packing, payload interleave G(j),
                                  SFN-indexed scrambling, CRC24C + polar
                                  E=864 nMax=9 iIL=1 + rate match)
  py5gphy/nr_ssb/ssb_generate.py (PSS/SSS m-sequences, PBCH scrambling/
                                  QPSK, DMRS on every 4th RE with shift
                                  v = PCI %% 4, 4-symbol x 240-SC block)
  py5gphy/nr_ssb/_getinfo.py     (case A/B/C burst timing, LMax,
                                  half-frame/periodicity gating)
  py5gphy/nr_ssb/nr_ssb_resource_mapping.py (kSSB / NSSB_CRB offsets,
                                  SSB-PRB-RSV reservation)

The SSB block of a slot is a few KB, built on the host (the polar code
on CPU tensors). process writes it into the slot grid, a tensor that may
live on the card, with one indexed write; the RE-usage map stays a host
numpy array. waveform_gen, the standalone SSB waveform, runs its IFFTs,
shifts and CP placement on the object's device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from python_5gtoolbox_tpu_torch import resolve_device
from python_5gtoolbox_tpu_torch.ops import polar as polar_ops
from python_5gtoolbox_tpu_torch.ops.crc import crc_encode_np
from python_5gtoolbox_tpu_torch.ops.modulation import modulate_np
from python_5gtoolbox_tpu_torch.ops.prbs import gen_prbs_np
from python_5gtoolbox_tpu_torch.phy.grid import write_res
from python_5gtoolbox_tpu_torch.phy.validate import validate_ssb_config
from python_5gtoolbox_tpu_torch.utils.numerology import (RE_USAGE,
                                                         carrier_prb_size)


@functools.lru_cache(maxsize=None)
def pss_sequence(pci: int) -> np.ndarray:
    """127-length PSS BPSK sequence, 38.211 7.4.2.2."""
    x = np.zeros(127, np.int8)
    x[:7] = [0, 1, 1, 0, 1, 1, 1]
    for i in range(120):
        x[i + 7] = (x[i + 4] + x[i]) % 2
    n2 = pci % 3
    return (1 - 2 * x[(np.arange(127) + 43 * n2) % 127]).astype(np.int8)


@functools.lru_cache(maxsize=None)
def sss_sequence(pci: int) -> np.ndarray:
    """127-length SSS sequence, 38.211 7.4.2.3."""
    x0 = np.zeros(127, np.int8)
    x0[0] = 1
    x1 = np.zeros(127, np.int8)
    x1[0] = 1
    for i in range(120):
        x0[i + 7] = (x0[i + 4] + x0[i]) % 2
        x1[i + 7] = (x1[i + 1] + x1[i]) % 2
    n2, n1 = pci % 3, pci // 3
    m0 = 15 * (n1 // 112) + 5 * n2
    m1 = n1 % 112
    n = np.arange(127)
    return ((1 - 2 * x0[(n + m0) % 127])
            * (1 - 2 * x1[(n + m1) % 127])).astype(np.int8)


def gen_bch_mib(ssb_config: dict, sfn: int) -> np.ndarray:
    """24-bit MIB payload, 38.331 6.2.1 (FR1, Lmax 4/8)."""
    mib_cfg = ssb_config["MIB"]
    kssb = ssb_config["kSSB"]
    mib = np.zeros(24, np.int8)
    mib[1:7] = [(sfn >> i) & 1 for i in range(9, 3, -1)]
    mib[7] = mib_cfg["subCarrierSpacingCommon"]
    mib[8:12] = [(kssb >> i) & 1 for i in range(3, -1, -1)]
    mib[12] = mib_cfg["dmrs_TypeA_Position"]
    mib[13:21] = [(mib_cfg["pdcch_ConfigSIB1"] >> i) & 1
                  for i in range(7, -1, -1)]
    mib[21] = mib_cfg["cellBarred"]
    mib[22] = mib_cfg["intraFreqReselection"]
    return mib


# 38.212 Table 7.1.1-1 payload interleaver.
_G_BCH = [16, 23, 18, 17, 8, 30, 10, 6, 24, 7, 0, 5, 3,
          2, 1, 4, 9, 11, 12, 13, 14, 15, 19, 20, 21, 22, 25, 26, 27, 28,
          29, 31]


def bch_encode(mib: np.ndarray, ssb_config: dict, sfn: int, hrf: int,
               pci: int) -> np.ndarray:
    """BCH payload interleave + scramble + CRC24C + polar(E=864) + RM."""
    abar = np.zeros(32, np.int8)
    abar[:24] = mib
    abar[24:28] = [(sfn >> i) & 1 for i in range(3, -1, -1)]
    abar[28] = hrf
    abar[29] = (ssb_config["kSSB"] >> 4) & 1

    a = np.zeros(32, np.int8)
    scramble_mask = np.ones(32, np.int8)
    j_sfn, j_hrf, j_ssb, j_other = 0, 10, 11, 14
    for idx in range(32):
        if idx in (1, 2, 3, 4, 5, 6) or idx in (24, 25, 26, 27):
            a[_G_BCH[j_sfn]] = abar[idx]
            if idx in (25, 26):  # 3rd/2nd LSB of SFN stay unscrambled
                scramble_mask[_G_BCH[j_sfn]] = 0
            j_sfn += 1
        elif idx == 28:
            a[_G_BCH[j_hrf]] = abar[idx]
            scramble_mask[_G_BCH[j_hrf]] = 0
        elif idx in (29, 30, 31):
            a[_G_BCH[j_ssb]] = abar[idx]
            j_ssb += 1
        else:
            a[_G_BCH[j_other]] = abar[idx]
            j_other += 1

    m = 32 - 3
    v = int(abar[25]) * 2 + int(abar[26])
    seq = gen_prbs_np(pci, m, offset=v * m)
    scr = scramble_mask.copy()
    scr[scramble_mask == 1] = seq
    trblk = (a + scr) % 2

    blkandcrc = crc_encode_np(trblk, "24C")
    K = blkandcrc.size  # 56
    enc = polar_ops.polar_encode_np(blkandcrc, 864, 9, 1)
    return polar_ops.polar_ratematch(torch.as_tensor(enc[None]), K, 864,
                                     0)[0].numpy()


def pbch_encode(rm_bits: np.ndarray, pci: int, issb: int) -> np.ndarray:
    """PBCH scrambling + QPSK, 38.211 7.3.3.1-2."""
    E = rm_bits.size
    seq = gen_prbs_np(pci, E, offset=E * issb)
    return modulate_np((rm_bits + seq) % 2, "qpsk")


def gen_ssb_block(mib, ssb_config, lmax, pci, sfn, hrf, issb) -> np.ndarray:
    """(4, 240) SSB block: PSS/SSS/PBCH/DMRS mapped per 38.211 7.4.3.1."""
    v = pci % 4
    block = np.zeros((4, 240), np.complex64)
    block[0, 56:183] = pss_sequence(pci)
    block[2, 56:183] = sss_sequence(pci)

    rm_bits = bch_encode(mib, ssb_config, sfn, hrf, pci)
    d_pbch = pbch_encode(rm_bits, pci, issb)

    ibar = (issb % 4) + 4 * hrf if lmax == 4 else issb % 8
    cinit = (((ibar + 1) * (pci // 4 + 1)) << 11) + ((ibar + 1) << 6) + v
    d_dmrs = modulate_np(gen_prbs_np(cinit, 2 * 144), "qpsk")

    dmrs_mask_240 = np.zeros(240, bool)
    dmrs_mask_240[v::4] = True
    # symbol 1: full 240 SC
    block[1, ~dmrs_mask_240] = d_pbch[:180]
    block[1, dmrs_mask_240] = d_dmrs[:60]
    # symbol 2: two 48-SC edges around SSS
    m48 = np.zeros(48, bool)
    m48[v::4] = True
    block[2, :48][~m48] = d_pbch[180:216]
    block[2, :48][m48] = d_dmrs[60:72]
    block[2, 192:240][~m48] = d_pbch[216:252]
    block[2, 192:240][m48] = d_dmrs[72:84]
    # symbol 3: full 240 SC
    block[3, ~dmrs_mask_240] = d_pbch[252:432]
    block[3, dmrs_mask_240] = d_dmrs[84:144]
    return block


class NrSSB:
    """SSB channel object: burst timing + grid mapping.

    process(fd_slot, usage, sfn, slot) writes into a (ant, 14*n_sc)
    complex64 grid tensor and a host (ant, 14*n_sc) int8 usage map, the
    reference's protocol. device (None -> cuda) is where waveform_gen
    computes. The configuration is validated first
    (phy/validate.py:validate_ssb_config).
    """

    def __init__(self, carrier_config: dict, ssb_config: dict, device=None):
        validate_ssb_config(carrier_config, ssb_config)
        self.carrier = carrier_config
        self.cfg = ssb_config
        self.device = resolve_device(device)
        self.prb_size = carrier_prb_size(carrier_config["scs"],
                                         carrier_config["BW"])
        fc = carrier_config["carrier_frequency_in_mhz"]
        duplex = carrier_config.get("duplex_type", "TDD")
        pattern = ssb_config["SSBPattern"]
        if pattern == "Case A":
            self.scs = 15
            low = fc <= 3000
        elif pattern == "Case B":
            self.scs = 30
            low = fc <= 3000
        elif pattern == "Case C":
            self.scs = 30
            low = (fc <= 3000) if duplex.upper() == "FDD" else (fc <= 1880)
        else:
            raise ValueError(f"bad SSBPattern {pattern}")
        if pattern == "Case B":
            base = [4, 8, 16, 20]
            ext = [4, 8, 16, 20, 32, 36, 44, 48]
        else:
            base = [2, 8, 16, 22]
            ext = [2, 8, 16, 22, 30, 36, 44, 50]
        self.lmax = 4 if low else 8
        self.candidates = np.array(base if low else ext)

    def ssbs_in_slot(self, sfn: int, slot: int):
        """[(first_symbol, iSSB)] scheduled in this (sfn, slot)."""
        slots_per_hrf = 5 if self.scs == 15 else 10
        hrf = slot // slots_per_hrf
        slot_in_hrf = slot % slots_per_hrf
        if (sfn * 2 + hrf) % (self.cfg["SSBperiod"] / 5):
            return []
        burst = list(self.cfg["ssb_PositionsInBurst"]) + [0] * 8
        out = []
        for idx, first in enumerate(self.candidates):
            if burst[idx] and slot_in_hrf == first // 14:
                out.append((int(first % 14), idx))
        return out

    def ssb_offset_sc(self) -> int:
        """Subcarrier offset of the SSB's lowest RE from grid SC 0."""
        nssb_crb, kssb = self.cfg["NSSB_CRB"], self.cfg["kSSB"]
        if self.scs == 15:
            return nssb_crb * 12 + kssb
        assert nssb_crb % 2 == 0 and kssb % 2 == 0
        return (nssb_crb * 12 + kssb) // 2

    def _pmi(self) -> np.ndarray:
        return np.asarray(self.cfg["PMI"])[
            : self.carrier["num_of_ant"], 0].astype(np.complex64)

    def process(self, fd_slot: torch.Tensor, usage: np.ndarray, sfn: int,
                slot: int):
        ssbs = self.ssbs_in_slot(sfn, slot)
        if not ssbs:
            return fd_slot, usage
        slots_per_frame = 10 * self.scs // 15
        hrf = slot // (slots_per_frame // 2)
        mib = gen_bch_mib(self.cfg, sfn)
        n_sc = 12 * self.prb_size
        pci = self.carrier["PCI"]
        pmi = self._pmi()
        off = self.ssb_offset_sc()
        first_prb, sc_in_prb = off // 12, off % 12
        res, vals = [], []
        for first_sym, issb in ssbs:
            block = gen_ssb_block(mib, self.cfg, self.lmax, pci, sfn, hrf,
                                  issb)
            for s in range(4):
                sym = first_sym + s
                base = n_sc * sym + off
                res.append(base + np.arange(240))
                vals.append(np.outer(pmi, block[s]))
                usage[0, base: base + 240] = RE_USAGE["SSB"]
                if sc_in_prb > 0:
                    prb0 = n_sc * sym + first_prb * 12
                    usage[0, prb0: prb0 + sc_in_prb] = RE_USAGE["SSB-PRB-RSV"]
                    last = n_sc * sym + (first_prb + 20) * 12
                    usage[0, base + 240: last] = RE_USAGE["SSB-PRB-RSV"]
        # every antenna row of fd_slot takes the block, as fd_slot[:, ...]
        write_res(fd_slot, np.arange(len(pmi))[:, None],
                  np.concatenate(res)[None, :],
                  np.concatenate(vals, axis=1))
        return fd_slot, usage

    def waveform_gen(self, waveform_config: dict) -> torch.Tensor:
        """Standalone SSB time-domain waveform at an arbitrary rate ->
        (ant, numofslots * 15 * ifftsize) complex64 on self.device.

        Behavior parity target: py5gphy/nr_ssb/nr_ssb.py:77-192
        (NrSSB.waveform_gen): SSB bursts placed with their lowest
        subcarrier at the IFFT center, then frequency-shifted by the
        pointA/NSSB_CRB/kSSB offset, CP added, per-symbol phase
        compensated; all slots treated as DL. Three reference quirks
        stay: no sqrt(N) IFFT scaling, the antenna roll -(nant // 2) of
        the reference's axis-free ifftshift, and the CP table scaled as
        cptable * ifftsize // 4096 (so ifftsize 8192 scales up).

        Every scheduled SSB symbol of the burst window becomes one row
        of a single batched IFFT; the shift, the phase compensation and
        the CP placement (one gather, one indexed write) follow on the
        device.
        """
        fs = int(waveform_config["samplerate_in_mhz"] * 1e6)
        numofslots = waveform_config["numofslots"]
        start_sfn = waveform_config["startSFN"]
        start_slot = waveform_config["startslot"]
        nant = self.carrier["num_of_ant"]
        fc = int(self.carrier["carrier_frequency_in_mhz"] * 1e6)
        pci = self.carrier["PCI"]
        dev = self.device

        point_a_15k = -self.prb_size * self.carrier["scs"] // 15 * 12 // 2
        ssb_sc0_15k = point_a_15k + self.cfg["NSSB_CRB"] * 12 + self.cfg["kSSB"]

        ssbscs = self.scs
        ifftsize = fs // (ssbscs * 1000)
        assert ifftsize in (128, 256, 512, 1024, 2048, 4096, 8192, 16384)
        if ssbscs == 15:
            cptable = np.array([320] + [288] * 6 + [320] + [288] * 6)
        else:
            cptable = np.array([352] + [288] * 13)
        # multiply first so ifftsize > 4096 scales CPs up
        cptable = (cptable * ifftsize // 4096).astype(int)
        slot_len = ifftsize * 15
        slots_per_frame = 10 * ssbscs // 15
        pmi = self._pmi()

        # ---- host plan: one (ant, 240) row per scheduled SSB symbol ----
        rows, row_slot, row_sym = [], [], []
        for m in range(numofslots):
            sfn = start_sfn + (start_slot + m) // slots_per_frame
            slot = (start_slot + m) % slots_per_frame
            hrf = slot // (slots_per_frame // 2)
            mib = gen_bch_mib(self.cfg, sfn)
            for first_sym, issb in self.ssbs_in_slot(sfn, slot):
                block = gen_ssb_block(mib, self.cfg, self.lmax, pci,
                                      sfn, hrf, issb)
                for s in range(4):
                    rows.append(np.outer(pmi, block[s]))
                    row_slot.append(m)
                    row_sym.append(first_sym + s)

        td = torch.zeros((nant, numofslots * slot_len),
                         dtype=torch.complex64, device=dev)
        if not rows:
            return td

        # ---- device: batched IFFT + frequency shift + phase comp ----
        n_rows = len(rows)
        spec = torch.zeros((n_rows, nant, ifftsize), dtype=torch.complex64,
                           device=dev)
        spec[:, :, ifftsize // 2: ifftsize // 2 + 240] = torch.as_tensor(
            np.stack(rows), device=dev)
        x = torch.fft.ifftshift(spec, dim=-1)
        if nant > 1:  # reference's axis-free ifftshift also rolls antennas
            x = torch.roll(x, -(nant // 2), dims=-2)
        body = torch.fft.ifft(x, dim=-1)
        shift_v = np.exp(1j * 2 * np.pi * ssb_sc0_15k * 15000 / fs
                         * np.arange(ifftsize)).astype(np.complex64)
        body = body * torch.as_tensor(shift_v, device=dev)
        sym_arr = np.asarray(row_sym)
        cps = cptable[sym_arr]
        t_off = (np.cumsum(np.concatenate([[0], cptable[:-1]]))[sym_arr]
                 + ifftsize * sym_arr)
        if fc:
            pc = np.exp(-1j * 2 * np.pi * (fc / fs)
                        * (t_off + cps)).astype(np.complex64)
            body = body * torch.as_tensor(pc, device=dev)[:, None, None]

        # ---- CP prepend + placement: one gather, one indexed write ----
        src, dst = [], []
        for i in range(n_rows):
            cp = int(cps[i])
            start = row_slot[i] * slot_len + int(t_off[i])
            k = np.arange(cp + ifftsize)
            src.append(i * ifftsize + (k - cp) % ifftsize)
            dst.append(start + k)
        flat = body.transpose(0, 1).reshape(nant, n_rows * ifftsize)
        td[:, torch.as_tensor(np.concatenate(dst), device=dev)] = \
            flat[:, torch.as_tensor(np.concatenate(src), device=dev)]
        return td
