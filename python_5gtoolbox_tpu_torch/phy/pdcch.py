"""PDCCH: DCI encoding, CORESET CCE/REG mapping, search space, DMRS.

Port of python_5gtoolbox_tpu/phy/pdcch.py. Behavior parity targets:
  py5gphy/nr_pdcch/nr_dci_encoder.py:9-31  (pad-24-ones CRC24C with RNTI
                                            mask + polar nMax=9 iIL=1 + RM)
  py5gphy/nr_pdcch/nr_coreset.py:53        (CCE->REG mapping, incl.
                                            interleaved REG bundles)
  py5gphy/nr_pdcch/nr_searchspace.py       (monitoring slots, c_init,
                                            candidate hashing 38.213 10.1)
  py5gphy/nr_pdcch/nr_pdcch.py:39-134      (QPSK + DMRS on RE 1,5,9 with
                                            precoder granularity options)

The reference's gen_pdcch_resources leaves Yp undefined for common
search spaces (nr_searchspace.py:100-113 assigns Yp_nsf instead); Yp=0
per 38.213 10.1, as in the JAX package.

A PDCCH is a few hundred REs: the DCI is coded and the DMRS built on the
host (the polar code on CPU tensors), and Pdcch.process writes data and
DMRS into the slot grid tensor with one indexed write. Random DCI bits
come from the object's numpy Generator.
"""
from __future__ import annotations

import numpy as np
import torch

from python_5gtoolbox_tpu_torch.ops import polar as polar_ops
from python_5gtoolbox_tpu_torch.ops.crc import crc_encode_np
from python_5gtoolbox_tpu_torch.ops.modulation import modulate_np
from python_5gtoolbox_tpu_torch.ops.prbs import gen_prbs_np
from python_5gtoolbox_tpu_torch.phy.grid import write_res
from python_5gtoolbox_tpu_torch.utils.numerology import (RE_USAGE,
                                                         carrier_prb_size)


def dci_encode(dcibits: np.ndarray, rnti: int, E: int) -> np.ndarray:
    """CRC24C (24-ones padded, RNTI-masked) + polar(9,1) + RM (38.212 7.3)."""
    bits = np.concatenate([np.ones(24, np.int8), np.asarray(dcibits, np.int8)])
    blkandcrc = crc_encode_np(bits, "24C", rnti)[24:]
    K = blkandcrc.size
    enc = polar_ops.polar_encode_np(blkandcrc, E, 9, 1)
    return polar_ops.polar_ratematch(torch.as_tensor(enc[None]), K, E,
                                     0)[0].numpy()


class Coreset:
    """CORESET CCE-to-REG mapping (38.211 7.3.2.2)."""

    def __init__(self, carrier_config: dict, coreset_config: dict):
        self.cfg = coreset_config
        self.carrier = carrier_config
        self.prb_size = carrier_prb_size(carrier_config["scs"],
                                         carrier_config["BW"])
        fdr = coreset_config["frequencyDomainResources"]
        symdur = coreset_config["symduration"]
        bundle = coreset_config["REG_bundle_size"]
        assert symdur in (1, 2, 3)
        assert coreset_config["CCE_REG_mapping_type"] in (
            "noninterleaved", "interleaved")
        last_one = np.nonzero(np.asarray(fdr))[0][-1]
        assert (coreset_config["CORESET_startingPRB"]
                + (last_one + 1) * 6 <= self.prb_size)

        prbs = []
        for idx, bit in enumerate(fdr):
            if bit:
                prbs.extend(range(idx * 6, idx * 6 + 6))
        self.coreset_prb_list = prbs
        n_reg = len(prbs) * symdur
        self.num_cce = n_reg // 6

        # REG numbering: time-first then PRB; value = prb + sym*prb_size
        reg_map = np.array([prb + sym * self.prb_size
                            for prb in prbs for sym in range(symdur)],
                           np.int32)
        if coreset_config["CCE_REG_mapping_type"] == "noninterleaved":
            self.cce_to_reg = reg_map.reshape(self.num_cce, 6)
        else:
            R = coreset_config["interleaver_size"]
            shift = coreset_config["shift_index"]
            assert n_reg % (bundle * R) == 0
            C = n_reg // (bundle * R)
            bundles = reg_map.reshape(n_reg // bundle, bundle)
            out = np.zeros((self.num_cce, 6), np.int32)
            per_cce = 6 // bundle
            for m in range(self.num_cce):
                for n in range(per_cce):
                    x = 6 * m // bundle + n
                    c, r = divmod(x, R)
                    fx = (r * C + c + shift) % (n_reg // bundle)
                    out[m, n * bundle:(n + 1) * bundle] = bundles[fx]
            self.cce_to_reg = out


class NrSearchSpace:
    """PDCCH search space (38.213 10.1)."""

    def __init__(self, carrier_config, search_space_config, coreset_config):
        self.cfg = search_space_config
        self.coreset_config = coreset_config
        self.carrier = carrier_config
        self.prb_size = carrier_prb_size(carrier_config["scs"],
                                         carrier_config["BW"])
        assert (search_space_config["controlResourceSetId"]
                == coreset_config["coreset_id"])
        assert (search_space_config["FirstSymbolWithinSlot"]
                + coreset_config["symduration"] < 14)
        assert search_space_config["searchSpaceType"] in ("common", "ue")
        self.coreset = Coreset(carrier_config, coreset_config)
        for v, L in zip(search_space_config[
                "NrofCandidatesPerAggregationLevel"], [1, 2, 4, 8, 16]):
            assert v in (0, 1, 2, 3, 4, 5, 6, 8)
            assert v * L <= self.coreset.num_cce
        # reference-protocol aliases
        self.carrier_prb_size = self.prb_size
        self.search_space_config = search_space_config

    def is_active_slot(self, sfn: int, slot: int) -> bool:
        ks, os_ = self.cfg["monitoringSlotPeriodicityAndOffset"]
        n_frame_slot = 10 if self.carrier["scs"] == 15 else 20
        return any((sfn * n_frame_slot + slot - os_ - m) % ks == 0
                   for m in range(self.cfg["slotduration"]))

    def gen_cinit(self, rnti: int) -> int:
        if self.cfg["searchSpaceType"] == "ue":
            nid = self.coreset_config["PDCCH_DMRS_Scrambling_ID"]
            n_rnti = rnti
        else:
            nid = self.carrier["PCI"]
            n_rnti = 0
        return (n_rnti * (2 ** 16) + nid) % (2 ** 31)

    def gen_pdcch_resources(self, aggregation_level: int, candidate: int,
                            rnti: int, slot: int):
        cfg = self.cfg
        first_sym = cfg["FirstSymbolWithinSlot"]
        m_per_level = cfg["NrofCandidatesPerAggregationLevel"]
        L = aggregation_level
        ms = candidate
        Ms = m_per_level[int(np.log2(L))]
        assert ms < Ms
        ncce = self.coreset.num_cce
        if cfg["searchSpaceType"] == "common":
            yp = 0
        else:
            p = self.coreset_config["coreset_id"]
            ap = {0: 39827, 1: 39829, 2: 39839}[p % 3]
            yp = rnti
            for _ in range(slot + 1):
                yp = (ap * yp) % 65537
        first_cce = L * ((yp + (ms * ncce // (L * Ms))) % (ncce // L))

        prbs = []
        for m in range(L):
            prbs.extend(self.coreset.cce_to_reg[first_cce + m].tolist())
        prbs.sort()
        prbs = np.asarray(prbs, np.int32) + first_sym * self.prb_size
        data_re = (prbs[:, None] * 12
                   + np.array([0, 2, 3, 4, 6, 7, 8, 10, 11])).reshape(-1)
        return data_re.astype(np.int32), prbs

    def process(self, usage, sfn, slot):
        """Mark CORESET REs reserved when the search space is active
        (rate-match pattern for PDSCH)."""
        if not self.is_active_slot(sfn, slot):
            return usage
        first_sym = self.cfg["FirstSymbolWithinSlot"]
        n_sc = 12 * self.prb_size
        for sym in range(first_sym,
                         first_sym + self.coreset_config["symduration"]):
            for prb in self.coreset.coreset_prb_list:
                start = sym * n_sc + prb * 12
                seg = usage[0, start: start + 12]
                seg[seg == RE_USAGE["empty"]] = RE_USAGE["CORESET"]
        return usage


class Pdcch:
    """PDCCH channel object (DCI + DMRS onto the slot grid).

    process(fd_slot, usage, sfn, slot) writes into a (ant, 14*n_sc)
    complex64 grid tensor and a host int8 usage map. rng: numpy Generator
    for the DCI bits when data_source is empty (default: seeded with 0).
    """

    def __init__(self, pdcch_config: dict, nr_search_space: NrSearchSpace,
                 rng: np.random.Generator | None = None):
        self.cfg = pdcch_config
        self.ss = nr_search_space
        self.rng = np.random.default_rng(0) if rng is None else rng
        assert pdcch_config["rnti"] in range(65536)
        assert (pdcch_config["searchSpaceId"]
                == nr_search_space.cfg["controlResourceSetId"])
        assert pdcch_config["AggregationLevel"] in (1, 2, 4, 8, 16)
        assert pdcch_config["AllocatedCandidate"] < 8

    def get_dcibits(self, n_bits: int) -> np.ndarray:
        src = list(self.cfg.get("data_source", []))
        if not src:
            return self.rng.integers(0, 2, size=n_bits).astype(np.int8)
        reps = n_bits // len(src) + 1
        return np.asarray((src * reps)[:n_bits], np.int8)

    def is_active_slot(self, slot: int) -> bool:
        return (slot % self.cfg["period_in_slot"]) in \
            self.cfg["allocated_slots"]

    def process(self, fd_slot: torch.Tensor, usage: np.ndarray, sfn: int,
                slot: int):
        if not self.is_active_slot(slot):
            return fd_slot, usage
        assert self.ss.is_active_slot(sfn, slot)

        rnti = self.cfg["rnti"]
        L = self.cfg["AggregationLevel"]
        cand = self.cfg["AllocatedCandidate"]
        n_sc = 12 * self.ss.prb_size

        E = L * 6 * 9 * 2
        fe = dci_encode(self.get_dcibits(self.cfg["NumDCIBits"]), rnti, E)
        seq = gen_prbs_np(self.ss.gen_cinit(rnti), E)
        d_seq = modulate_np((fe + seq) % 2, "qpsk")

        data_re, prb_res = self.ss.gen_pdcch_resources(L, cand, rnti, slot)
        usage[0, data_re] = RE_USAGE["PDCCH-DATA"]

        # DMRS (38.211 7.4.1.3): QPSK on RE 1,5,9 of each PDCCH PRB
        first_sym = self.ss.cfg["FirstSymbolWithinSlot"]
        symdur = self.ss.coreset_config["symduration"]
        nid = self.ss.coreset_config["PDCCH_DMRS_Scrambling_ID"]
        dmrs_len = self.ss.prb_size * 3
        dmrs = np.zeros((symdur, dmrs_len), np.complex64)
        for m in range(symdur):
            sym = first_sym + m
            cinit = ((2 ** 17) * (14 * slot + sym + 1) * (2 * nid + 1)
                     + 2 * nid) % (2 ** 31)
            dmrs[m] = modulate_np(gen_prbs_np(cinit, dmrs_len * 2), "qpsk")

        if self.ss.coreset_config["precoder_granularity"] == "allContiguousRBs":
            targets = [(first_sym + si, prb, si)
                       for si in range(symdur)
                       for prb in self.ss.coreset.coreset_prb_list]
        else:
            targets = []
            for off in prb_res:
                sym = int(off // self.ss.prb_size)
                prb = int(off - sym * self.ss.prb_size)
                targets.append((sym, prb, sym - first_sym))
        t = np.asarray(targets, np.int64).reshape(-1, 3)
        # REs 1, 5, 9 of each target PRB, and the DMRS values for them
        dmrs_re = ((t[:, 0] * n_sc + t[:, 1] * 12)[:, None]
                   + np.array([1, 5, 9])).reshape(-1)
        dmrs_val = dmrs[t[:, 2][:, None],
                        t[:, 1][:, None] * 3 + np.arange(3)].reshape(-1)
        usage[0, dmrs_re] = RE_USAGE["PDCCH-DMRS"]
        write_res(fd_slot, 0, np.concatenate([data_re, dmrs_re]),
                  np.concatenate([d_seq, dmrs_val]))
        return fd_slot, usage
