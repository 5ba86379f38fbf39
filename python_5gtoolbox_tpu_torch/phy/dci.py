"""DCI payload generators (formats 0_0 / 0_1 / 1_0 / 1_1) + CORESET0.

Port of python_5gtoolbox_tpu/phy/dci.py (pure Python). Behavior parity
targets:
  py5gphy/nr_pdcch/dciformat00.py:5  (gen_dciformat00)
  py5gphy/nr_pdcch/dciformat01.py:6  (gen_dciformat01)
  py5gphy/nr_pdcch/dciformat10.py:7  (gen_dciformat10 / type1_RIV_gen)
  py5gphy/nr_pdcch/dciformat11.py:6  (gen_dciformat11)
  py5gphy/nr_pdcch/coreset0.py:5     (gen_coreset0_config; the reference
      indexes a Python list with a 2-D subscript, a latent crash, so
      this implementation uses proper arrays but emits the same fields)

Same field envelope as the reference: resource allocation type 1 only,
TDRA index 0 (mapping type A, S=2, L=12), no carrier/BWP indicators,
fixed zero values for the unconfigured optional fields. The polar
encode of a payload is phy/pdcch.dci_encode.
"""
from __future__ import annotations

import math

import numpy as np


def _bits(val: int, n: int) -> list[int]:
    return [(val >> (n - 1 - i)) & 1 for i in range(n)]


def type1_riv(rb_start: int, rb_size: int, n_bwp: int) -> int:
    """Resource allocation type 1 RIV, 38.214 5.1.2.2.2."""
    if (rb_size - 1) <= (n_bwp // 2):
        return n_bwp * (rb_size - 1) + rb_start
    return n_bwp * (n_bwp - rb_size + 1) + (n_bwp - 1 - rb_start)


def _riv_bits(n_bwp_prb: int, riv: int) -> list[int]:
    size = math.ceil(np.log2(n_bwp_prb * (n_bwp_prb + 1) / 2))
    return _bits(riv, size)


def gen_dciformat00(n_ul_bwp_prb: int, riv: int, imcs: int, rv: int,
                    harqid: int) -> np.ndarray:
    """DCI format 0_0 (UL grant), 38.212 7.3.1.1.1."""
    dci = [0]                                  # identifier: UL
    dci += _riv_bits(n_ul_bwp_prb, riv)        # FDRA (type 1)
    dci += _bits(0, 4)                         # TDRA
    dci += [0]                                 # frequency hopping flag
    dci += _bits(imcs, 5)                      # MCS
    dci += [1]                                 # NDI
    dci += _bits(rv, 2)                        # RV
    dci += _bits(harqid, 4)                    # HARQ process
    dci += _bits(0, 2)                         # TPC for PUSCH
    return np.array(dci, dtype=np.int64)


def gen_dciformat01(n_ul_bwp_prb: int, riv: int, imcs: int, rv: int,
                    harqid: int) -> np.ndarray:
    """DCI format 0_1 (UL grant, non-fallback), 38.212 7.3.1.1.2."""
    dci = [0]                                  # identifier: UL
    dci += _riv_bits(n_ul_bwp_prb, riv)        # FDRA (type 1)
    dci += _bits(0, 4)                         # TDRA
    dci += [0]                                 # frequency hopping flag
    dci += _bits(imcs, 5)                      # MCS
    dci += [1]                                 # NDI
    dci += _bits(rv, 2)                        # RV
    dci += _bits(harqid, 4)                    # HARQ process
    dci += _bits(0, 2)                         # 1st DAI (dynamic codebook)
    dci += [1]                                 # SRS resource indicator
    dci += _bits(0, 4)                         # precoding info + layers
    dci += _bits(0, 4)                         # antenna ports
    dci += _bits(0, 2)                         # SRS request
    dci += _bits(0, 2)                         # beta_offset indicator
    dci += [0]                                 # DMRS sequence init
    dci += [0]                                 # UL-SCH indicator
    return np.array(dci, dtype=np.int64)


def gen_dciformat10(n_dl_bwp_prb: int, riv: int, start_sym: int,
                    n_sym: int, imcs: int, rv: int,
                    harqid: int) -> np.ndarray:
    """DCI format 1_0 scrambled by C-RNTI, 38.212 7.3.1.2.1."""
    assert start_sym == 2 and n_sym == 12      # TDRA row 0 only
    dci = [1]                                  # identifier: DL
    dci += _riv_bits(n_dl_bwp_prb, riv)        # FDRA (type 1)
    dci += _bits(0, 4)                         # TDRA
    dci += [0]                                 # VRB-to-PRB: non-interleaved
    dci += _bits(imcs, 5)                      # MCS
    dci += [1]                                 # NDI
    dci += _bits(rv, 2)                        # RV
    dci += _bits(harqid, 4)                    # HARQ process
    dci += _bits(0, 2)                         # DAI
    dci += _bits(0, 2)                         # TPC for PUCCH
    dci += _bits(0, 3)                         # PUCCH resource indicator
    dci += _bits(0, 3)                         # PDSCH-to-HARQ timing
    return np.array(dci, dtype=np.int64)


def gen_dciformat11(n_dl_bwp_prb: int, riv: int, start_sym: int,
                    n_sym: int, imcs: int, rv: int,
                    harqid: int) -> np.ndarray:
    """DCI format 1_1 (DL, non-fallback, single TB), 38.212 7.3.1.2.2."""
    assert start_sym == 2 and n_sym == 12      # TDRA row 0 only
    dci = [1]                                  # identifier: DL
    dci += _riv_bits(n_dl_bwp_prb, riv)        # FDRA (type 1)
    dci += _bits(0, 4)                         # TDRA
    dci += [0]                                 # VRB-to-PRB: non-interleaved
    dci += _bits(imcs, 5)                      # MCS (TB1)
    dci += [1]                                 # NDI
    dci += _bits(rv, 2)                        # RV
    dci += _bits(harqid, 4)                    # HARQ process
    dci += _bits(0, 2)                         # DAI
    dci += _bits(0, 2)                         # TPC for PUCCH
    dci += _bits(0, 3)                         # PUCCH resource indicator
    dci += _bits(0, 3)                         # PDSCH-to-HARQ timing
    dci += _bits(0, 4)                         # antenna ports (tbl -1)
    dci += _bits(0, 2)                         # SRS request
    dci += [0]                                 # DMRS seq init (nSCID)
    return np.array(dci, dtype=np.int64)


# 38.213 Table 13-1 ({SSB, PDCCH} SCS {15,15} kHz, min BW 5/10 MHz):
# (N_CORESET_RB, N_CORESET_sym, RB offset) per pdcch_ConfigSIB1 index.
_CORESET0_15KHZ = np.array([
    [24, 2, 0], [24, 2, 2], [24, 2, 4], [24, 3, 0], [24, 3, 2],
    [24, 3, 4], [48, 1, 12], [48, 1, 16], [48, 2, 12], [48, 2, 16],
    [48, 3, 12], [48, 3, 16], [96, 1, 38], [96, 2, 38], [96, 3, 38]])

# 38.213 Table 13-4 ({30, 30} kHz, min BW 5/10 MHz).
_CORESET0_30KHZ = np.array([
    [24, 2, 0], [24, 2, 1], [24, 2, 2], [24, 2, 3], [24, 2, 4],
    [24, 3, 0], [24, 3, 1], [24, 3, 2], [24, 3, 3], [24, 3, 4],
    [48, 1, 12], [48, 1, 14], [48, 1, 16], [48, 2, 12], [48, 2, 14],
    [48, 2, 16]])


def gen_coreset0_config(ssb_lowest_prb: int, pdcch_config_sib1: int,
                        scs: int, pci: int) -> dict:
    """CORESET0 config from SSB parameters, 38.213 13 / 38.211 7.3.2.2."""
    table = _CORESET0_15KHZ if scs == 15 else _CORESET0_30KHZ
    assert 0 <= pdcch_config_sib1 < len(table)
    n_rb, n_sym, offset = (int(v) for v in table[pdcch_config_sib1])
    return {
        "coreset_id": 0,
        "frequencyDomainResources": [1] * (n_rb // 6)
                                    + [0] * (45 - n_rb // 6),
        "symduration": n_sym,
        "CCE_REG_mapping_type": "interleaved",
        "REG_bundle_size": 6,
        "interleaver_size": 2,
        "shift_index": pci,
        "precoder_granularity": "sameAsREG-bundle",
        "PDCCH_DMRS_Scrambling_ID": pci,
        "CORESET_startingPRB": ssb_lowest_prb + offset,
    }
