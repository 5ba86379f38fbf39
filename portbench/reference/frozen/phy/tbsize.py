"""Transport block size determination, TS 38.214 5.1.3 (DL and LBRM).

Behavior parity target: py5gphy/nr_pdsch/dl_tbsize.py (incl. the
round-half-up quirk at step 4 — 38.214's round breaks ties upward while
python3's round is banker's rounding) and TBS_LBRM per 38.212 5.4.2.1.
Pure plan-time scalar math.
"""
from __future__ import annotations

import math

# 38.214 Table 5.1.3.2-1.
TBS_TABLE = [
    24, 32, 40, 48, 56, 64, 72, 80, 88, 96, 104, 112, 120, 128, 136, 144,
    152, 160, 168, 176, 184, 192, 208, 224, 240, 256, 272, 288, 304, 320,
    336, 352, 368, 384, 408, 432, 456, 480, 504, 528, 552, 576, 608, 640,
    672, 704, 736, 768, 808, 848, 888, 928, 984, 1032, 1064, 1128, 1160,
    1192, 1224, 1256, 1288, 1320, 1352, 1416, 1480, 1544, 1608, 1672, 1736,
    1800, 1864, 1928, 2024, 2088, 2152, 2216, 2280, 2408, 2472, 2536, 2600,
    2664, 2728, 2792, 2856, 2976, 3104, 3240, 3368, 3496, 3624, 3752, 3824,
]

# 38.214 Tables 5.1.3.1-1/2/3: MCS index -> (Qm, coderate*1024).
MCS_TABLES = {
    "64QAM": [
        (2, 120), (2, 157), (2, 193), (2, 251), (2, 308), (2, 379),
        (2, 449), (2, 526), (2, 602), (2, 679), (4, 340), (4, 378),
        (4, 434), (4, 490), (4, 553), (4, 616), (4, 658), (6, 438),
        (6, 466), (6, 517), (6, 567), (6, 616), (6, 666), (6, 719),
        (6, 772), (6, 822), (6, 873), (6, 910), (6, 948),
    ],
    "256QAM": [
        (2, 120), (2, 193), (2, 308), (2, 449), (2, 602), (4, 378),
        (4, 434), (4, 490), (4, 553), (4, 616), (4, 658), (6, 466),
        (6, 517), (6, 567), (6, 616), (6, 666), (6, 719), (6, 772),
        (6, 822), (6, 873), (8, 682.5), (8, 711), (8, 754), (8, 797),
        (8, 841), (8, 885), (8, 916.5), (8, 948),
    ],
    "64QAMLOWSE": [
        (2, 30), (2, 40), (2, 50), (2, 64), (2, 78), (2, 99), (2, 120),
        (2, 157), (2, 193), (2, 251), (2, 308), (2, 379), (2, 449),
        (2, 526), (2, 602), (4, 340), (4, 378), (4, 434), (4, 490),
        (4, 553), (4, 616), (6, 438), (6, 466), (6, 517), (6, 567),
        (6, 616), (6, 666), (6, 719), (6, 772),
    ],
}


def mcs_to_qm_rate(mcs_table: str, mcs_index: int):
    return MCS_TABLES[mcs_table.upper()][mcs_index]


def _tbs_from_ninfo(ninfo: float, coderateby1024: float) -> int:
    if ninfo <= 3824:
        n = max(3, math.floor(math.log2(ninfo)) - 6)
        ninfo_bar = max(24, (2 ** n) * math.floor(ninfo / (2 ** n)))
        return next(v for v in TBS_TABLE if v >= ninfo_bar)
    n = math.floor(math.log2(ninfo - 24)) - 5
    tmp = (ninfo - 24) / (2 ** n)
    # 38.214: ties round towards the next largest integer (not banker's)
    if tmp == math.floor(tmp) + 0.5:
        rounded = math.floor(tmp) + 1
    else:
        rounded = round(tmp)
    ninfo_bar = max(3840, (2 ** n) * rounded)
    if coderateby1024 <= 256:
        C = math.ceil((ninfo_bar + 24) / 3816)
        return 8 * C * math.ceil((ninfo_bar + 24) / (8 * C)) - 24
    if ninfo_bar > 8424:
        C = math.ceil((ninfo_bar + 24) / 8424)
        return 8 * C * math.ceil((ninfo_bar + 24) / (8 * C)) - 24
    return 8 * math.ceil((ninfo_bar + 24) / 8) - 24


def dmrs_sym_count(dmrs_cfg: dict, ld: int) -> int:
    """Number of DM-RS symbols per 38.211 Table 7.4.1.1.2-3/4."""
    add_pos = dmrs_cfg["DMRSAddPos"]
    if dmrs_cfg["NrOfDMRSSymbols"] == 1:
        if ld <= 7:
            return 1
        if ld <= 9:
            return 1 if add_pos == 0 else 2
        if ld <= 11:
            return min(add_pos + 1, 3) if add_pos else 1
        return add_pos + 1
    if ld <= 9:
        return 2
    return (add_pos + 1) * 2


def _nprb_dmrs(dmrs_cfg: dict, ld: int) -> int:
    cfg_type = dmrs_cfg["DMRSConfigType"]
    ncdm = dmrs_cfg["NumCDMGroupsWithoutData"]
    if cfg_type == 1:
        per_sym = 6 if ncdm == 1 else 12
    else:
        per_sym = {1: 4, 2: 8, 3: 12}[ncdm]
    return dmrs_sym_count(dmrs_cfg, ld) * per_sym


def gen_tbsize(pdsch_config: dict):
    """(TBSize, Qm, coderateby1024) per 38.214 5.1.3."""
    ld = pdsch_config["StartSymbolIndex"] + pdsch_config["NrOfSymbols"]
    assert pdsch_config["ResourceAllocType"] == 1
    nprb = pdsch_config["ResAlloType1"]["RBSize"]
    qm, rate = mcs_to_qm_rate(pdsch_config["mcs_table"],
                              pdsch_config["mcs_index"])
    nre_bar = 12 * pdsch_config["NrOfSymbols"] - _nprb_dmrs(
        pdsch_config["DMRS"], ld)
    nre = min(156, nre_bar) * nprb
    ninfo = nre * rate / 1024 * qm * pdsch_config["num_of_layers"]
    return _tbs_from_ninfo(ninfo, rate), qm, rate


def gen_tbs_lbrm(pdsch_config: dict, carrier_prb_size: int,
                 carrier_max_mimo_layers: int) -> int:
    """TBS_LBRM per 38.212 5.4.2.1."""
    layers = min(carrier_max_mimo_layers, 4)
    qm = 8 if pdsch_config["mcs_table"].upper() == "256QAM" else 6
    rate = 948
    for bound, n in ((33, 32), (67, 66), (108, 107), (136, 135), (163, 162),
                     (218, 217)):
        if carrier_prb_size < bound:
            nprb = n
            break
    else:
        nprb = 273
    ninfo = 156 * nprb * rate / 1024 * qm * layers
    return _tbs_from_ninfo(ninfo, rate)


# 38.214 Tables 6.1.4.1-1 / 6.1.4.1-2 (UL with optional pi/2-BPSK q).
MCS_TABLE_61411 = [
    (1, 240), (1, 314), (2, 193), (2, 251), (2, 308), (2, 379), (2, 449),
    (2, 526), (2, 602), (2, 679), (4, 340), (4, 378), (4, 434), (4, 490),
    (4, 553), (4, 616), (4, 658), (6, 466), (6, 517), (6, 567), (6, 616),
    (6, 666), (6, 719), (6, 772), (6, 822), (6, 873), (6, 910), (6, 948),
]
MCS_TABLE_61412 = [
    (1, 60), (1, 80), (1, 100), (1, 128), (1, 156), (1, 198), (2, 120),
    (2, 157), (2, 193), (2, 251), (2, 308), (2, 379), (2, 449), (2, 526),
    (2, 602), (2, 679), (4, 378), (4, 434), (4, 490), (4, 553), (4, 616),
    (4, 658), (4, 699), (4, 772), (6, 567), (6, 616), (6, 666), (6, 772),
]


def ul_mcs_to_qm_rate(mcs_table: str, mcs_index: int, n_tp_pi2bpsk: int):
    """UL Qm/coderate, 38.214 6.1.4.1 (mirrors ul_tbsize._get_Qm_coderate)."""
    q = 2 - n_tp_pi2bpsk
    if mcs_table == "MCStable61411":
        qm, rate = MCS_TABLE_61411[mcs_index]
        if mcs_index <= 1:
            qm, rate = qm * q, int(rate / q)
        return qm, rate
    if mcs_table == "MCStable61412":
        qm, rate = MCS_TABLE_61412[mcs_index]
        if mcs_index <= 5:
            qm, rate = qm * q, int(rate / q)
        return qm, rate
    if mcs_table.upper() in ("256QAM", "64QAMLOWSE"):
        return MCS_TABLES[mcs_table.upper()][mcs_index]
    raise NameError("wrong mcs table")


def ulsch_tbsize(pusch_config: dict):
    """(TBSize, Qm, coderateby1024) for PUSCH, 38.214 6.1.4.

    Mirrors py5gphy/nr_pusch/ul_tbsize.py (note: it passes NrOfSymbols,
    not StartSymbolIndex+NrOfSymbols, as the DMRS duration Ld).
    """
    nprb = pusch_config["ResAlloType1"]["RBSize"]
    qm, rate = ul_mcs_to_qm_rate(pusch_config["mcs_table"],
                                 pusch_config["mcs_index"],
                                 pusch_config.get("nTpPi2BPSK", 0))
    nre_bar = 12 * pusch_config["NrOfSymbols"] - _nprb_dmrs(
        pusch_config["DMRS"], pusch_config["NrOfSymbols"])
    nre = min(156, nre_bar) * nprb
    ninfo = nre * rate / 1024 * qm * pusch_config["num_of_layers"]
    return _tbs_from_ninfo(ninfo, rate), qm, rate
