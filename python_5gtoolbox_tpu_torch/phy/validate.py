"""Per-channel config validation: named errors at construction time.

Port of python_5gtoolbox_tpu/phy/validate.py (pure Python). Behavior
parity targets: py5gphy/nr_ssb/nr_ssb_validate.py:6
(nrssb_config_validate), py5gphy/nr_pusch/nr_pusch_validation.py:5
(pusch_config_validate), and the PUCCH format 0-4 constructor asserts
(py5gphy/nr_pucch/nr_pucch_format0.py:34-49 ... nr_pucch_format4.py:
40-54). The reference uses bare `assert`; here an invalid config
raises ValueError naming the offending field and the allowed range,
so bad configs fail at channel construction instead of deep inside RE
mapping with an index error.
"""
from __future__ import annotations

from python_5gtoolbox_tpu_torch.utils.numerology import carrier_prb_size


def _chk(cond: bool, field: str, value, expect: str):
    if not cond:
        raise ValueError(f"invalid config: {field}={value!r}, "
                         f"expected {expect}")


def validate_ssb_config(carrier_config: dict, ssb_config: dict) -> None:
    """nr_ssb_validate.nrssb_config_validate parity (named errors)."""
    mib = ssb_config["MIB"]
    _chk(mib["subCarrierSpacingCommon"] in (0, 1),
         "MIB.subCarrierSpacingCommon", mib["subCarrierSpacingCommon"],
         "0 or 1")
    _chk(mib["dmrs_TypeA_Position"] in (0, 1), "MIB.dmrs_TypeA_Position",
         mib["dmrs_TypeA_Position"], "0 or 1")
    _chk(mib["pdcch_ConfigSIB1"] in range(256), "MIB.pdcch_ConfigSIB1",
         mib["pdcch_ConfigSIB1"], "0..255")
    _chk(mib["cellBarred"] in (0, 1), "MIB.cellBarred",
         mib["cellBarred"], "0 or 1")
    _chk(mib["intraFreqReselection"] in (0, 1), "MIB.intraFreqReselection",
         mib["intraFreqReselection"], "0 or 1")
    _chk(ssb_config["SSBPattern"] in ("Case A", "Case B", "Case C"),
         "SSBPattern", ssb_config["SSBPattern"], "Case A/B/C")
    _chk(len(ssb_config["ssb_PositionsInBurst"]) <= 8,
         "ssb_PositionsInBurst", ssb_config["ssb_PositionsInBurst"],
         "at most 8 entries (FR1 LMax)")
    _chk(ssb_config["SSBperiod"] in (5, 10, 20, 40, 80, 160),
         "SSBperiod", ssb_config["SSBperiod"], "5/10/20/40/80/160 ms")
    _chk(ssb_config["kSSB"] in range(24), "kSSB", ssb_config["kSSB"],
         "0..23")
    _chk(ssb_config["NSSB_CRB"] in range(2200), "NSSB_CRB",
         ssb_config["NSSB_CRB"], "0..2199")


def validate_pusch_config(carrier_config: dict, pusch_config: dict) -> None:
    """nr_pusch_validation.pusch_config_validate parity (named errors)."""
    c = pusch_config
    prbsize = carrier_prb_size(carrier_config["scs"], carrier_config["BW"])
    _chk(c["rnti"] in range(1, 65536), "rnti", c["rnti"], "1..65535")
    _chk(c["mcs_table"] in ("256QAM", "64QAMLowSE", "MCStable61411",
                            "MCStable61412"),
         "mcs_table", c["mcs_table"],
         "256QAM/64QAMLowSE/MCStable61411/MCStable61412")
    _chk(c["mcs_index"] < 28, "mcs_index", c["mcs_index"], "< 28")
    _chk(c["nTransPrecode"] in (0, 1), "nTransPrecode",
         c["nTransPrecode"], "0 or 1")
    _chk(c["nTransmissionScheme"] == 1, "nTransmissionScheme",
         c["nTransmissionScheme"], "1 (codebook-based only)")
    _chk(c["num_of_layers"] in (1, 2), "num_of_layers",
         c["num_of_layers"], "1 or 2")
    _chk(c["num_of_layers"] <= carrier_config["num_of_ant"],
         "num_of_layers", c["num_of_layers"],
         f"<= num_of_ant ({carrier_config['num_of_ant']})")
    _chk(c["nNrOfAntennaPorts"] in (1, 2), "nNrOfAntennaPorts",
         c["nNrOfAntennaPorts"], "1 or 2")
    dmrs = c["DMRS"]
    _chk(dmrs["nSCID"] in (0, 1), "DMRS.nSCID", dmrs["nSCID"], "0 or 1")
    _chk(dmrs["DMRSConfigType"] in (1, 2), "DMRS.DMRSConfigType",
         dmrs["DMRSConfigType"], "1 or 2")
    _chk(dmrs["NrOfDMRSSymbols"] in (1, 2), "DMRS.NrOfDMRSSymbols",
         dmrs["NrOfDMRSSymbols"], "1 or 2")
    _chk(dmrs["NumCDMGroupsWithoutData"] in (1, 2, 3),
         "DMRS.NumCDMGroupsWithoutData",
         dmrs["NumCDMGroupsWithoutData"], "1/2/3")
    _chk(dmrs["DMRSAddPos"] in (0, 1, 2, 3), "DMRS.DMRSAddPos",
         dmrs["DMRSAddPos"], "0..3")
    _chk(dmrs["PUSCHMappintType"] in ("A", "B"), "DMRS.PUSCHMappintType",
         dmrs["PUSCHMappintType"], "A or B")
    _chk(c["VRBtoPRBMapping"] in ("non-interleaved", "interleaved"),
         "VRBtoPRBMapping", c["VRBtoPRBMapping"],
         "non-interleaved or interleaved")
    _chk(c["nPMI"] in range(28), "nPMI", c["nPMI"], "0..27")
    _chk(c["StartSymbolIndex"] + c["NrOfSymbols"] <= 14,
         "StartSymbolIndex+NrOfSymbols",
         (c["StartSymbolIndex"], c["NrOfSymbols"]), "sum <= 14")
    _chk(c["ResourceAllocType"] == 1, "ResourceAllocType",
         c["ResourceAllocType"], "1 (type 1 only)")
    ra = c["ResAlloType1"]
    _chk(ra["RBStart"] + ra["RBSize"] <= prbsize, "ResAlloType1",
         (ra["RBStart"], ra["RBSize"]),
         f"RBStart+RBSize <= carrier PRB size ({prbsize})")
    _chk(all(v in range(4) for v in c["rv"]), "rv", c["rv"],
         "all values in 0..3")
    _chk(c["nHARQID"] in range(16), "nHARQID", c["nHARQID"], "0..15")
    _chk(c["NDI"] in (0, 1), "NDI", c["NDI"], "0 or 1")
    _chk(c["nNid"] in range(1024), "nNid", c["nNid"], "0..1023")
    _chk(c["UCIScaling"] in (0.5, 0.65, 0.8, 1), "UCIScaling",
         c["UCIScaling"], "0.5/0.65/0.8/1")
    _chk(c["I_HARQ_ACK_offset"] in range(16), "I_HARQ_ACK_offset",
         c["I_HARQ_ACK_offset"], "0..15")
    _chk(c["nTpPi2BPSK"] in (0, 1), "nTpPi2BPSK", c["nTpPi2BPSK"],
         "0 or 1")


_F3_PRBS = (1, 2, 3, 4, 5, 6, 8, 9, 10, 12, 15, 16)


def validate_pucch_config(fmt: int, carrier_config: dict,
                          cfg: dict) -> None:
    """PUCCH format 0-4 constructor-assert parity (named errors)."""
    prbsize = carrier_prb_size(carrier_config["scs"], carrier_config["BW"])
    nprb = cfg.get("nrofPRBs", 1) if fmt in (2, 3) else 0
    limit = prbsize - nprb if fmt in (2, 3) else prbsize
    _chk(cfg["startingPRB"] in range(limit), "startingPRB",
         cfg["startingPRB"], f"0..{limit - 1}")
    _chk(cfg["secondHopPRB"] in range(limit), "secondHopPRB",
         cfg["secondHopPRB"], f"0..{limit - 1}")
    _chk(cfg["intraSlotFrequencyHopping"] in ("enabled", "disabled"),
         "intraSlotFrequencyHopping", cfg["intraSlotFrequencyHopping"],
         "enabled or disabled")
    nsym = cfg["nrofSymbols"]
    if fmt == 0:
        _chk(nsym in (1, 2), "nrofSymbols", nsym, "1 or 2")
        _chk(cfg["initialCyclicShift"] in range(12), "initialCyclicShift",
             cfg["initialCyclicShift"], "0..11")
        _chk(cfg["pucch_GroupHopping"] in ("neither", "enable"),
             "pucch_GroupHopping", cfg["pucch_GroupHopping"],
             "neither or enable")
        _chk(cfg["hoppingId"] in range(1024), "hoppingId",
             cfg["hoppingId"], "0..1023")
        _chk(cfg["numHARQbits"] in (0, 1, 2), "numHARQbits",
             cfg["numHARQbits"], "0/1/2")
        _chk(cfg["SR"] in ("positive", "negative"), "SR", cfg["SR"],
             "positive or negative")
    elif fmt == 1:
        _chk(nsym in range(4, 15), "nrofSymbols", nsym, "4..14")
        _chk(cfg["initialCyclicShift"] in range(12), "initialCyclicShift",
             cfg["initialCyclicShift"], "0..11")
        _chk(cfg["pucch_GroupHopping"] in ("neither", "enable"),
             "pucch_GroupHopping", cfg["pucch_GroupHopping"],
             "neither or enable")
        _chk(cfg["hoppingId"] in range(1024), "hoppingId",
             cfg["hoppingId"], "0..1023")
        _chk(cfg["numHARQbits"] in (1, 2), "numHARQbits",
             cfg["numHARQbits"], "1 or 2")
    elif fmt == 2:
        _chk(cfg["nrofPRBs"] in range(1, 17), "nrofPRBs", cfg["nrofPRBs"],
             "1..16")
        _chk(nsym in (1, 2), "nrofSymbols", nsym, "1 or 2")
        _chk(cfg["NumUCIBits"] > 2 and cfg["NumUCIBits"] % 2 == 0,
             "NumUCIBits", cfg["NumUCIBits"], "> 2 and even")
        _chk(len(cfg["UCIbits"]) == cfg["NumUCIBits"], "UCIbits",
             len(cfg["UCIbits"]), "length == NumUCIBits")
        _chk(cfg["NID0"] in range(65536), "NID0", cfg["NID0"], "0..65535")
    else:  # formats 3 and 4
        _chk(nsym in range(4, 15), "nrofSymbols", nsym, "4..14")
        if fmt == 3:
            _chk(cfg["nrofPRBs"] in _F3_PRBS, "nrofPRBs", cfg["nrofPRBs"],
                 f"one of {_F3_PRBS} (2^a 3^b 5^c DFT sizes)")
        else:
            _chk(cfg["occ_Length"] in (2, 4), "occ_Length",
                 cfg["occ_Length"], "2 or 4")
            _chk(cfg["occ_index"] in range(cfg["occ_Length"]), "occ_index",
                 cfg["occ_index"], f"0..{cfg['occ_Length'] - 1}")
        _chk(cfg["NumUCIBits"] > 2, "NumUCIBits", cfg["NumUCIBits"], "> 2")
        _chk(len(cfg["UCIbits"]) == cfg["NumUCIBits"], "UCIbits",
             len(cfg["UCIbits"]), "length == NumUCIBits")
        _chk(cfg["additionalDMRS"] in ("true", "false"), "additionalDMRS",
             cfg["additionalDMRS"], "'true' or 'false'")
        _chk(cfg["pi2BPSK"] in ("enabled", "disabled"), "pi2BPSK",
             cfg["pi2BPSK"], "enabled or disabled")
        _chk(cfg["pucch_GroupHopping"] in ("neither", "enable", "disable"),
             "pucch_GroupHopping", cfg["pucch_GroupHopping"],
             "neither/enable/disable")
        _chk(cfg["hoppingId"] in range(1024), "hoppingId",
             cfg["hoppingId"], "0..1023")
    if fmt in (1, 2, 3, 4):
        _chk(cfg["startingSymbolIndex"] in range(14 - nsym + 1),
             "startingSymbolIndex", cfg["startingSymbolIndex"],
             f"0..{14 - nsym}")
    else:
        _chk(cfg["startingSymbolIndex"] in range(14 if nsym == 1 else 13),
             "startingSymbolIndex", cfg["startingSymbolIndex"],
             "0..13 (1 symbol) or 0..12 (2 symbols)")
    if fmt >= 2:
        _chk(cfg["NID"] in range(1024), "NID", cfg["NID"], "0..1023")
        _chk(cfg["RNTI"] in range(65536), "RNTI", cfg["RNTI"], "0..65535")
