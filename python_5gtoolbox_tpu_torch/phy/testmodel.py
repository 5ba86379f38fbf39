"""NR-FR1 test models (TS 38.141-1 4.9.2): TM1.1 / TM2 / TM2a / TM3.1 / TM3.1a.

Port of python_5gtoolbox_tpu/phy/testmodel.py (pure config). Behavior
parity targets: py5gphy/nr_testmodel/nr_testmodel_cfg.py:13-153 and
TM*_cfg.py: waveform/carrier/PDCCH/PDSCH config sets including the TDD
patterns DDDSUU (15 kHz) / DDDDDDDSUUUU (30 kHz) with S-slot 10:2:2 and
6:4:4 splits, boosted/deboosted PRB layouts, and random data sources.
Expressed data-driven instead of the reference's repeated literal
blocks; identical resulting config lists.
"""
from __future__ import annotations

import copy

from python_5gtoolbox_tpu_torch.utils.config import get_default_config
from python_5gtoolbox_tpu_torch.utils.numerology import (carrier_prb_size,
                                                         fft_size)


def _pdsch(ref, rnti, mcs_idx, ssi, nsym, rb_start, rb_size, period, slots):
    cfg = copy.deepcopy(ref)
    cfg.update(rnti=rnti, mcs_table="256QAM", mcs_index=mcs_idx, rv=[0],
               data_source=[], num_of_layers=1,
               VRBtoPRBMapping="non-interleaved", StartSymbolIndex=ssi,
               NrOfSymbols=nsym, period_in_slot=period,
               allocated_slots=list(slots))
    cfg["ResAlloType1"]["RBStart"] = rb_start
    cfg["ResAlloType1"]["RBSize"] = rb_size
    return cfg


def _tm1p1_list(prb, duplex, scs, ref):
    """Full-band QPSK pair (boosted RBs 0-2 at rnti 2)."""
    if duplex == "FDD":
        return [
            _pdsch(ref, 0, 0, 0, 14, 3, prb - 3, 1, [0]),
            _pdsch(ref, 2, 0, 2, 12, 0, 3, 1, [0]),
        ]
    if scs == 15:
        return [
            _pdsch(ref, 0, 0, 0, 14, 3, prb - 3, 5, [0, 1, 2]),
            _pdsch(ref, 2, 0, 2, 12, 0, 3, 5, [0, 1, 2]),
            _pdsch(ref, 0, 0, 0, 10, 3, prb - 3, 5, [3]),
            _pdsch(ref, 2, 0, 2, 8, 0, 3, 5, [3]),
        ]
    return [
        _pdsch(ref, 0, 0, 0, 14, 3, prb - 3, 10, range(7)),
        _pdsch(ref, 2, 0, 2, 12, 0, 3, 10, range(7)),
        _pdsch(ref, 0, 0, 0, 6, 3, prb - 3, 10, [7]),
        _pdsch(ref, 2, 0, 2, 4, 0, 3, 10, [7]),
    ]


def _tm2_list(prb, duplex, scs, ref):
    """Single-PRB 64QAM at band edges/center, cycling every 3 slots."""
    period = 10 * scs // 15
    starts = [0, prb // 2, prb - 1]
    out = []
    if duplex == "FDD":
        for phase, rb0 in enumerate(starts):
            out.append(_pdsch(ref, 2, 11, 2, 12, rb0, 1, period,
                              range(phase, period, 3)))
        return out
    d_range = range(3) if scs == 15 else range(7)
    s_slot = 3 if scs == 15 else 7
    s_nsym = 8 if scs == 15 else 4
    half_frame = 5 if scs == 15 else 10
    for phase, rb0 in enumerate(starts):
        slots = [n for n in range(phase, period, 3)
                 if (n % half_frame) in d_range]
        out.append(_pdsch(ref, 2, 11, 2, 12, rb0, 1, period, slots))
    for phase, rb0 in enumerate(starts):
        slots = [n for n in range(phase, period, 3)
                 if (n % half_frame) == s_slot]
        out.append(_pdsch(ref, 2, 11, 2, s_nsym, rb0, 1, period, slots))
    return out


def gen_nr_tm_cfg(scs: int, bw: int, duplex_mode: str, test_model: str,
                  cell_id: int, carrier_frequency_in_mhz: float):
    """Returns (waveform, carrier, ssb, csirs_list, coreset_list,
    search_space_list, pdcch_list, pdsch_list) — reference signature."""
    assert duplex_mode in ("TDD", "FDD")
    assert test_model in ("NR-FR1-TM1.1", "NR-FR1-TM2", "NR-FR1-TM2a",
                          "NR-FR1-TM3.1", "NR-FR1-TM3.1a")
    assert cell_id in range(1008)
    prb = carrier_prb_size(scs, bw)

    waveform = get_default_config("dl_waveform")
    waveform["numofslots"] = int((20 if duplex_mode == "TDD" else 10)
                                 * scs / 15)
    waveform["samplerate_in_mhz"] = scs * fft_size(prb) * 1000 / 1e6
    waveform["startSFN"] = 0
    waveform["startslot"] = 0

    carrier = get_default_config("dl_carrier")
    carrier.update(frequency_range="FR1", BW=bw, scs=scs, num_of_ant=1,
                   maxMIMO_layers=1, PCI=cell_id, duplex_type=duplex_mode,
                   carrier_frequency_in_mhz=carrier_frequency_in_mhz)

    ssb = get_default_config("ssb")
    ssb["enable"] = "False"

    coreset = get_default_config("coreset")
    coreset.update(enable="True", coreset_id=1, frequencyDomainResources=[1],
                   symduration=2, CCE_REG_mapping_type="noninterleaved",
                   REG_bundle_size=2, interleaver_size=2, shift_index=0,
                   precoder_granularity="sameAsREG-bundle",
                   PDCCH_DMRS_Scrambling_ID=cell_id, CORESET_startingPRB=0)

    ss = get_default_config("search_space")
    ss.update(enable="True", searchSpaceId=1, controlResourceSetId=1,
              monitoringSlotPeriodicityAndOffset=[1, 0], slotduration=1,
              FirstSymbolWithinSlot=0,
              NrofCandidatesPerAggregationLevel=[2, 1, 0, 0, 0],
              searchSpaceType="ue")

    pdcch = get_default_config("pdcch")
    pdcch.update(enable="True", rnti=0, searchSpaceId=1, AggregationLevel=1,
                 AllocatedCandidate=0, dci_format="1_0", NumDCIBits=20,
                 data_source=[])
    if duplex_mode == "FDD":
        pdcch["period_in_slot"] = 1
        pdcch["allocated_slots"] = [0]
    elif scs == 15:
        pdcch["period_in_slot"] = 5
        pdcch["allocated_slots"] = [0, 1, 2, 3]
    else:
        pdcch["period_in_slot"] = 10
        pdcch["allocated_slots"] = list(range(8))

    ref = get_default_config("pdsch")
    ref["DMRS"].update(PDSCHMappintType="A", DMRSAddPos=1, DMRSConfigType=1,
                       NrOfDMRSSymbols=1, nSCID=0,
                       NumCDMGroupsWithoutData=1, nNIDnSCID=cell_id)
    ref["nID"] = cell_id

    if test_model == "NR-FR1-TM1.1":
        pdsch_list = _tm1p1_list(prb, duplex_mode, scs, ref)
    elif test_model == "NR-FR1-TM2":
        pdsch_list = _tm2_list(prb, duplex_mode, scs, ref)
    elif test_model == "NR-FR1-TM2a":
        pdsch_list = _tm2_list(prb, duplex_mode, scs, ref)
        for c in pdsch_list:
            c["mcs_index"] = 20
    elif test_model == "NR-FR1-TM3.1":
        pdsch_list = _tm1p1_list(prb, duplex_mode, scs, ref)
        for c in pdsch_list:
            c["mcs_index"] = 11
    else:  # TM3.1a
        pdsch_list = _tm1p1_list(prb, duplex_mode, scs, ref)
        for c in pdsch_list:
            c["mcs_index"] = 20
    return (waveform, carrier, ssb, [], [coreset], [ss], [pdcch],
            pdsch_list)
