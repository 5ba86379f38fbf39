"""Generate TS 38.141-1 FR1 test-model waveforms (the counterpart of
scripts/gen_nr_testmodel.py, reference scripts/gen_nr_testmodel.py).

Builds the NR-FR1-TM{1.1,2,2a,3.1,3.1a} config sets with gen_nr_tm_cfg
at the script's constants (scs 30, BW 40, TDD, cell 1, 3500 MHz),
instantiates the DL channel objects (random payloads from --seed) and
emits the frame waveform at the carrier sample rate on --device; saves
the IQ to <out-dir>/*.npz with the JAX script's keys and file names and
prints its line per TM. The default out-dir is out/torch, beside the JAX
script's out/, whose files it would otherwise overwrite.

dl_multichannel_config gives a waveform with all four DL channels at
once (SSB, CSI-RS, PDCCH, PDSCH), ul_multichannel_config one with a
PUSCH, PUCCH formats 0-4 and a 4-port SRS; both are used to check the
composed paths.

    python -m python_5gtoolbox_tpu_torch.sim.gen_nr_testmodel
        [--device cpu] [--seed 0] [--out-dir out/torch]
"""
from __future__ import annotations

import argparse
import pathlib

import numpy as np

from python_5gtoolbox_tpu_torch import resolve_device
from python_5gtoolbox_tpu_torch.phy.srs import srs_bw_config
from python_5gtoolbox_tpu_torch.phy.testmodel import gen_nr_tm_cfg
from python_5gtoolbox_tpu_torch.utils.config import get_default_config, merged
from python_5gtoolbox_tpu_torch.utils.numerology import carrier_prb_size
from python_5gtoolbox_tpu_torch.waveform.dl import (gen_dl_channel_list,
                                                    gen_dl_waveform)

scs = 30
BW = 40
duplex = "TDD"
cell_id = 1
fc_mhz = 3500.0
TM_list = ["NR-FR1-TM1.1", "NR-FR1-TM2", "NR-FR1-TM2a", "NR-FR1-TM3.1",
           "NR-FR1-TM3.1a"]
# (scs, BW, duplex, cell_id, fc_mhz): the script's constants, and the test
# models at full width (BW 100: 40 slots at 122.88 Msps)
SCRIPT_WIDTH = (scs, BW, duplex, cell_id, fc_mhz)
FULL_WIDTH = (30, 100, "TDD", 1, 3500.0)


def tm_channel_lists(tm: str, width=SCRIPT_WIDTH, seed: int = 0,
                     device=None):
    """Test model tm at width (scs, BW, duplex, cell_id, fc_mhz) ->
    (waveform_config, carrier_config, (nrSSB_list, nrPdsch_list,
    nrCSIRS_list, nrPDCCH_list)), payloads from seed, on device (None ->
    cuda)."""
    scs_, bw, dup, cell, fc = width
    (waveform_cfg, carrier_cfg, ssb_cfg, csirs_list, coreset_list, ss_list,
     pdcch_list, pdsch_list) = gen_nr_tm_cfg(scs_, bw, dup, tm, cell, fc)
    return waveform_cfg, carrier_cfg, gen_dl_channel_list(
        waveform_cfg, carrier_cfg, ssb_cfg, pdcch_list, ss_list,
        coreset_list, csirs_list, pdsch_list, seed=seed, device=device)


def dl_multichannel_config(n_slots: int = 20,
                           samplerate_in_mhz: float = 245.76) -> dict:
    """Keyword arguments of gen_dl_channel_list for a waveform with SSB,
    CSI-RS, PDCCH and PDSCH together: 2 antennas, scs 30 / BW 40 (106
    PRBs), 3840 MHz. The default SSB (case C, 4 SSBs in slots 0 and 1 of
    even frames); a 2-port CSI-RS (row 3, fd-CDM2, symbol 10, every 5
    slots); a CORESET of 102 PRBs on symbol 1 with a PDCCH at aggregation
    level 4 in every slot; a 2-layer 256QAM PDSCH on 100 PRBs from symbol
    2 with DMRS on symbols 2 and 11, so that it starts after the CORESET
    and no DMRS symbol carries the CSI-RS."""
    carrier = merged(get_default_config("dl_carrier"),
                     dict(num_of_ant=2, maxMIMO_layers=2))
    waveform = merged(get_default_config("dl_waveform"),
                      dict(numofslots=n_slots,
                           samplerate_in_mhz=samplerate_in_mhz))
    csirs = merged(get_default_config("csirs"), dict(
        frequencyDomainAllocation=dict(row=3, bitstring="000001"),
        nrofPorts=2, cdm_type="fd-CDM2", density="one", nrofRBs=52,
        periodicity=5))
    coreset = merged(get_default_config("coreset"),
                     dict(frequencyDomainResources=[1] * 17 + [0] * 28))
    pdcch = merged(get_default_config("pdcch"),
                   dict(AggregationLevel=4, NumDCIBits=37, data_source=[]))
    pdsch = merged(get_default_config("pdsch"), dict(
        num_of_layers=2, DMRS=dict(DMRSAddPos=1), data_source=[]))
    return dict(waveform_config=waveform, carrier_config=carrier,
                ssb_config=get_default_config("ssb"),
                pdcch_config_list=[pdcch],
                search_space_list=[get_default_config("search_space")],
                coreset_config_list=[coreset], csirs_config_list=[csirs],
                pdsch_config_list=[pdsch])


def ul_multichannel_config(bw: int = 100, n_slots: int = 20,
                           samplerate_in_mhz: float = 245.76) -> dict:
    """Keyword arguments of gen_ul_channel_list for a waveform with a
    PUSCH, one PUCCH of each format 0-4 and a 4-port SRS together: scs 30
    / BW bw, TDD, 3840 MHz, 4 antennas. The PUSCH (1 port, 1
    layer, 256QAM table MCS 20, random blocks) fills every slot's
    symbols 0-11 on all PRBs but the top 10; each PUCCH hops between two
    of those 10 PRBs in even slots (format 0: symbols 12-13, 1: 10-13,
    2: 12-13, 3 and 4: 9-13); the SRS (comb 2, cSRS the widest the
    carrier holds: 104 PRBs at BW 40, 272 at BW 100) takes symbols 12-13
    of odd slots, after the PUSCH."""
    carrier = merged(get_default_config("ul_carrier"),
                     dict(BW=bw, num_of_ant=4, Nr=4))
    prb = carrier_prb_size(carrier["scs"], bw)
    waveform = merged(get_default_config("ul_waveform"),
                      dict(numofslots=n_slots,
                           samplerate_in_mhz=samplerate_in_mhz))
    pusch_cfg = merged(get_default_config("pusch"), dict(
        nNrOfAntennaPorts=1, nPMI=0, StartSymbolIndex=0, NrOfSymbols=12,
        ResAlloType1=dict(RBStart=0, RBSize=prb - 10)))
    every_even = dict(Periodicity_in_slot=2, slotoffset=0)
    pucch = [merged(get_default_config(f"pucch_format{fmt}"),
                    dict(every_even, startingPRB=prb - 10 + 2 * fmt,
                         secondHopPRB=prb - 9 + 2 * fmt))
             for fmt in range(5)]
    table = [srs_bw_config(c)[1] for c in range(64)]
    c_srs = max(range(64), key=lambda c: (table[c] <= prb, table[c], -c))
    srs = merged(get_default_config("srs"), dict(
        nrofSRSPorts=4, KTC=2, cSRS=c_srs, startPosition=1, nrofSymbols=2,
        SRSPeriodicity=2, SRSOffset=1))
    return dict(waveform_config=waveform, carrier_config=carrier,
                pusch_config_list=[pusch_cfg],
                srs_config_list=[srs],
                **{f"pucch_format{fmt}_config_list": [pucch[fmt]]
                   for fmt in range(5)})


def main(argv=None) -> list[pathlib.Path]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random PDSCH and DCI payloads")
    ap.add_argument("--out-dir", default="out/torch")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for tm in TM_list:
        waveform_cfg, carrier_cfg, lists = tm_channel_lists(
            tm, seed=args.seed, device=device)
        _, _, dl, _ = gen_dl_waveform(waveform_cfg, carrier_cfg, *lists)
        dl = dl.cpu().numpy()
        name = tm.replace(".", "p").replace("-", "_")
        out = out_dir / f"{name}_scs{scs}_bw{BW}_{duplex}.npz"
        np.savez_compressed(out, dl_waveform=dl,
                            samplerate_in_mhz=waveform_cfg[
                                "samplerate_in_mhz"])
        power = 10 * np.log10(np.mean(np.abs(dl) ** 2) + 1e-30)
        print(f"{tm}: {dl.shape[1]} samples @ "
              f"{waveform_cfg['samplerate_in_mhz']} Msps, "
              f"mean power {power:.2f} dBFS -> {out}")
        written.append(out)
    return written


if __name__ == "__main__":
    main()
