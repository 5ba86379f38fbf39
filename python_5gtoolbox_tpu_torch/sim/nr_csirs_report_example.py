"""CSI report example: CQI / PMI / RI over a TDL channel (the counterpart
of scripts/NR_CSIRS_report_example.py, which completes the reference's
stub with phy/csirs_report.py).

DL waveform with a CSI-RS resource (row 3: 2 ports, fd-CDM2, 52 RBs of
scs 30 / BW 40, 2 slots at 245.76 Msps) -> TDL-A 2x4 + AWGN at 0 / 10 /
20 dB, 2 tests each -> RX channel filter + RX low-PHY -> CDM despreading
channel estimate -> Type-I single-panel codebook search (RI, PMI) -> CQI
(table1, subband CQI and PMI, subbands of 8 PRBs). The reports go to
<out-dir>/nr_csirs_report.json.

    python -m python_5gtoolbox_tpu_torch.sim.nr_csirs_report_example
        [--device cpu] [--seed 0] [--out-dir out/torch]

The channel is static (fm_inHz 0), so each test's fading taps are one
draw held over the two slots; the taps and the noise come from a CPU
torch.Generator seeded with --seed and go to the device, so the card
and the CPU see the same channel.
"""
from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np
import torch

from python_5gtoolbox_tpu_torch import resolve_device
from python_5gtoolbox_tpu_torch.models import channel as chan_mod
from python_5gtoolbox_tpu_torch.phy.csirs import NrCSIRS
from python_5gtoolbox_tpu_torch.phy.csirs_report import NrCSIRSReport
from python_5gtoolbox_tpu_torch.utils.config import get_default_config, merged
from python_5gtoolbox_tpu_torch.utils.numerology import (carrier_prb_size,
                                                         slots_per_frame)
from python_5gtoolbox_tpu_torch.utils.platform import select_platform
from python_5gtoolbox_tpu_torch.waveform import dl as dl_wf
from python_5gtoolbox_tpu_torch.waveform import rx as rx_wf

# 38.211 Table 7.4.1.5.3-1 row -> (ports, cdm, density)
_ROW_CFG = {1: (1, "noCDM", "three"), 2: (1, "noCDM", "one"),
            3: (2, "fd-CDM2", "one"), 4: (4, "fd-CDM2", "one"),
            5: (4, "fd-CDM2", "one")}
_BITSTRING = {1: "000000000001", 2: "000000000001", 3: "000001",
              4: "001", 5: "000001"}


def example_config(row_number: int = 3) -> dict:
    """The JAX script's constants (row 3, SNR 0/10/20 dB, 2 tests, 4 RX
    antennas, 2 slots, BW 40)."""
    nports, cdm_type, density = _ROW_CFG[row_number]
    carrier = merged(get_default_config("dl_carrier"),
                     dict(BW=40, scs=30, num_of_ant=nports,
                          maxMIMO_layers=nports))
    csirs = get_default_config("csirs")
    csirs["frequencyDomainAllocation"]["row"] = row_number
    csirs["frequencyDomainAllocation"]["bitstring"] = _BITSTRING[row_number]
    csirs.update(nrofPorts=nports, cdm_type=cdm_type, density=density,
                 periodicity=10, slotoffset=0, startingRB=0, nrofRBs=52)
    report_cfg = get_default_config("csirs_report")
    report_cfg["CQITable "] = "table1"
    report_cfg["CQIMode "] = "Subband"
    report_cfg["PMIMode "] = "Subband"
    report_cfg["SubbandSize "] = 8
    n_rx = 4
    chan_cfg = chan_mod.gen_channel_model_config(
        model_format="TDL-A", Nt=nports, Nr=n_rx,
        Rspat_config=("high", "uniform", "DL", (0, 0)), DSdesired=20,
        fm_inHz=0)
    return dict(carrier=carrier, csirs=csirs, report=report_cfg,
                chan_cfg=chan_cfg, snr_db_list=[0.0, 10.0, 20.0],
                total_tests=2, n_rx=n_rx, n_slots=2, fs_hz=245.76e6,
                filename="nr_csirs_report.json")


def static_channel_draws(chan_cfg: dict, n: int, fs_hz: float,
                         gen: torch.Generator):
    """One test's draws of a static channel (fm_inHz 0): per path the
    (1, Nr, Nt) taps (the model's fading series is constant over time)
    and (Nr, n) unit complex AWGN, on gen's device (the CPU)."""
    if chan_cfg["fm_inHz"] != 0:
        raise ValueError("static_channel_draws needs fm_inHz 0")
    nt, nr = chan_cfg["Nt"], chan_cfg["Nr"]
    taps = [chan_mod.gen_mimo_channel(
        gen, nt, nr, np.asarray(chan_cfg["Rspat"]), 1, fs_hz, p[2], p[3],
        p[4], 0.0, chan_cfg["num_of_sinusoids"])
        for p in chan_cfg["multi_paths"]]
    noise = torch.complex(torch.randn((nr, n), generator=gen),
                          torch.randn((nr, n), generator=gen))
    return taps, noise


def run_csirs_report(config: dict, device=None, seed: int = 0) -> list:
    """The example's loops on device (None -> cuda) -> one row per SNR,
    test and CSI-RS slot: dict(snr_db, test, sfn, slot, RI, PMI, CQI,
    subband_CQI, rx_slot), rx_slot the received (Nr, 14*n_sc) grid on
    device."""
    dev = resolve_device(device)
    carrier, fs_hz = config["carrier"], config["fs_hz"]
    scs, n_slots = carrier["scs"], config["n_slots"]
    spf = slots_per_frame(scs)
    slot_size = 14 * 12 * carrier_prb_size(scs, carrier["BW"])
    waveform_config = dict(numofslots=n_slots, startSFN=0, startslot=0,
                           samplerate_in_mhz=fs_hz / 1e6)
    nrcsirs = NrCSIRS(carrier, config["csirs"])
    reporter = NrCSIRSReport(carrier, config["csirs"], config["report"],
                             n_rx=config["n_rx"], device=dev)
    _, _, dl, _ = dl_wf.gen_dl_waveform(waveform_config, carrier,
                                        nrCSIRS_list=[nrcsirs], device=dev)
    gen = torch.Generator().manual_seed(int(seed))
    draws = [static_channel_draws(config["chan_cfg"], dl.shape[1], fs_hz,
                                  gen)
             for _ in range(config["total_tests"])]
    rows = []
    for snr_db in config["snr_db_list"]:
        for test, (taps, noise) in enumerate(draws):
            model = chan_mod.NrChannelModel(config["chan_cfg"], -snr_db, 0.0,
                                            fs_hz, scs, device=dev)
            rx = model.filter(dl, taps=[t.to(dev).expand(dl.shape[1], -1, -1)
                                        for t in taps],
                              noise=noise.to(dev))
            _, rx_fd = rx_wf.waveform_rx_processing(rx, carrier, fs_hz)
            for idx in range(n_slots):
                sfn, slot = idx // spf, idx % spf
                if not reporter.is_valid_slot(sfn, slot):
                    continue
                rx_slot = rx_fd[:, idx * slot_size:(idx + 1) * slot_size]
                out = reporter.report(rx_slot, sfn, slot)
                rows.append(dict(snr_db=snr_db, test=test, sfn=sfn,
                                 slot=slot, RI=out["RI"], PMI=out["PMI"],
                                 CQI=out["CQI"],
                                 subband_CQI=out.get("subband_CQI"),
                                 rx_slot=rx_slot))
    return rows


def main(argv=None, config=None) -> list:
    """Command line: --device, --seed, --out-dir -> the rows of
    run_csirs_report (also written, without the grids, to
    <out-dir>/<config['filename']>)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; the CPU under "
                         "PY5G_FORCE_CPU=1)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the channel taps and the noise")
    ap.add_argument("--out-dir", default="out/torch")
    args = ap.parse_args(argv)
    config = config or example_config()
    rows = run_csirs_report(config, select_platform("sweep", args.device),
                            args.seed)
    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    reports = [{k: v for k, v in r.items() if k != "rx_slot"} for r in rows]
    with open(out_dir / config["filename"], "w") as f:
        json.dump(reports, f, indent=1, default=int)
    for r in reports:
        print(f"SNR {r['snr_db']:5.1f} dB test {r['test']} slot {r['slot']}: "
              f"RI={r['RI']} PMI={r['PMI']} CQI={r['CQI']} "
              f"subband_CQI={r['subband_CQI']}")
    return rows


if __name__ == "__main__":
    main()
