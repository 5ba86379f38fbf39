"""Downlink waveform orchestration.

Port of python_5gtoolbox_tpu/waveform/dl.py (gen_dl_waveform,
gen_dl_channel_list). Two branches, as in the JAX package:

* a single batch-capable PDSCH and no other channel: the PDSCH encodes
  and composes every slot grid at once (Pdsch.tx_grid_batch). Without
  timing-error injection the grid goes through filters.tx_lowphy_duc: at
  the carrier rate OFDM, slot phase and FIR; above it (samplerate_in_mhz
  245.76) the fused DUC kernel (duc_from_spec_planes for nfft >= 1024,
  fir_up2_fused_symbols below) and the remaining halfband stages. With a
  timing error Dm the OFDM modulation runs apart and
  filters.tx_channel_filter follows (fir_up2_fused above the carrier
  rate), as on the composed branch;
* anything else (SSB, CSI-RS, PDCCH, several PDSCHs: the test models):
  per slot, each channel's process() in the order SSB, CSI-RS, PDCCH,
  PDSCH writes into the slot's grid and RE-usage map, then
  ofdm.tx_low_phy (with the antenna roll), the slot phase and
  filters.tx_channel_filter over the whole frame. The frame grid is one
  tensor on the channels' device; the usage maps are host numpy arrays
  (the next channel reads them to find its free REs). The PDSCH's coded
  symbols never leave the device.

Every output is a tensor on the channels' device. Both branches count
the slot phase from startslot (the JAX composed branch counts from 0;
the two agree at startslot 0).
"""
from __future__ import annotations

import numpy as np
import torch

from python_5gtoolbox_tpu_torch import resolve_device
from python_5gtoolbox_tpu_torch.ops import filters, ofdm
from python_5gtoolbox_tpu_torch.phy.csirs import NrCSIRS
from python_5gtoolbox_tpu_torch.phy.pdcch import NrSearchSpace, Pdcch
from python_5gtoolbox_tpu_torch.phy.pdsch import Pdsch
from python_5gtoolbox_tpu_torch.phy.ssb import NrSSB
from python_5gtoolbox_tpu_torch.utils import numerology as num
from python_5gtoolbox_tpu_torch.utils.profiling import span


def gen_dl_waveform(waveform_config: dict, carrier_config: dict,
                    nrSSB_list=(), nrPdsch_list=(), nrCSIRS_list=(),
                    nrPDCCH_list=(), Dm: np.ndarray | None = None,
                    trblks=None, prof=None, device=None):
    """-> (fd_waveform, td_waveform, dl_waveform, td_sample_rate_hz), all
    tensors on the channels' device.

    Shapes match the reference: fd (ant, S*14*12*prb), td (ant,
    S*15*nfft) or None, dl at waveform_config["samplerate_in_mhz"]. On the
    single-PDSCH branch without timing-error injection (Dm all zero) the
    antenna roll is folded into the grid and td is not produced, as on the
    JAX device path; the composed branch returns td. trblks (Sa, TBSize)
    is handed to Pdsch.tx_grid_batch (single-PDSCH branch only). The
    composed branch works on the first PDSCH's or SSB's device; device
    (None -> cuda) is where it works when there is neither (CSI-RS and
    PDCCH carry no device). prof: optional stage timer (an object whose
    stage(name) is a context manager; None: spans of the active
    utils.profiling profiler, if one is open) charged with the composed
    branch's slot_grids (every channel's process), low_phy (OFDM and slot
    phase; on the single-PDSCH branch without Dm, the fused
    filters.tx_lowphy_duc) and channel_filter stages.
    """
    n_slots = waveform_config["numofslots"]
    start_slot = waveform_config["startslot"]
    out_rate_hz = waveform_config["samplerate_in_mhz"] * 1e6
    nant = carrier_config["num_of_ant"]
    fc_hz = int(carrier_config["carrier_frequency_in_mhz"] * 1e6)
    scs, bw = carrier_config["scs"], carrier_config["BW"]
    prb = num.carrier_prb_size(scs, bw)
    nfft = num.fft_size(prb)
    spf = num.slots_per_frame(scs)
    slots = [(start_slot + idx) % spf for idx in range(n_slots)]
    no_dm = Dm is None or not np.any(np.asarray(Dm))

    stage = span if prof is None else prof.stage
    single = (len(nrPdsch_list) == 1 and not nrSSB_list and not nrCSIRS_list
              and not nrPDCCH_list and nrPdsch_list[0].tx_batch_supported())
    if single:
        pdsch = nrPdsch_list[0]
        if no_dm:
            roll = nant // 2 if nant > 1 else 0
            fd = pdsch.tx_grid_batch(slots, roll_ant=roll, trblks=trblks)
            with stage("low_phy"):
                dl = filters.tx_lowphy_duc(fd.transpose(0, 1), scs, bw,
                                           fc_hz, out_rate_hz,
                                           slot_phase=True,
                                           start_slot=start_slot)
            if roll:
                fd = torch.roll(fd, roll, dims=1)   # fd is the unrolled grid
            return (fd.transpose(0, 1).reshape(nant, -1), None, dl,
                    nfft * scs * 1000)
        fd = pdsch.tx_grid_batch(slots, trblks=trblks)
    else:
        if trblks is not None:
            raise ValueError("trblks= needs a single batch-capable PDSCH "
                             "and no other channel")
        device = resolve_device(next(
            (ch.device for ch in (*nrPdsch_list, *nrSSB_list)), device))
        with stage("slot_grids"):
            fd = _per_slot_grids(waveform_config, nant, 12 * prb, spf,
                                 nrSSB_list, nrPdsch_list, nrCSIRS_list,
                                 nrPDCCH_list, device)
    with stage("low_phy"):
        dm = None if no_dm else torch.as_tensor(np.asarray(Dm),
                                                device=fd.device)
        td = ofdm.tx_low_phy(fd, scs, bw, fc_hz, dm=dm)
        ph = ofdm._slot_phase_const(scs, fc_hz, n_slots, start_slot)
        td = td * torch.as_tensor(ph, device=fd.device)[:, None, None]
        td_flat = td.transpose(0, 1).reshape(nant, -1)
    with stage("channel_filter"):
        dl = filters.tx_channel_filter(td_flat, scs, bw, out_rate_hz)
    return (fd.transpose(0, 1).reshape(nant, -1), td_flat, dl,
            nfft * scs * 1000)


def _per_slot_grids(waveform_config, nant, n_sc, spf, nrSSB_list,
                    nrPdsch_list, nrCSIRS_list, nrPDCCH_list, device
                    ) -> torch.Tensor:
    """Every channel's process() slot by slot (SSB, CSI-RS, PDCCH, PDSCH)
    into one frame grid -> (S, ant, 14, n_sc) complex64 on device."""
    n_slots = waveform_config["numofslots"]
    start_sfn = waveform_config["startSFN"]
    start_slot = waveform_config["startslot"]
    grids = torch.zeros((n_slots, nant, 14 * n_sc), dtype=torch.complex64,
                        device=device)
    usages = np.zeros((n_slots, nant, 14 * n_sc), np.int8)
    for idx in range(n_slots):
        sfn = start_sfn + (start_slot + idx) // spf
        slot = (start_slot + idx) % spf
        fd, use = grids[idx], usages[idx]
        for ch in (*nrSSB_list, *nrCSIRS_list, *nrPDCCH_list):
            ch.process(fd, use, sfn, slot)
        for ch in nrPdsch_list:
            ch.process(fd, use, slot)
    return grids.reshape(n_slots, nant, 14, n_sc)


def gen_dl_channel_list(waveform_config, carrier_config, ssb_config=None,
                        pdcch_config_list=(), search_space_list=(),
                        coreset_config_list=(), csirs_config_list=(),
                        pdsch_config_list=(), seed: int = 0, device=None):
    """Instantiate the enabled DL channel objects from configs ->
    (nrSSB_list, nrPdsch_list, nrCSIRS_list, nrPDCCH_list).

    Reference parity: nr_dl_waveform.py:110-201. `enable` flags
    are the strings "True"/"False" as in the reference configs. Each
    PDSCH and PDCCH draws its random payloads (data_source []) from its
    own numpy Generator, seeded with (seed, 0, k) for the k-th PDSCH and
    (seed, 1, k) for the k-th PDCCH. device (None -> cuda) is where the
    PDSCHs encode and the SSB's standalone waveform runs.
    """
    device = resolve_device(device)
    ssb_list = []
    if ssb_config and ssb_config["enable"] == "True":
        ssb_list.append(NrSSB(carrier_config, ssb_config, device=device))
    pdsch_list = [Pdsch(c, carrier_config,
                        rng=np.random.default_rng((seed, 0, k)),
                        device=device)
                  for k, c in enumerate(c for c in pdsch_config_list
                                        if c["enable"] == "True")]
    csirs_list = [NrCSIRS(carrier_config, c) for c in csirs_config_list
                  if c["enable"] == "True"]
    ss_list = []
    for ss_cfg in search_space_list:
        if ss_cfg["enable"] != "True":
            continue
        cs = [c for c in coreset_config_list
              if c["coreset_id"] == ss_cfg["controlResourceSetId"]]
        assert cs, "search space references a missing coreset"
        ss_list.append(NrSearchSpace(carrier_config, ss_cfg, cs[0]))
    pdcch_list = []
    for cfg in pdcch_config_list:
        if cfg["enable"] != "True":
            continue
        sel = [s for s in ss_list
               if s.search_space_config["controlResourceSetId"]
               == cfg["searchSpaceId"]]
        assert sel, "PDCCH references a missing search space"
        pdcch_list.append(Pdcch(cfg, sel[0], rng=np.random.default_rng(
            (seed, 1, len(pdcch_list)))))
    return ssb_list, pdsch_list, csirs_list, pdcch_list
