"""Uplink waveform orchestration.

Port of python_5gtoolbox_tpu/waveform/ul.py (gen_ul_waveform,
gen_ul_channel_list). Two branches, as in the JAX package:

* a single batch-capable PUSCH (UL-SCH only, NrPUSCH.tx_batch_supported)
  and no other channel encodes and composes every slot grid at once
  (tx_grid_batch). return_device picks the back end: True runs
  filters.tx_lowphy_duc with the antenna roll folded into the precoder
  and the slot phase before the IFFT (the spectrum DUC kernel
  duc_from_spec above the carrier rate, nfft >= 1024) and gives no td;
  False runs ofdm.tx_low_phy, the slot phase and
  filters.tx_channel_filter (fir_up2_fused above the carrier rate) and
  returns td;
* any other list (UCI on PUSCH, several PUSCHs, PUCCH formats 0-4, SRS,
  with or without a PUSCH): per slot, each channel's process() in the
  order PUSCH, PUCCH formats 0-4, SRS (a PUSCH's UCI payloads drawn per
  slot coded beforehand, all slots at once) writes into the slot's grid and
  RE-usage map, then ofdm.tx_low_phy, the slot phase and
  filters.tx_channel_filter over the whole frame; td is returned
  whatever return_device says. As on the DL (waveform/dl.py), the frame
  grid is one tensor on the channels' device and the usage maps are host
  numpy arrays, so no channel reads the device to find its REs; the
  PUSCH's coded symbols never leave the device.

Every output is a tensor on the channels' device. Every branch counts
the slot phase from startslot, as the port's gen_dl_waveform does (the
JAX package's composed branches count from 0; the two agree at
startslot 0).
"""
from __future__ import annotations

import numpy as np
import torch

from python_5gtoolbox_tpu_torch import resolve_device
from python_5gtoolbox_tpu_torch.ops import filters, ofdm
from python_5gtoolbox_tpu_torch.phy.pucch import (
    NrPUCCHFormat0, NrPUCCHFormat1, NrPUCCHFormat2, NrPUCCHFormat3,
    NrPUCCHFormat4)
from python_5gtoolbox_tpu_torch.phy.pusch import NrPUSCH
from python_5gtoolbox_tpu_torch.phy.srs import NrSRS
from python_5gtoolbox_tpu_torch.utils import numerology as num
from python_5gtoolbox_tpu_torch.utils.profiling import span


def gen_ul_waveform(waveform_config: dict, carrier_config: dict,
                    nrPusch_list=(), nrSrs_list=(),
                    nrPucchFormat0_list=(), nrPucchFormat1_list=(),
                    nrPucchFormat2_list=(), nrPucchFormat3_list=(),
                    nrPucchFormat4_list=(), return_device: bool = False,
                    trblks=None, prof=None):
    """-> (fd_waveform, td_waveform, ul_waveform), tensors on the
    channels' device (the first PUSCH's, else the first PUCCH's or SRS's,
    else cuda): fd (ant, S*14*12*prb), td (ant, S*slot_samples) or None
    (batched branch with return_device=True), ul at
    waveform_config["samplerate_in_mhz"]. trblks (Sa, TBSize), one row
    per allocated slot, replaces the drawn blocks (a single PUSCH only).
    prof: optional stage timer (an object whose stage(name) is a context
    manager; None: spans of the active utils.profiling profiler, if one
    is open) charged with the composed branch's slot_grids (every
    channel's process), low_phy (OFDM and slot phase; on the batched
    branch with return_device, the fused filters.tx_lowphy_duc) and
    channel_filter stages, as gen_dl_waveform's."""
    pucch_lists = (nrPucchFormat0_list, nrPucchFormat1_list,
                   nrPucchFormat2_list, nrPucchFormat3_list,
                   nrPucchFormat4_list)
    n_slots = waveform_config["numofslots"]
    start_slot = waveform_config["startslot"]
    out_rate_hz = waveform_config["samplerate_in_mhz"] * 1e6
    nant = carrier_config["num_of_ant"]
    fc_hz = int(carrier_config["carrier_frequency_in_mhz"] * 1e6)
    scs, bw = carrier_config["scs"], carrier_config["BW"]
    spf = num.slots_per_frame(scs)
    slots = [(start_slot + idx) % spf for idx in range(n_slots)]

    stage = span if prof is None else prof.stage
    single = (len(nrPusch_list) == 1 and not nrSrs_list
              and not any(pucch_lists)
              and nrPusch_list[0].tx_batch_supported())
    if single:
        pusch = nrPusch_list[0]
        if return_device:
            roll = nant // 2 if nant > 1 else 0
            fd = pusch.tx_grid_batch(slots, roll_ant=roll, trblks=trblks)
            with stage("low_phy"):
                ul = filters.tx_lowphy_duc(fd.transpose(0, 1), scs, bw,
                                           fc_hz, out_rate_hz,
                                           slot_phase=True,
                                           start_slot=start_slot)
            if roll:
                fd = torch.roll(fd, roll, dims=1)  # fd is the unrolled grid
            return fd.transpose(0, 1).reshape(nant, -1), None, ul
        fd = pusch.tx_grid_batch(slots, trblks=trblks)
    else:
        if trblks is not None and len(nrPusch_list) != 1:
            raise ValueError("trblks= needs a single PUSCH")
        pucchs = [ch for group in pucch_lists for ch in group]
        device = resolve_device(next(
            (ch.device for ch in (*nrPusch_list, *pucchs, *nrSrs_list)),
            None))
        with stage("slot_grids"):
            fd = _per_slot_grids(waveform_config, nant,
                                 12 * num.carrier_prb_size(scs, bw), spf,
                                 nrPusch_list, pucchs, nrSrs_list, device,
                                 trblks)
    with stage("low_phy"):
        td = ofdm.tx_low_phy(fd, scs, bw, fc_hz)
        ph = ofdm._slot_phase_const(scs, fc_hz, n_slots, start_slot)
        td = td * torch.as_tensor(ph, device=fd.device)[:, None, None]
        td_flat = td.transpose(0, 1).reshape(nant, -1)
    with stage("channel_filter"):
        ul = filters.tx_channel_filter(td_flat, scs, bw, out_rate_hz)
    return fd.transpose(0, 1).reshape(nant, -1), td_flat, ul


def _per_slot_grids(waveform_config, nant, n_sc, spf, nrPusch_list, pucchs,
                    nrSrs_list, device, trblks=None) -> torch.Tensor:
    """Every channel's process() slot by slot (PUSCHs, PUCCH formats 0-4,
    SRS) into one frame grid -> (S, ant, 14, n_sc) complex64 on device;
    the RE-usage maps stay on the host. A PUSCH whose uci_bits are set
    (UCI payloads drawn per slot) has them coded first, one row per
    allocated slot (NrPUSCH.encode_uci_rows)."""
    n_slots = waveform_config["numofslots"]
    start_sfn = waveform_config["startSFN"]
    start_slot = waveform_config["startslot"]
    grids = torch.zeros((n_slots, nant, 14 * n_sc), dtype=torch.complex64,
                        device=device)
    usages = np.zeros((n_slots, nant, 14 * n_sc), np.int8)
    rows = None if trblks is None else iter(trblks)
    ucis = [iter(ch.encode_uci_rows()) if ch.uci_bits else None
            for ch in nrPusch_list]
    for idx in range(n_slots):
        sfn = start_sfn + (start_slot + idx) // spf
        slot = (start_slot + idx) % spf
        fd, use = grids[idx], usages[idx]
        for ch, uci in zip(nrPusch_list, ucis):
            allocated = ch.is_active_slot(slot)
            trblk = next(rows) if rows is not None and allocated else None
            ch.process(fd, use, slot, trblk=trblk,
                       uci=next(uci) if uci is not None and allocated
                       else None)
        for ch in (*pucchs, *nrSrs_list):
            ch.process(fd, use, sfn, slot)
    return grids.reshape(n_slots, nant, 14, n_sc)


def gen_ul_channel_list(waveform_config, carrier_config,
                        pusch_config_list=(), srs_config_list=(),
                        pucch_format0_config_list=(),
                        pucch_format1_config_list=(),
                        pucch_format2_config_list=(),
                        pucch_format3_config_list=(),
                        pucch_format4_config_list=(), seed: int = 0,
                        device=None):
    """Instantiate the enabled UL channel objects from configs ->
    (nrPusch_list, nrSrs_list, nrPucchFormat0_list, ...,
    nrPucchFormat4_list), the order gen_ul_waveform takes them in.

    Reference parity: nr_ul_waveform.py:105-170 (`enable` is the string
    "True"/"False"). The k-th PUSCH draws its random transport blocks
    (data_source []) from a numpy Generator seeded with (seed, 0, k).
    device (None -> cuda) is where the channels' grids are built and the
    PUSCHs encode."""
    device = resolve_device(device)

    def enabled(cfgs):
        return [c for c in cfgs if c["enable"] == "True"]

    pusch = [NrPUSCH(carrier_config, c,
                     rng=np.random.default_rng((seed, 0, k)), device=device)
             for k, c in enumerate(enabled(pusch_config_list))]
    srs = [NrSRS(carrier_config, c, device=device)
           for c in enabled(srs_config_list)]
    pucch = [[cls(carrier_config, c, device=device) for c in enabled(cfgs)]
             for cls, cfgs in ((NrPUCCHFormat0, pucch_format0_config_list),
                               (NrPUCCHFormat1, pucch_format1_config_list),
                               (NrPUCCHFormat2, pucch_format2_config_list),
                               (NrPUCCHFormat3, pucch_format3_config_list),
                               (NrPUCCHFormat4, pucch_format4_config_list))]
    return (pusch, srs, *pucch)
