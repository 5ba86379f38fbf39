"""Uplink waveform orchestration, single-PUSCH path.

Port of the single-PUSCH fast path of python_5gtoolbox_tpu/waveform/ul.py
(gen_ul_waveform, waveform/ul.py:20-94): the PUSCH encodes and composes
every slot grid at once (NrPUSCH.tx_grid_batch). return_device picks the
branch as in the JAX package: True runs filters.tx_lowphy_duc with the
antenna roll folded into the precoder and the slot phase before the IFFT
(the spectrum DUC kernel duc_from_spec above the carrier rate, nfft >=
1024), and gives no td; False runs ofdm.tx_low_phy, the slot phase and
filters.tx_channel_filter (fir_up2_fused above the carrier rate) and
returns td. Every output is a tensor on the PUSCH's device either way.
Both branches count the slot phase from startslot, as the port's
gen_dl_waveform does (the JAX package's td branch counts from 0).
SRS and PUCCH formats 0-4 (Queue A item 5) are not ported.
"""
from __future__ import annotations

import torch

from python_5gtoolbox_tpu_torch.ops import filters, ofdm
from python_5gtoolbox_tpu_torch.utils import numerology as num


def gen_ul_waveform(waveform_config: dict, carrier_config: dict,
                    nrPusch_list=(), nrSrs_list=(),
                    nrPucchFormat0_list=(), nrPucchFormat1_list=(),
                    nrPucchFormat2_list=(), nrPucchFormat3_list=(),
                    nrPucchFormat4_list=(), return_device: bool = False,
                    trblks=None):
    """-> (fd_waveform, td_waveform, ul_waveform), tensors on the PUSCH's
    device: fd (ant, S*14*12*prb), td (ant, S*slot_samples) or None
    (return_device=True), ul at waveform_config["samplerate_in_mhz"].
    trblks is handed to NrPUSCH.tx_grid_batch."""
    others = (nrSrs_list, nrPucchFormat0_list, nrPucchFormat1_list,
              nrPucchFormat2_list, nrPucchFormat3_list, nrPucchFormat4_list)
    if len(nrPusch_list) != 1 or any(others) \
            or not nrPusch_list[0].tx_batch_supported():
        raise NotImplementedError("only the single batch-capable PUSCH "
                                  "waveform is ported")
    pusch = nrPusch_list[0]
    n_slots = waveform_config["numofslots"]
    start_slot = waveform_config["startslot"]
    out_rate_hz = waveform_config["samplerate_in_mhz"] * 1e6
    nant = carrier_config["num_of_ant"]
    fc_hz = int(carrier_config["carrier_frequency_in_mhz"] * 1e6)
    scs, bw = carrier_config["scs"], carrier_config["BW"]
    spf = num.slots_per_frame(scs)
    slots = [(start_slot + idx) % spf for idx in range(n_slots)]

    if return_device:
        roll = nant // 2 if nant > 1 else 0
        fd = pusch.tx_grid_batch(slots, roll_ant=roll, trblks=trblks)
        ul = filters.tx_lowphy_duc(fd.transpose(0, 1), scs, bw, fc_hz,
                                   out_rate_hz, slot_phase=True,
                                   start_slot=start_slot)
        if roll:
            fd = torch.roll(fd, roll, dims=1)   # fd is the unrolled grid
        return fd.transpose(0, 1).reshape(nant, -1), None, ul

    fd = pusch.tx_grid_batch(slots, trblks=trblks)
    td = ofdm.tx_low_phy(fd, scs, bw, fc_hz)
    ph = ofdm._slot_phase_const(scs, fc_hz, n_slots, start_slot)
    td = td * torch.as_tensor(ph, device=fd.device)[:, None, None]
    td_flat = td.transpose(0, 1).reshape(nant, -1)
    ul = filters.tx_channel_filter(td_flat, scs, bw, out_rate_hz)
    return fd.transpose(0, 1).reshape(nant, -1), td_flat, ul
