"""Downlink waveform orchestration, single-PDSCH path.

Port of the single-PDSCH fast path of python_5gtoolbox_tpu/waveform/dl.py
(gen_dl_waveform, waveform/dl.py:66-88 and the composed path below it):
the PDSCH encodes and composes every slot grid at once
(Pdsch.tx_grid_batch). Without timing-error injection the grid goes
through filters.tx_lowphy_duc: at the carrier rate OFDM, slot phase and
FIR; above it (samplerate_in_mhz 245.76) the fused DUC kernel
(duc_from_spec_planes for nfft >= 1024, fir_up2_fused_symbols below) and
the remaining halfband stages. With a timing error Dm the OFDM
modulation runs apart and filters.tx_channel_filter (fir_up2_fused above
the carrier rate) follows. Multi-channel waveforms (SSB, CSI-RS, PDCCH)
are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from python_5gtoolbox_tpu_torch.ops import filters, ofdm
from python_5gtoolbox_tpu_torch.utils import numerology as num


def gen_dl_waveform(waveform_config: dict, carrier_config: dict,
                    nrPdsch_list=(), Dm: np.ndarray | None = None,
                    trblks=None):
    """-> (fd_waveform, td_waveform, dl_waveform, td_sample_rate_hz), all
    tensors on the PDSCH's device.

    Shapes match the reference: fd (ant, S*14*12*prb), td (ant,
    S*15*nfft) or None, dl at waveform_config["samplerate_in_mhz"].
    Without timing-error injection (Dm all zero) the antenna roll is
    folded into the grid and td is not produced, as on the JAX device
    path. trblks is handed to Pdsch.tx_grid_batch.
    """
    if len(nrPdsch_list) != 1 or not nrPdsch_list[0].tx_batch_supported():
        raise NotImplementedError("only the single batch-capable PDSCH "
                                  "waveform is ported")
    pdsch = nrPdsch_list[0]
    n_slots = waveform_config["numofslots"]
    start_slot = waveform_config["startslot"]
    out_rate_hz = waveform_config["samplerate_in_mhz"] * 1e6
    nant = carrier_config["num_of_ant"]
    fc_hz = int(carrier_config["carrier_frequency_in_mhz"] * 1e6)
    scs, bw = carrier_config["scs"], carrier_config["BW"]
    nfft = num.fft_size(num.carrier_prb_size(scs, bw))
    spf = num.slots_per_frame(scs)
    slots = [(start_slot + idx) % spf for idx in range(n_slots)]

    if Dm is None or not np.any(np.asarray(Dm)):
        roll = nant // 2 if nant > 1 else 0
        fd = pdsch.tx_grid_batch(slots, roll_ant=roll, trblks=trblks)
        dl = filters.tx_lowphy_duc(fd.transpose(0, 1), scs, bw, fc_hz,
                                   out_rate_hz, slot_phase=True,
                                   start_slot=start_slot)
        if roll:
            fd = torch.roll(fd, roll, dims=1)   # fd is the unrolled grid
        return (fd.transpose(0, 1).reshape(nant, -1), None, dl,
                nfft * scs * 1000)

    fd = pdsch.tx_grid_batch(slots, trblks=trblks)
    td = ofdm.tx_low_phy(fd, scs, bw, fc_hz,
                         dm=torch.as_tensor(np.asarray(Dm), device=fd.device))
    ph = ofdm._slot_phase_const(scs, fc_hz, n_slots, start_slot)
    td = td * torch.as_tensor(ph, device=fd.device)[:, None, None]
    td_flat = td.transpose(0, 1).reshape(nant, -1)
    dl = filters.tx_channel_filter(td_flat, scs, bw, out_rate_hz)
    return (fd.transpose(0, 1).reshape(nant, -1), td_flat, dl,
            nfft * scs * 1000)
