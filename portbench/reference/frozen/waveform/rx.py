"""Receiver waveform processing: DDC + batched Rx low-PHY.

Frozen copy of the PyTorch port of python_5gtoolbox_tpu/waveform/rx.py (reference:
py5gphy/nr_lowphy/rx_lowphy_process.py:11-33).
"""
from __future__ import annotations

import torch

from portbench.reference.frozen.ops import filters, ofdm
from portbench.reference.frozen.utils import numerology as num


def waveform_rx_processing(rx_waveform: torch.Tensor, carrier_config: dict,
                           sample_rate_in_hz: float):
    """(ant, N) rx samples -> (td_waveform at carrier rate, fd_waveform
    (ant, n_slots*14*12*prb)), on the input's device."""
    scs, bw = carrier_config["scs"], carrier_config["BW"]
    fc_hz = int(carrier_config["carrier_frequency_in_mhz"] * 1e6)
    nfft = num.fft_size(num.carrier_prb_size(scs, bw))
    td = filters.rx_channel_filter(rx_waveform, scs, bw, sample_rate_in_hz)
    slot_samp = nfft * 15
    nant = td.shape[0]
    n_slots = td.shape[1] // slot_samp
    td = td[:, : n_slots * slot_samp]
    slots = td.reshape(nant, n_slots, slot_samp).transpose(0, 1)
    fd = ofdm.rx_low_phy(slots, scs, bw, fc_hz)          # (S, ant, 14, n_sc)
    return td, fd.transpose(0, 1).reshape(nant, -1)
