"""Downlink waveform of one slot-batched PDSCH (frozen copy).

A frozen copy of the single-PDSCH branch of the port's waveform/dl.py
without a timing error: every slot grid encoded at once, the antenna
roll folded into the grid, then OFDM, slot phase and the channel FIR at
the carrier rate.
"""
from __future__ import annotations

import torch

from portbench.reference.frozen.ops import filters
from portbench.reference.frozen.utils import numerology as num


def gen_dl_waveform(waveform_config: dict, carrier_config: dict, pdsch,
                    trblks=None) -> torch.Tensor:
    """-> the (ant, S * slot_samples) complex64 waveform at the carrier
    rate of pdsch's slots, trblks (Sa, TBSize) sent in them."""
    n_slots = waveform_config["numofslots"]
    start_slot = waveform_config["startslot"]
    out_rate_hz = waveform_config["samplerate_in_mhz"] * 1e6
    nant = carrier_config["num_of_ant"]
    fc_hz = int(carrier_config["carrier_frequency_in_mhz"] * 1e6)
    scs, bw = carrier_config["scs"], carrier_config["BW"]
    spf = num.slots_per_frame(scs)
    slots = [(start_slot + idx) % spf for idx in range(n_slots)]
    if not pdsch.tx_batch_supported():
        raise ValueError("the frozen reference runs the slot-batched TX only")
    roll = nant // 2 if nant > 1 else 0
    fd = pdsch.tx_grid_batch(slots, roll_ant=roll, trblks=trblks)
    return filters.tx_lowphy_duc(fd.transpose(0, 1), scs, bw, fc_hz,
                                 out_rate_hz, slot_phase=True,
                                 start_slot=start_slot)
