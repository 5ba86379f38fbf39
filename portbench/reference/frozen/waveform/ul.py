"""Uplink waveform of one slot-batched PUSCH (frozen copy).

A frozen copy of the single-PUSCH branch of the port's waveform/ul.py
(return_device=True): every slot grid encoded at once, the antenna roll
folded into the grid, then OFDM, slot phase and the channel FIR at the
carrier rate.
"""
from __future__ import annotations

import torch

from portbench.reference.frozen.ops import filters
from portbench.reference.frozen.utils import numerology as num


def gen_ul_waveform(waveform_config: dict, carrier_config: dict, pusch,
                    trblks=None) -> torch.Tensor:
    """-> the (ant, S * slot_samples) complex64 waveform at the carrier
    rate of pusch's slots, trblks (Sa, TBSize) sent in them."""
    n_slots = waveform_config["numofslots"]
    start_slot = waveform_config["startslot"]
    out_rate_hz = waveform_config["samplerate_in_mhz"] * 1e6
    nant = carrier_config["num_of_ant"]
    fc_hz = int(carrier_config["carrier_frequency_in_mhz"] * 1e6)
    scs, bw = carrier_config["scs"], carrier_config["BW"]
    spf = num.slots_per_frame(scs)
    slots = [(start_slot + idx) % spf for idx in range(n_slots)]
    if not pusch.tx_batch_supported():
        raise ValueError("the frozen reference runs the slot-batched TX only")
    roll = nant // 2 if nant > 1 else 0
    fd = pusch.tx_grid_batch(slots, roll_ant=roll, trblks=trblks)
    return filters.tx_lowphy_duc(fd.transpose(0, 1), scs, bw, fc_hz,
                                 out_rate_hz, slot_phase=True,
                                 start_slot=start_slot)
