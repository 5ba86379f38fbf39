"""Slot-batched RX (phy/pdsch_rx.py, phy/pusch_rx.py, rx/batch_core.py,
rx/ce_batch.py, rx/equalize.py, rx/demod.py): milliseconds a slot of
the StageProfiler stages rx_batch[<equalizer>], summed over the cell's
equalizers."""
SOURCE = "program_span"
UNIT = "ms"
MOVES = "sim_slots_per_s"


def read(run):
    return run.stage_ms_per_slot("rx_batch")
