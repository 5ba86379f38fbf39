"""Batched RX, channel estimation (rx/batch_core.py:ls_estimate,
rx/ce_batch.py:channel_est_batch): milliseconds a slot of the program's
span rx.ce, summed over the cell's equalizers (one span each, nested in
rx_batch[<equalizer>])."""
SOURCE = "program_span"
UNIT = "ms"
MOVES = "sim_slots_per_s"


def read(run):
    return run.stage_ms_per_slot("rx.ce")
