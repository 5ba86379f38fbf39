"""Batched RX, data-RE gathers (rx/batch_core.py: the data-RE copy,
rx/ce_batch.py:comp_data_batch TO/FO compensation, the per-symbol
data-RE selection and its cats): milliseconds a slot of the program's
span rx.gather, summed over the cell's equalizers."""
SOURCE = "program_span"
UNIT = "ms"
MOVES = "sim_slots_per_s"


def read(run):
    return run.stage_ms_per_slot("rx.gather")
