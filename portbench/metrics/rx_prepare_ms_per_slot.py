"""Batched RX, the core's inputs (phy/pdsch_rx.py:rx_process_batch and
rx_batch_prepare: the slots' DMRS sequences and the descrambling sign,
made on the host once per channel object and copied to the device, and
the core's lookup): milliseconds a slot of the program's span
rx.prepare, summed over the cell's equalizers."""
SOURCE = "program_span"
UNIT = "ms"
MOVES = "sim_slots_per_s"


def read(run):
    return run.stage_ms_per_slot("rx.prepare")
