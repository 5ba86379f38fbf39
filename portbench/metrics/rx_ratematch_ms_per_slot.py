"""Batched RX, rate recovery (rx/batch_core.py, ops/ldpc/ratematch.py:
UCI demultiplexing, de-rate-matching by Er group, HARQ combining):
milliseconds a slot of the program's span rx.ratematch, summed over the
cell's equalizers."""
SOURCE = "program_span"
UNIT = "ms"
MOVES = "sim_slots_per_s"


def read(run):
    return run.stage_ms_per_slot("rx.ratematch")
