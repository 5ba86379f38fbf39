"""Batched RX, equalizer (rx/equalize.py, rx/demod.py: the equalizer and
its LLRs, linear or ML, and the descrambling): milliseconds a slot of
the program's span rx.equalize, summed over the cell's equalizers."""
SOURCE = "program_span"
UNIT = "ms"
MOVES = "sim_slots_per_s"


def read(run):
    return run.stage_ms_per_slot("rx.equalize")
