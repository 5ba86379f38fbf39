"""Batched RX, UCI small-block decode (rx/batch_core.py:
make_uci_decoder: rate recovery and the Reed-Muller ML decode of a
stream of up to 11 bits): milliseconds a slot of the program's span
rx.uci.smallblock, nested in rx.ratematch, summed over the cell's
equalizers and streams."""
SOURCE = "program_span"
UNIT = "ms"
MOVES = "sim_slots_per_s"


def read(run):
    return run.stage_ms_per_slot("rx.uci.smallblock")
