"""Kernels, LDPC decode: iterations the card's LDPC kernels ran a slot,
summed over the codewords of every equalizer's decode (the port's
counter ldpc_iterations, rx/batch_core.py, counted inside rx.ldpc where
a profiler is open and the card decodes), over the staged sub-window.
The count that an LDPC roofline divides by."""
SOURCE = "program_counter"
UNIT = "count"
MOVES = "sim_slots_per_s"


def read(run):
    return run.counter_per_slot("ldpc_iterations")
