"""Kernels, polar SCL: CUDA graphs of the SCL leaf loop captured a slot
(ops/polar/decode.py:_leaf_loop_cuda, the port's counter
polar_graph_captures, counted where a profiler is open), over the staged
sub-window. 0 once the warm point has captured every shape the window
decodes: a capture inside the window costs far more than a replay."""
SOURCE = "program_counter"
UNIT = "count"
MOVES = "sim_slots_per_s"


def read(run):
    return run.counter_per_slot("polar_graph_captures")
