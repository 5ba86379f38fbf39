"""Batched RX, UCI polar decode (rx/batch_core.py:make_uci_decoder:
polar rate recovery and the CA-SCL decoder, list 8, a CUDA graph on the
card): milliseconds a slot of the program's span rx.uci.polar, nested in
rx.ratematch, summed over the cell's equalizers and streams."""
SOURCE = "program_span"
UNIT = "ms"
MOVES = "sim_slots_per_s"


def read(run):
    return run.stage_ms_per_slot("rx.uci.polar")
