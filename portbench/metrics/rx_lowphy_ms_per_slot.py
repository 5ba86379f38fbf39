"""RX front end (waveform/rx.py, ops/filters.py: channel FIR, FFT):
milliseconds a slot of the StageProfiler stage rx_lowphy."""
SOURCE = "program_span"
UNIT = "ms"
MOVES = "sim_slots_per_s"


def read(run):
    return run.stage_ms_per_slot("rx_lowphy")
