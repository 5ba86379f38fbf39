"""TX layer, per-slot grids (waveform/ul.py:_per_slot_grids: every
channel's process() slot by slot, which UCI on the PUSCH forces, its UCI
coded beforehand): milliseconds a slot of the program's span slot_grids,
nested in the stage tx_waveform."""
SOURCE = "program_span"
UNIT = "ms"
MOVES = "sim_slots_per_s"


def read(run):
    return run.stage_ms_per_slot("slot_grids")
