"""TX layer (phy/pdsch.py, phy/pusch.py, waveform/dl.py, waveform/ul.py,
ops/ofdm.py, ops/ldpc/encode.py): milliseconds a slot of the program's
StageProfiler stage tx_waveform, a CUDA-event span on the stream that
also holds the stream's waits for the host."""
SOURCE = "program_span"
UNIT = "ms"
MOVES = "sim_slots_per_s"


def read(run):
    return run.stage_ms_per_slot("tx_waveform")
