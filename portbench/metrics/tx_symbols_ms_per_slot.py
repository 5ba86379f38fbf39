"""TX layer, symbols (phy/pdsch.py:pdsch_symbol_encode,
phy/pusch.py:pusch_symbol_encode: scrambling, modulation, layer mapping,
precoding, transform precoding): milliseconds a slot of the program's
span tx.symbols, nested in the stage tx_waveform."""
SOURCE = "program_span"
UNIT = "ms"
MOVES = "sim_slots_per_s"


def read(run):
    return run.stage_ms_per_slot("tx.symbols")
