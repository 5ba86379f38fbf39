"""TX layer, grid (phy/pdsch.py:SlotBatchTx.tx_grid_batch: DMRS values,
grid composition): milliseconds a slot of the program's span tx.grid,
nested in the stage tx_waveform."""
SOURCE = "program_span"
UNIT = "ms"
MOVES = "sim_slots_per_s"


def read(run):
    return run.stage_ms_per_slot("tx.grid")
