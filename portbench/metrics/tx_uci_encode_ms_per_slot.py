"""TX layer, UCI coding (phy/pusch.py:NrPUSCH.encode_uci_rows: every
allocated slot's HARQ-ACK and CSI payloads coded at once, Reed-Muller
and polar): milliseconds a slot of the program's span tx.uci_encode,
nested in slot_grids."""
SOURCE = "program_span"
UNIT = "ms"
MOVES = "sim_slots_per_s"


def read(run):
    return run.stage_ms_per_slot("tx.uci_encode")
