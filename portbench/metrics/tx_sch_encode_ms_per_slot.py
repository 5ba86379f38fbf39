"""TX layer, transport-channel coding (phy/pdsch.py:SlotBatchTx.coded_bits,
ops/ldpc/encode.py, ops/ldpc/ratematch.py: TB CRC, segmentation, CB
CRC, LDPC encode, rate matching): milliseconds a slot of the program's
span tx.sch_encode, nested in the stage tx_waveform."""
SOURCE = "program_span"
UNIT = "ms"
MOVES = "sim_slots_per_s"


def read(run):
    return run.stage_ms_per_slot("tx.sch_encode")
