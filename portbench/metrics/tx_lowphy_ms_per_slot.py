"""TX layer, low PHY (waveform/dl.py, waveform/ul.py, ops/ofdm.py,
ops/filters.py: OFDM, CP, slot phase and the channel FIR, or the fused
filters.tx_lowphy_duc): milliseconds a slot of the program's spans
low_phy and channel_filter together, nested in the stage tx_waveform.
Nothing where neither ran."""
SOURCE = "program_span"
UNIT = "ms"
MOVES = "sim_slots_per_s"


def read(run):
    parts = [v for v in (run.stage_ms_per_slot("low_phy"),
                         run.stage_ms_per_slot("channel_filter"))
             if v is not None]
    return sum(parts) if parts else None
