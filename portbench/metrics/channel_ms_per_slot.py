"""Channel layer (models/channel.py: fading taps, the tap sum, AWGN):
milliseconds a slot of the StageProfiler stage channel."""
SOURCE = "program_span"
UNIT = "ms"
MOVES = "sim_slots_per_s"


def read(run):
    return run.stage_ms_per_slot("channel")
