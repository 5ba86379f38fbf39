"""Device: operations launched on the card (kernels, copies, sets) per
slot in the traced sub-window."""
SOURCE = "device_trace"
UNIT = "count"
MOVES = "sim_slots_per_s"


def read(run):
    if not run.trace_slots:
        return None
    return len(run.device_events) / run.trace_slots
