"""Device: the share of the traced sub-window in which no operation ran
on the card (kernels, copies and sets, overlaps counted once)."""
SOURCE = "device_trace"
UNIT = "%"
MOVES = "sim_slots_per_s"


def read(run):
    if not run.trace_window_s:
        return None
    return 100.0 * (1.0 - run.busy_s / run.trace_window_s)
