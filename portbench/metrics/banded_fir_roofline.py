"""Kernels: banded_fir's share of its roofline (csrc/banded_fir.cu,
ops/filters.py). The least time of the launches a point makes (the TX
channel FIR on 2 x Nt planes and the RX one on 2 x Nr planes, 'same',
slots x samples a slot long, the configuration's FIR taps; counted by
bounds.banded_fir_work, bounded by bounds.least_seconds against the
H100's published peaks) over the device time of the banded_fir_kernel
launches in the traced sub-window. Nothing is read where the launches
are not the two a point is expected to make."""
from portbench import bounds

SOURCE = "device_trace"
UNIT = "%"
MOVES = "sim_slots_per_s"


def read(run):
    launches = [(a, b) for name, a, b in run.device_events
                if "banded_fir_kernel" in name]
    shapes = run.fir_shapes
    if not launches or len(launches) != len(shapes) * run.trace_points:
        return None
    least = sum(bounds.least_seconds(*bounds.banded_fir_work(*s))[0]
                for s in shapes) * run.trace_points
    spent = sum(b - a for a, b in launches) / 1e6
    return 100.0 * least / spent
