"""Batched RX, decode (ops/ldpc/decode.py:ldpc_decode and its kernels,
ops/crc.py: LDPC decode and the TB CRC check): milliseconds a slot of
the program's span rx.ldpc, summed over the cell's equalizers. A span on
the stream, so it holds the host's time around the kernel as well;
ldpc_device_ms_per_slot reads the kernel alone."""
SOURCE = "program_span"
UNIT = "ms"
MOVES = "sim_slots_per_s"


def read(run):
    return run.stage_ms_per_slot("rx.ldpc")
