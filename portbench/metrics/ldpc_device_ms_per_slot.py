"""Kernels: device milliseconds a slot of the port's min-sum LDPC
decoder (csrc/ldpc_minsum.cu, csrc/ldpc_minsum_packed.cu; kernels named
ldpc::decode_kernel / ldpc::decode_warp_kernel) in the traced
sub-window."""
SOURCE = "device_trace"
UNIT = "ms"
MOVES = "sim_slots_per_s"


def read(run):
    secs = run.device_seconds("ldpc::decode")
    if secs is None:
        return None
    return 1e3 * secs / run.trace_slots
