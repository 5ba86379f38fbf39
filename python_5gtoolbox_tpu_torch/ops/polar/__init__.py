from python_5gtoolbox_tpu_torch.ops.polar.construct import (  # noqa: F401
    construct, gen_n_value)
from python_5gtoolbox_tpu_torch.ops.polar.interleave import (  # noqa: F401
    input_deinterleave_table, input_interleave_table)
from python_5gtoolbox_tpu_torch.ops.polar.encode import (  # noqa: F401
    polar_encode, polar_encode_np)
from python_5gtoolbox_tpu_torch.ops.polar.ratematch import (  # noqa: F401
    polar_ratematch, polar_raterecover, subblock_interleave_table,
    triangle_interleave_table)
from python_5gtoolbox_tpu_torch.ops.polar.decode import \
    polar_decode_scl  # noqa: F401
