from portbench.reference.frozen.ops.ldpc.tables import (  # noqa: F401
    CBInfo, base_graph, find_ils, get_cbs_info, shift_table, ZLIST,
)
from portbench.reference.frozen.ops.ldpc.encode import (  # noqa: F401
    ldpc_encode, ldpc_encode_np,
)
from portbench.reference.frozen.ops.ldpc.ratematch import (  # noqa: F401
    get_er_ldpc, get_k0, ratematch_indices, ldpc_ratematch, ldpc_raterecover,
)
from portbench.reference.frozen.ops.ldpc.segment import (  # noqa: F401
    cb_segment, cb_segment_np, er_groups, sch_crc_bg, sch_plan,
)
from portbench.reference.frozen.ops.ldpc.decode import (  # noqa: F401
    ldpc_decode,
)
