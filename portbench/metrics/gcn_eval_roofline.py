"""The eval GCN stack's share of its roofline (row 1): the least time of
the encoder's forward over the stretch's windows over the device time of
the operations the GCN ops launched (family `gcn`)."""

from portbench import work
from portbench.metrics import family_roofline

LAYER = "GCN kernels: ops/fused_gcn_train.py, ops/fused_gcn.py"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "predict_p95_ms"


def read(ctx):
    return family_roofline(ctx, "predict", "gcn", work.gcn_flops, work.gcn_bytes)
