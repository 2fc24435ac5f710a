"""The training GCN stack's share of its roofline: the least time of the
encoder's forward and backward work over the stretch's windows
(`work.gcn_flops`, `work.gcn_bytes`: real nodes, sparse aggregation) over
the device time of the operations the GCN ops launched (family `gcn`)."""

from portbench import work
from portbench.metrics import family_roofline

LAYER = "GCN kernels: ops/fused_gcn_train.py, ops/fused_gcn.py"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_windows_per_s"


def read(ctx):
    return family_roofline(ctx, "train", "gcn", work.gcn_flops, work.gcn_bytes)
