"""The training LSTM stack's share of its roofline: the least time of the
stack's forward and backward work over the stretch's windows
(`work.lstm_flops`, `work.lstm_bytes`: real nodes) over the device time of
the operations the LSTM ops launched (family `lstm`)."""

from portbench import work
from portbench.metrics import family_roofline

LAYER = "LSTM kernels: ops/fused_lstm_stack.py"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_windows_per_s"


def read(ctx):
    return family_roofline(ctx, "train", "lstm", lambda m, n, k, b: work.lstm_flops(m, n, b),
                           lambda m, n, k, b: work.lstm_bytes(m, n, b))
