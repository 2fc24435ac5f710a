"""The eval LSTM stack's share of its roofline (row 2, `eval_forward`):
the least time of the stack's forward over the stretch's windows over the
device time of the operations the LSTM ops launched (family `lstm`)."""

from portbench import work
from portbench.metrics import family_roofline

LAYER = "LSTM kernels: ops/fused_lstm_stack.py"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "predict_p95_ms"


def read(ctx):
    return family_roofline(ctx, "predict", "lstm", lambda m, n, k, b: work.lstm_flops(m, n, b),
                           lambda m, n, k, b: work.lstm_bytes(m, n, b))
