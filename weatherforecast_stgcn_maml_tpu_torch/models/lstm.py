"""Multi-layer LSTM over [B, T, C] sequences (B = nodes, or windows x nodes),
returning the top layer's last hidden state. Gate order (i, f, g, o), one
fused bias per layer (or torch's two, b_ih and b_hh, summed where the bias
is read), torch-style dropout on every inter-layer output in train mode."""

from __future__ import annotations

import torch
from torch import nn

from weatherforecast_stgcn_maml_tpu_torch.models.common import (
    apply_mask,
    as_operand,
    scaled_uniform,
)
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm_stack
from weatherforecast_stgcn_maml_tpu_torch.ops.fused_lstm_stack import (
    lstm_stack_last_all,
    lstm_stack_plain,
    lstm_stack_train,
)
from weatherforecast_stgcn_maml_tpu_torch.ops.lstm_scan import lstm_recurrence


class LSTMLayer(nn.Module):
    """`wx` [C_in, 4H], `wh` [H, 4H], and the gate bias `b` [4H]: one fused
    parameter, or (`b_ih`, `b_hh` given) the sum of torch's two, kept as two
    parameters as a reference checkpoint has them, so that each takes its
    own optimizer state and weight decay, as in the reference's training
    loop and the JAX package's tree. Every forward reads `b`."""

    def __init__(self, wx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor | None = None,
                 *, b_ih: torch.Tensor | None = None, b_hh: torch.Tensor | None = None):
        super().__init__()
        self.wx = nn.Parameter(wx)
        self.wh = nn.Parameter(wh)
        if b is not None:
            self.b = nn.Parameter(b)
        else:
            self.b_ih = nn.Parameter(b_ih)
            self.b_hh = nn.Parameter(b_hh)

    def __getattr__(self, name: str):
        params = self.__dict__.get("_parameters", {})
        if name == "b" and "b" not in params and "b_ih" in params:
            return params["b_ih"] + params["b_hh"]
        return super().__getattr__(name)


def split_lstm_biases(lstm: LSTM) -> None:
    """Give every layer with a fused bias torch's two (b_ih = b, b_hh = 0),
    in place, ready to load a state_dict that carries them."""
    for l, layer in enumerate(lstm.layers):
        if "b" in layer._parameters:
            b = layer.b.detach()
            lstm.layers[l] = LSTMLayer(layer.wx.detach(), layer.wh.detach(),
                                       b_ih=b.clone(), b_hh=torch.zeros_like(b))


class LSTM(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


def init_lstm(
    generator: torch.Generator, in_dim: int, hidden: int, num_layers: int
) -> LSTM:
    """Uniform(-1/sqrt(hidden)) init, the torch.nn.LSTM scheme."""
    bound = 1.0 / float(hidden) ** 0.5
    layers = []
    for l in range(num_layers):
        d_in = in_dim if l == 0 else hidden
        layers.append(
            LSTMLayer(
                scaled_uniform((d_in, 4 * hidden), bound, generator),
                scaled_uniform((hidden, 4 * hidden), bound, generator),
                scaled_uniform((4 * hidden,), bound, generator),
            )
        )
    return LSTM(layers)


def lstm_layerwise(
    params: LSTM, x: torch.Tensor, *, masks: torch.Tensor | None = None,
    keep: float = 1.0, compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The per-layer kernel route: per layer the input projection x @ wx + b
    of all steps as one product, then the recurrence (`lstm_recurrence`,
    kernel rows 18-19 on a card); `masks` (int8 {0, 1} [L-1, T, B, H]) drop
    each inter-layer output with scale 1/keep. x [B, T, C] -> [B, H]."""
    h = x.transpose(0, 1)  # [T, B, C]
    for l, layer in enumerate(params.layers):
        if l > 0 and masks is not None:
            h = apply_mask(h, masks[l - 1], keep)
        xp = torch.matmul(
            as_operand(h, compute_dtype), as_operand(layer.wx, compute_dtype)
        ) + layer.b  # [T, B, 4H]
        h = lstm_recurrence(xp, layer.wh, compute_dtype=compute_dtype)
    return h[-1]


def apply_lstm(
    params: LSTM,
    x: torch.Tensor,
    *,
    train: bool = False,
    masks: torch.Tensor | None = None,
    dropout_rate: float = 0.0,
    compute_dtype: torch.dtype = torch.float32,
    kernel: str = "xla",
) -> torch.Tensor:
    """Run the stacked LSTM: x [B, T, C] -> [B, H].

    kernel: "auto" or "pallas_stack" run the fused stack (the CUDA kernels
    on a card: the eval forward, or in train mode the training forward and
    its backward); "pallas" runs the layerwise route with the per-layer
    recurrence kernel (`lstm_layerwise`); "xla" runs the plain layerwise
    route. Under float64 every route is plain. Only "auto" chooses: where
    the card's schedule does not take the stack (in train mode
    `fused_lstm_stack.stack_planned`, the training stack's recurrences and
    widths: float32 H > 256, bfloat16 H > 384, widths not multiples of 8;
    in eval mode `eval_planned`, the eval forward's recurrence and widths:
    float32 H > 256, widths not multiples of 8) it runs the plain stack,
    counted in `lstm_stack_train.plain_routes`, as the JAX package's `auto`
    runs its XLA scan where `stack_supported` fails. "pallas_stack" and
    "pallas" run their kernels at any width and raise on a card where they
    refuse it, as the JAX package's forced routes do.

    In train mode `masks` (int8 {0, 1} [L-1, T, B, H], time-major, or None)
    drop each inter-layer output with scale 1 / (1 - dropout_rate).
    """
    if kernel not in ("auto", "pallas_stack", "pallas", "xla"):
        raise ValueError(
            f"lstm_kernel={kernel!r}: expected 'auto', 'pallas_stack', 'pallas' or 'xla'"
        )
    keep = 1.0 - dropout_rate
    if not train:
        masks, keep = None, 1.0
    if kernel == "pallas":
        return lstm_layerwise(params, x, masks=masks, keep=keep, compute_dtype=compute_dtype)
    if kernel == "xla":
        return lstm_stack_plain(params.layers, x, compute_dtype, masks, keep)
    rows, c_in, hidden = x.shape[0], x.shape[-1], params.layers[0].wh.shape[0]
    if kernel == "auto" and not (
            fused_lstm_stack.stack_planned(hidden, rows, compute_dtype, x.device, c_in=c_in)
            if train else
            fused_lstm_stack.eval_planned(c_in, hidden, rows, compute_dtype, x.device)):
        fused_lstm_stack.lstm_stack_train.plain_routes += 1
        return lstm_stack_plain(params.layers, x, compute_dtype, masks, keep)
    if not train:
        return lstm_stack_last_all(params.layers, x, compute_dtype=compute_dtype)
    return lstm_stack_train(
        params.layers, x, masks=masks, keep=keep, compute_dtype=compute_dtype
    )
