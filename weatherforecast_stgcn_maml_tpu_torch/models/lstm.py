"""Multi-layer LSTM over [B, T, C] sequences (B = nodes, or windows x nodes),
returning the top layer's last hidden state. Gate order (i, f, g, o), one
fused bias per layer, torch-style dropout on every inter-layer output in
train mode."""

from __future__ import annotations

import torch
from torch import nn

from weatherforecast_stgcn_maml_tpu_torch.models.common import scaled_uniform
from weatherforecast_stgcn_maml_tpu_torch.ops.fused_lstm_stack import (
    lstm_stack_last_all,
    lstm_stack_plain,
    lstm_stack_train,
)


class LSTMLayer(nn.Module):
    """`wx` [C_in, 4H], `wh` [H, 4H], fused bias `b` [4H]."""

    def __init__(self, wx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.wx = nn.Parameter(wx)
        self.wh = nn.Parameter(wh)
        self.b = nn.Parameter(b)


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
    its backward); "xla" runs the plain layerwise route. The JAX package's
    per-layer kernel ("pallas") is not ported.

    In train mode `masks` (int8 {0, 1} [L-1, T, B, H], time-major, or None)
    drop each inter-layer output with scale 1 / (1 - dropout_rate).
    """
    if kernel not in ("auto", "pallas_stack", "xla"):
        raise NotImplementedError(
            f"lstm_kernel={kernel!r} selects a kernel that is not ported; "
            "use 'auto' (fused stack) or 'xla' (plain)"
        )
    if not train:
        if kernel == "xla":
            return lstm_stack_plain(params.layers, x, compute_dtype)
        return lstm_stack_last_all(params.layers, x, compute_dtype=compute_dtype)
    keep = 1.0 - dropout_rate
    if kernel == "xla":
        return lstm_stack_plain(params.layers, x, compute_dtype, masks, keep)
    return lstm_stack_train(
        params.layers, x, masks=masks, keep=keep, compute_dtype=compute_dtype
    )
