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


def lstm_wavefront(
    params: LSTM, x: torch.Tensor, *, masks: torch.Tensor | None = None,
    keep: float = 1.0, compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The stack advanced on the (layer, time) antidiagonal wavefront
    (`model.lstm_wavefront`; the JAX package's `apply_lstm_wavefront`):
    x [B, T, C] -> the top layer's last h [B, H]. Plain PyTorch, no kernel.

    Cell (l, t) depends only on (l, t-1) and (l-1, t), so every cell with
    l + t = k is independent: T + L - 1 steps, each one lane-batched
    product [L, B, 2H] @ [L, 2H, 4H] of [inter-layer input | own h] with
    [[wx_l], [wh_l]]. Layer 0's input projection is hoisted (one [T, B, C]
    @ [C, 4H] product, with its bias), so lane 0's wx slot is zero. A
    lane's own h and c are reset at its first active step, so what a lane
    computed before it started never reaches an active cell; the last step
    computes the top lane at time T-1. One layer runs the layerwise stack.

    `masks` (int8 {0, 1} [L-1, T, B, H], the layerwise stack's layout)
    drop each inter-layer output, gathered into wavefront order: lane l at
    step k takes element [l-1, clamp(k-l, 0, T-1)]; the clamped elements
    fall on lanes that have not started or have finished, whose outputs
    never reach the result. Applied as where(mask, x / keep, 0). Operands
    are rounded to the compute dtype and multiplied in the accumulation
    dtype, where the JAX package rounds. Every operation is out of place,
    so the function is twice differentiable under torch.func (second
    order's Hessian transpose runs it under `meta.so_wavefront`)."""
    layers = params.layers
    n_layers = len(layers)
    if n_layers == 1:
        return lstm_stack_plain(layers, x, compute_dtype)
    x_tbc = x.transpose(0, 1)  # [T, B, C]
    t_len, b, _ = x_tbc.shape
    hidden = layers[0].wh.shape[0]
    xproj0 = torch.matmul(
        as_operand(x_tbc, compute_dtype), as_operand(layers[0].wx, compute_dtype)
    ) + layers[0].b  # [T, B, 4H]
    w_cat = torch.stack([
        torch.cat([torch.zeros_like(layers[0].wh) if l == 0 else layer.wx, layer.wh])
        for l, layer in enumerate(layers)])  # [L, 2H, 4H]
    w_cat = as_operand(w_cat, compute_dtype)
    # Lane 0's bias lives in xproj0.
    bias = torch.stack([torch.zeros_like(layers[0].b)] + [layer.b for layer in layers[1:]])
    n_steps = t_len + n_layers - 1
    wf_masks = None
    if masks is not None:
        below = torch.arange(1, n_layers, device=masks.device)[None, :]
        t_idx = (torch.arange(n_steps, device=masks.device)[:, None] - below).clamp(0, t_len - 1)
        wf_masks = masks.bool()[below - 1, t_idx]  # [T + L - 1, L-1, B, H]
    lanes = torch.arange(n_layers, device=x.device)
    h = xproj0.new_zeros((n_layers, b, hidden))
    c = h
    for k in range(n_steps):
        # Lane l's inter-layer input at step k is lane l-1's output of step
        # k-1 (time k-l): h shifted down one lane; lane 0 has none.
        below = h[:-1]
        if wf_masks is not None:
            below = torch.where(wf_masks[k], below / keep, torch.zeros_like(below))
        shifted = torch.cat([torch.zeros_like(h[:1]), below])
        starting = (lanes == k)[:, None, None]
        h_own = torch.where(starting, torch.zeros_like(h), h)
        c_own = torch.where(starting, torch.zeros_like(c), c)
        in_cat = torch.cat([as_operand(shifted, compute_dtype),
                            as_operand(h_own, compute_dtype)], dim=-1)  # [L, B, 2H]
        gates = torch.matmul(in_cat, w_cat) + bias[:, None, :]
        gates = torch.cat([gates[:1] + xproj0[min(k, t_len - 1)], gates[1:]])
        i, f, g, o = gates.split(hidden, dim=-1)
        c = torch.sigmoid(f) * c_own + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
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
    the card's schedule does not hold the stack's Wh in a cluster (in train
    mode `fused_lstm_stack.stack_planned`, the training stack's recurrences
    and widths: float32 H > 396, bfloat16 H > 512, widths not multiples of
    8; in eval mode `eval_planned`, the eval forward's recurrence and
    widths: float32 H > 436, bfloat16 H > 512, widths not multiples of 8)
    it runs the plain stack, counted in `lstm_stack_train.plain_routes`, as the JAX package's
    `auto` runs its XLA scan where `stack_supported` fails.
    "pallas_stack" and "pallas" run their kernels at any width, as the JAX
    package's forced routes do: past the clusters that hold Wh their
    recurrences stream the rest of each block's slice from L2 (streamed
    plans, to H 2048); on a card they raise only on widths the kernels do
    not take (not multiples of 8 for the stack, of 4 for "pallas"; past H
    2048).

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
