"""The eval LSTM stack's function: x [B, T, C] batch-major -> the top
layer's last hidden state [B, H] (kernel row 20).

`fused_lstm_last_hidden` is a `torch.autograd.Function` on every device, as
the JAX function is a custom VJP on every backend. On a CUDA tensor at
float32 / bfloat16 compute its forward is the eval forward of
ops/fused_lstm_stack.py (`eval_forward`: per layer one csrc/gemm_nn.cu input
product and one cluster forward recurrence of csrc/lstm_scan_fwd.cuh, all
enqueued by one C call) from the layers' own wx, wh and b. Where a gradient
is asked (the adaptation step's train mode at dropout 0) the forward keeps
row 14's residuals (`split_forward`) and the backward is row 15's
layer-by-layer schedule with no masks (`split_backward`), both counted
here. On a CPU tensor or under float64 the forward is the plain layerwise
route (`lstm_stack_plain`) and the backward recomputes and differentiates
it, as JAX's `_bwd` differentiates its XLA route. On a CUDA tensor a shape
or dtype the kernels do not take raises; nothing falls back to the plain
version there (models/hybrid.py asks `eval_planned` / `stack_planned`
first). The backward is first-order only (second-order MAML pins the plain
route, train/so_fused.py `plain_route`).

Counterpart of `weatherforecast_stgcn_maml_tpu/ops/fused_lstm.py`
(`fused_lstm_last_hidden`; Pallas body `_kernel`), which adds in the card
recurrence's order, (round(in) Wx + b) + round(h) Wh. JAX takes the kernel
only where its VMEM gate `fits_vmem` allows (hidden and input widths that
are multiples of 128); the card's schedule takes widths that are multiples
of 8 that a cluster plan holds.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Sequence

import torch

from weatherforecast_stgcn_maml_tpu_torch.ops.fused_lstm_stack import (
    _check_lstm,
    _check_train,
    _on_card,
    _split_weights,
    eval_forward,
    lstm_stack_plain,
    split_backward,
    split_forward,
)


def _layers(params):
    """(wx, wh, b) triples -> objects with the LSTM layers' attributes."""
    return [SimpleNamespace(wx=wx, wh=wh, b=b) for wx, wh, b in params]


class _FusedLstm(torch.autograd.Function):
    """Row 20's forward over (x, wx_0, wh_0, b_0, wx_1, ...); on a card with
    `grad` row 14's forward with residuals and row 15's backward, else the
    backward differentiates the plain layerwise route."""

    @staticmethod
    def forward(ctx, x, compute_dtype, grad, *params):
        layers = _layers(zip(params[0::3], params[1::3], params[2::3]))
        ctx.compute_dtype, ctx.card = compute_dtype, _on_card(x, compute_dtype)
        if not ctx.card:
            ctx.save_for_backward(x, *params)
            return lstm_stack_plain(layers, x, compute_dtype)
        if not grad:
            return eval_forward(layers, x, compute_dtype, fused_lstm_last_hidden)
        _check_lstm(layers, x, compute_dtype)
        rows, t_len, c_in = x.shape
        _check_train(x, None, rows, t_len, c_in, layers[0].wh.shape[0], len(layers))
        x_tbc = x.transpose(0, 1)
        wx0, wxr, wh, b2d = _split_weights(layers)
        h_last, h_all, c_all = split_forward(x_tbc, wx0, wxr, wh, b2d, None, 1.0, compute_dtype,
                                             counter=fused_lstm_last_hidden)
        ctx.x_dtype = x.dtype
        ctx.save_for_backward(x_tbc, h_all, c_all, wx0, wxr, wh, b2d)
        return h_last

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        if ctx.card:
            x_tbc, h_all, c_all, wx0, wxr, wh, b2d = ctx.saved_tensors
            dx, dwx0, dwxr, dwh, db = split_backward(
                g, x_tbc, h_all, c_all, wx0, wxr, wh, b2d, None, 1.0, ctx.compute_dtype,
                counter=fused_lstm_last_hidden)
            grads = [dx.transpose(0, 1).to(ctx.x_dtype)]
            for l, dwx in enumerate([dwx0, *dwxr]):
                grads += [dwx, dwh[l], db[l]]
            return (grads[0], None, None, *grads[1:])
        x, *params = ctx.saved_tensors
        leaves = [t.detach().requires_grad_(True) for t in (x, *params)]
        with torch.enable_grad():
            out = lstm_stack_plain(
                _layers(zip(leaves[1::3], leaves[2::3], leaves[3::3])), leaves[0],
                ctx.compute_dtype,
            )
            grads = torch.autograd.grad(out, leaves, g, allow_unused=True)
        grads = [torch.zeros_like(t) if d is None else d for t, d in zip(leaves, grads)]
        return (grads[0], None, None, *grads[1:])


def fused_lstm_last_hidden(
    layers: Sequence, x: torch.Tensor, *, compute_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """The stacked LSTM's eval function, no dropout: x [B, T, C] -> h_top
    [B, H] at the last step, float32 (float64 under float64).

    `layers` are the LSTM's layers, each with `wx` [C_in, 4H], `wh` [H, 4H]
    and the fused bias `b` [4H] (models/lstm.py)."""
    params = [p for layer in layers for p in (layer.wx, layer.wh, layer.b)]
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params))
    return _FusedLstm.apply(x, compute_dtype, grad, *params)


fused_lstm_last_hidden.launches = 0  # forwards run through the CUDA kernels (row 20)
# Row 20's pieces: its gemm_nn and forward recurrence launches (one each a layer).
fused_lstm_last_hidden.forward_gemm_nn_launches = 0
fused_lstm_last_hidden.forward_recurrence_launches = 0
# Train-mode backwards on the card (row 15's schedule) and their TN products.
fused_lstm_last_hidden.backward_launches = 0
fused_lstm_last_hidden.backward_gemm_tn_launches = 0
# Calls whose recurrences ran on a streamed plan (`eval_plan`; train mode
# past the clusters that hold Wh never: models/hybrid.py asks `stack_planned`).
fused_lstm_last_hidden.streamed_launches = 0
fused_lstm_last_hidden.backward_streamed_launches = 0
