"""The eval LSTM stack as per-layer input projections and recurrences: x
[B, T, C] batch-major -> the top layer's last hidden state [B, H].

`fused_lstm_last_hidden` is a `torch.autograd.Function` on every device, as
the JAX function is a custom VJP on every backend. Its forward runs the
CUDA kernels of csrc/fused_lstm.cu (kernel row 20: per layer the input
projection on gemm.cu's GEMM, then the recurrence of csrc/
lstm_recurrence.cuh) on a CUDA tensor at float32 / bfloat16 compute, and
the plain layerwise route (`lstm_stack_plain`) on a CPU tensor or under
float64. On a CUDA tensor a shape or dtype the kernels do not take raises;
nothing falls back to the plain version there. Its backward recomputes the
plain layerwise route and differentiates it, as JAX's `_bwd` differentiates
its XLA route; it is first-order only (second-order MAML pins the plain
route, train/so_fused.py `plain_route`).

Counterpart of `weatherforecast_stgcn_maml_tpu/ops/fused_lstm.py`
(`fused_lstm_last_hidden`; Pallas body `_kernel`). JAX takes the kernel only
where its VMEM gate `fits_vmem` allows (hidden and input widths that are
multiples of 128); the CUDA kernels take widths that are multiples of 4.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import Sequence

import torch

from weatherforecast_stgcn_maml_tpu_torch.ops import cuda_build
from weatherforecast_stgcn_maml_tpu_torch.ops.fused_lstm_stack import (
    _check_lstm,
    _rows_per_thread,
    lstm_stack_plain,
)
from weatherforecast_stgcn_maml_tpu_torch.ops.lstm_scan import _aligned


def _layers(params):
    """(wx, wh, b) triples -> objects with the LSTM layers' attributes."""
    return [SimpleNamespace(wx=wx, wh=wh, b=b) for wx, wh, b in params]


def _fused_lstm_cuda(layers, x, compute_dtype):
    code = _check_lstm(layers, x, compute_dtype)
    dev = x.device
    rows, t_len, c_in = x.shape
    hidden = layers[0].wh.shape[0]
    if hidden > 256:
        raise ValueError(f"the recurrence kernel takes hidden widths up to 256, got {hidden}")
    x = x.to(torch.float32).contiguous()
    wx = [_aligned(layer.wx) for layer in layers]
    wh = [_aligned(layer.wh.to(compute_dtype)) for layer in layers]
    bias = [layer.b.contiguous() for layer in layers]
    xp = torch.empty((rows * t_len, 4 * hidden), dtype=torch.float32, device=dev)
    h_seq = (torch.empty((rows * t_len, hidden), dtype=torch.float32, device=dev)
             if len(layers) > 1 else xp)
    out = torch.empty((rows, hidden), dtype=torch.float32, device=dev)
    n = len(layers)

    def ptrs(ts):
        return (ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))

    cuda_build.check(
        cuda_build.load().wf_fused_lstm_last(
            code, _rows_per_thread(rows, hidden, dev), x.data_ptr(), ptrs(wx), ptrs(wh),
            ptrs(bias), xp.data_ptr(), h_seq.data_ptr(), out.data_ptr(),
            rows, t_len, c_in, hidden, n, cuda_build.stream_ptr(dev),
        ),
        "fused LSTM stack",
    )
    return out


class _FusedLstm(torch.autograd.Function):
    """Row 20's forward over (x, wx_0, wh_0, b_0, wx_1, ...); the backward
    differentiates the plain layerwise route."""

    @staticmethod
    def forward(ctx, x, compute_dtype, *params):
        layers = _layers(zip(params[0::3], params[1::3], params[2::3]))
        if x.device.type == "cpu" or compute_dtype == torch.float64:
            out = lstm_stack_plain(layers, x, compute_dtype)
        elif x.device.type == "cuda":
            out = _fused_lstm_cuda(layers, x, compute_dtype)
            fused_lstm_last_hidden.launches += 1
        else:
            raise TypeError(f"no LSTM kernel for device {x.device}")
        ctx.compute_dtype = compute_dtype
        ctx.save_for_backward(x, *params)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        leaves = [t.detach().requires_grad_(True) for t in (x, *params)]
        with torch.enable_grad():
            out = lstm_stack_plain(
                _layers(zip(leaves[1::3], leaves[2::3], leaves[3::3])), leaves[0],
                ctx.compute_dtype,
            )
            grads = torch.autograd.grad(out, leaves, g, allow_unused=True)
        grads = [torch.zeros_like(t) if d is None else d for t, d in zip(leaves, grads)]
        return (grads[0], None, *grads[1:])


def fused_lstm_last_hidden(
    layers: Sequence, x: torch.Tensor, *, compute_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """The stacked LSTM's eval function, no dropout: x [B, T, C] -> h_top
    [B, H] at the last step, float32 (float64 under float64).

    `layers` are the LSTM's layers, each with `wx` [C_in, 4H], `wh` [H, 4H]
    and the fused bias `b` [4H] (models/lstm.py)."""
    params = [p for layer in layers for p in (layer.wx, layer.wh, layer.b)]
    return _FusedLstm.apply(x, compute_dtype, *params)


fused_lstm_last_hidden.launches = 0  # forwards run through the CUDA kernels (row 20)
