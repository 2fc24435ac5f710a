"""Fused LSTM stack, eval forward: x [B, T, C] -> the top layer's last hidden
state [B, H], all layers and time steps in one launch.

`lstm_stack_last_all` runs the hand-written CUDA kernel
(csrc/fused_lstm_stack.cu) on a CUDA tensor and its plain PyTorch version,
`lstm_stack_plain`, on a CPU tensor or under float64. On a CUDA tensor a
shape or dtype the kernel does not take raises; nothing falls back to the
plain version there.

Counterpart of `weatherforecast_stgcn_maml_tpu/ops/fused_lstm_stack.py`
(`lstm_stack_last_all` on its no-grad path, whose Pallas body is
`_fwd_kernel_m_lastonly_nomask`). Rows are independent sequences, so a
batch of windows over N nodes is simply B*N rows of one launch.
"""

from __future__ import annotations

from typing import Sequence

import torch

from weatherforecast_stgcn_maml_tpu_torch.models.common import (
    accum_dtype,
    as_operand,
)
from weatherforecast_stgcn_maml_tpu_torch.ops import cuda_build

ROWS_PER_THREAD = (2, 4, 8)  # the row tiles the kernel is built for


def rows_per_thread(rows: int, hidden: int, sms: int) -> int:
    """The kernel's row tile for `rows` sequences on a card with `sms` SMs: a
    block holds 256 // H * rows_per_thread rows and walks all T * L stages
    alone, so its time grows with its rows. The smallest tile whose blocks
    fit in one wave (one block per SM) is the fastest; past that, the
    largest tile (measured in PERF.md)."""
    groups = max(1, 256 // hidden)
    for rpt in ROWS_PER_THREAD:
        if -(-rows // (groups * rpt)) <= sms:
            return rpt
    return ROWS_PER_THREAD[-1]


def lstm_stack_plain(
    layers: Sequence, x: torch.Tensor, compute_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Plain PyTorch version, the layerwise route: per layer the input
    projection of all steps in one product, then the recurrence
    (gate order i, f, g, o)."""
    h_seq = x.transpose(0, 1)  # [T, B, C]
    t_len, b, _ = h_seq.shape
    for layer in layers:
        hidden = layer.wh.shape[0]
        xp = torch.matmul(
            as_operand(h_seq, compute_dtype), as_operand(layer.wx, compute_dtype)
        ) + layer.b  # [T, B, 4H]
        wh = as_operand(layer.wh, compute_dtype)
        h = torch.zeros((b, hidden), dtype=accum_dtype(compute_dtype), device=x.device)
        c = torch.zeros_like(h)
        outs = []
        for t in range(t_len):
            gates = xp[t] + torch.matmul(as_operand(h, compute_dtype), wh)
            i, f, g, o = gates.split(hidden, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        h_seq = torch.stack(outs)
    return h_seq[-1]


def _lstm_stack_cuda(layers, x, compute_dtype):
    lib = cuda_build.load()
    dev = x.device
    rows, t_len, c_in = x.shape
    hidden = layers[0].wh.shape[0]
    g4 = 4 * hidden
    for l, layer in enumerate(layers):
        d_in = c_in if l == 0 else hidden
        if (
            layer.wx.shape != (d_in, g4)
            or layer.wh.shape != (hidden, g4)
            or layer.b.shape != (g4,)
        ):
            raise ValueError(f"LSTM layer {l} has weights of the wrong shape")
        if any(
            p.device != dev or p.dtype != torch.float32
            for p in (layer.wx, layer.wh, layer.b)
        ):
            raise TypeError("LSTM weights must be float32 on the input's device")
    if c_in % 4 or hidden % 4:
        raise ValueError(
            f"the LSTM kernel takes input and hidden widths that are multiples "
            f"of 4, got {c_in} and {hidden}"
        )
    code = cuda_build.dtype_code(compute_dtype)
    x = x.to(torch.float32)
    if x.stride(2) != 1:
        x = x.contiguous()
    # Merged gates: wcat_l = [[wx_l], [wh_l]] in the compute dtype.
    wcat = [torch.cat([layer.wx, layer.wh]).to(compute_dtype) for layer in layers]
    wcat0 = wcat[0].contiguous()
    wcatr = torch.stack(wcat[1:]).contiguous() if len(layers) > 1 else wcat0
    bias = torch.stack([layer.b for layer in layers]).contiguous()
    out = torch.empty((rows, hidden), dtype=torch.float32, device=dev)
    cuda_build.check(
        lib.wf_lstm_stack_last(
            code,
            rows_per_thread(
                rows, hidden, torch.cuda.get_device_properties(dev).multi_processor_count
            ),
            x.data_ptr(), x.stride(1), x.stride(0),
            wcat0.data_ptr(), wcatr.data_ptr(), bias.data_ptr(), out.data_ptr(),
            t_len, rows, c_in, hidden, len(layers), cuda_build.stream_ptr(dev),
        ),
        "LSTM stack",
    )
    return out


def lstm_stack_last_all(
    layers: Sequence, x: torch.Tensor, *, compute_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Run the whole stacked LSTM: x [B, T, C] -> h_top [B, H] at the last
    step, float32 (float64 under float64).

    `layers` are the LSTM's layers, each with `wx` [C_in, 4H], `wh` [H, 4H]
    and the fused bias `b` [4H] (models/lstm.py).
    """
    cuda_build.no_grad_inputs(
        x, *(p for layer in layers for p in (layer.wx, layer.wh, layer.b))
    )
    if x.device.type == "cpu" or compute_dtype == torch.float64:
        return lstm_stack_plain(layers, x, compute_dtype)
    if x.device.type != "cuda":
        raise TypeError(f"no LSTM kernel for device {x.device}")
    out = _lstm_stack_cuda(layers, x, compute_dtype)
    lstm_stack_last_all.launches += 1
    return out


lstm_stack_last_all.launches = 0  # stack runs through the CUDA kernel
