"""Fused LSTM stack: x [B, T, C] -> the top layer's last hidden state
[B, H], all layers and time steps in one launch.

Two entries, each running a hand-written CUDA kernel on a CUDA tensor and
its plain PyTorch version, `lstm_stack_plain`, on a CPU tensor or under
float64. On a CUDA tensor a shape or dtype a kernel does not take raises;
nothing falls back to the plain version there.

  * `lstm_stack_last_all`: the eval forward (csrc/fused_lstm_stack.cu,
    kernel row 2), no autograd;
  * `lstm_stack_train`: the training forward (the same kernel emitting
    h / c residuals and the activated gates and applying int8 inter-layer
    dropout masks, row 4) and its backward (csrc/fused_lstm_stack_train.cu
    for the reverse-time recurrence, row 5, then csrc/gemm.cu for the
    weight and bias gradients) behind one `torch.autograd.Function`.

Counterpart of `weatherforecast_stgcn_maml_tpu/ops/fused_lstm_stack.py`
(`lstm_stack_last_all`; Pallas bodies `_fwd_kernel_m_lastonly_nomask`,
`_fwd_kernel_m` and `_bwd_kernel_m`). Rows are independent sequences, so a
batch of windows over N nodes is simply B*N rows of one launch.
"""

from __future__ import annotations

from typing import Sequence

import torch

from weatherforecast_stgcn_maml_tpu_torch.models.common import (
    accum_dtype,
    apply_mask,
    as_operand,
)
from weatherforecast_stgcn_maml_tpu_torch.ops import cuda_build
from weatherforecast_stgcn_maml_tpu_torch.ops.gemm import colsum, matmul_tn

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
    layers: Sequence, x: torch.Tensor, compute_dtype: torch.dtype = torch.float32,
    masks: torch.Tensor | None = None, keep: float = 1.0,
) -> torch.Tensor:
    """Plain PyTorch version, the layerwise route: per layer the input
    projection of all steps in one product, then the recurrence
    (gate order i, f, g, o). `masks` (int8 {0, 1} [L-1, T, B, H]) drop
    each inter-layer output with scale 1/keep."""
    h_seq = x.transpose(0, 1)  # [T, B, C]
    t_len, b, _ = h_seq.shape
    for l, layer in enumerate(layers):
        if l > 0 and masks is not None:
            h_seq = apply_mask(h_seq, masks[l - 1], keep)
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


def _check_lstm(layers, x, compute_dtype):
    """Raise on what the LSTM kernels do not take."""
    dev = x.device
    _, _, c_in = x.shape
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
    return cuda_build.dtype_code(compute_dtype)


def _merged(wcat, compute_dtype):
    """(wcat0, wcatr) in the compute dtype from the per-layer [[wx], [wh]]."""
    wcat = [w.to(compute_dtype) for w in wcat]
    wcat0 = wcat[0].contiguous()
    wcatr = torch.stack(wcat[1:]).contiguous() if len(wcat) > 1 else wcat0
    return wcat0, wcatr


def _rows_per_thread(rows, hidden, dev):
    return rows_per_thread(
        rows, hidden, torch.cuda.get_device_properties(dev).multi_processor_count
    )


def _lstm_stack_cuda(layers, x, compute_dtype):
    lib = cuda_build.load()
    code = _check_lstm(layers, x, compute_dtype)
    dev = x.device
    rows, t_len, c_in = x.shape
    hidden = layers[0].wh.shape[0]
    x = x.to(torch.float32)
    if x.stride(2) != 1:
        x = x.contiguous()
    # Merged gates: wcat_l = [[wx_l], [wh_l]] in the compute dtype.
    wcat0, wcatr = _merged(
        [torch.cat([layer.wx, layer.wh]) for layer in layers], compute_dtype
    )
    bias = torch.stack([layer.b for layer in layers]).contiguous()
    out = torch.empty((rows, hidden), dtype=torch.float32, device=dev)
    cuda_build.check(
        lib.wf_lstm_stack_last(
            code, _rows_per_thread(rows, hidden, dev),
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


def train_forward(x_tbc, masks, keep, compute_dtype, b2d, wcat):
    """Row 4 on a CUDA tensor: x_tbc [T, B, C], wcat_l = [[wx_l], [wh_l]]
    float32, b2d [L, 4H] -> (h_last [B, H] float32, h_all, c_all [L, T, B,
    H] in the compute dtype, the activated gates [L, T, B, 4H] float32)."""
    lib = cuda_build.load()
    dev = x_tbc.device
    t_len, rows, c_in = x_tbc.shape
    n_layers, g4 = b2d.shape
    hidden = g4 // 4
    code = cuda_build.dtype_code(compute_dtype)
    x = x_tbc.to(torch.float32).contiguous()
    wcat0, wcatr = _merged(wcat, compute_dtype)
    bias = b2d.contiguous()
    shape = (n_layers, t_len, rows, hidden)
    h_all = torch.empty(shape, dtype=compute_dtype, device=dev)
    c_all = torch.empty(shape, dtype=compute_dtype, device=dev)
    gates = torch.empty((n_layers, t_len, rows, g4), dtype=torch.float32, device=dev)
    out = torch.empty((rows, hidden), dtype=torch.float32, device=dev)
    rpt = _rows_per_thread(rows, hidden, dev)
    cuda_build.check(
        lib.wf_lstm_stack_train_fwd(
            code, rpt, x.data_ptr(), x.stride(0), x.stride(1),
            wcat0.data_ptr(), wcatr.data_ptr(), bias.data_ptr(),
            None if masks is None else masks.data_ptr(), 1.0 / keep,
            h_all.data_ptr(), c_all.data_ptr(), gates.data_ptr(), out.data_ptr(),
            t_len, rows, c_in, hidden, n_layers, cuda_build.stream_ptr(dev),
        ),
        "LSTM train forward",
    )
    lstm_stack_train.launches += 1
    return out, h_all, c_all, gates


def train_backward(g, x_tbc, h_all, c_all, gates, wcat, masks, keep, compute_dtype,
                   carries=False):
    """Row 5 on a CUDA tensor: the gradient g [B, H] of the last h back to
    (dx [T, B, C], [dwcat_l], db [L, 4H]) float32, and the gate gradients
    dgates [L, T, B, 4H]; with `carries`, also each stage's dh and dc [L, T,
    B, H] float32 (else None), which the second-order backward reads."""
    lib = cuda_build.load()
    dev = x_tbc.device
    t_len, rows, c_in = x_tbc.shape
    n_layers, _, _, g4 = gates.shape
    hidden = g4 // 4
    inv_keep = 1.0 / keep
    x = x_tbc.to(torch.float32).contiguous()
    g = g.to(torch.float32).contiguous()
    wcat0, wcatr = _merged(wcat, compute_dtype)
    # The transposed weights of the dgates @ wcat^T contraction.
    wcat_t0 = wcat0.t().contiguous()
    wcat_tr = wcatr.transpose(1, 2).contiguous() if n_layers > 1 else wcat_t0
    dx = torch.empty((t_len, rows, c_in), dtype=torch.float32, device=dev)
    dgates = torch.empty((n_layers, t_len, rows, g4), dtype=torch.float32, device=dev)
    dh_all = dc_all = None
    if carries:
        dh_all = torch.empty((n_layers, t_len, rows, hidden), dtype=torch.float32, device=dev)
        dc_all = torch.empty_like(dh_all)
    cuda_build.check(
        lib.wf_lstm_stack_train_bwd(
            cuda_build.dtype_code(compute_dtype), _rows_per_thread(rows, hidden, dev),
            g.data_ptr(), gates.data_ptr(), c_all.data_ptr(),
            None if masks is None else masks.data_ptr(), inv_keep,
            wcat_t0.data_ptr(), wcat_tr.data_ptr(), dx.data_ptr(),
            dgates.data_ptr(), None if dh_all is None else dh_all.data_ptr(),
            None if dc_all is None else dc_all.data_ptr(),
            t_len, rows, c_in, hidden, n_layers, cuda_build.stream_ptr(dev),
        ),
        "LSTM train backward",
    )
    # dwcat_l = [inp | h_prev]^T @ dgates_l over every step and row;
    # h_prev at t = 0 is zero, so its rows start at t = 1.
    steps = t_len * rows
    dwcat, db = [], torch.empty((n_layers, g4), dtype=torch.float32, device=dev)
    for l in range(n_layers):
        kin = c_in if l == 0 else hidden
        dg = dgates[l].view(steps, g4)
        dw = torch.empty((kin + hidden, g4), dtype=torch.float32, device=dev)
        if l == 0:
            inp, mask = x.view(steps, c_in), None
        else:
            inp = h_all[l - 1].view(steps, hidden)
            mask = None if masks is None else masks[l - 1].view(steps, hidden)
        matmul_tn(
            inp, dg, dw[:kin], amask=mask, ascale=inv_keep,
            compute_dtype=compute_dtype, what=f"LSTM layer {l} input weight gradient",
        )
        matmul_tn(
            h_all[l, :-1].reshape(steps - rows, hidden), dg[rows:], dw[kin:],
            compute_dtype=compute_dtype, what=f"LSTM layer {l} recurrent weight gradient",
        )
        colsum(dg, db[l], f"LSTM layer {l} bias gradient")
        dwcat.append(dw)
    lstm_stack_train.backward_launches += 1
    return dx, dwcat, db, dgates, dh_all, dc_all


class _LstmStackTrain(torch.autograd.Function):
    """Rows 4 and 5 as one differentiable op over (x_tbc, wcat_0, ...,
    b2d): x_tbc [T, B, C], wcat_l = [[wx_l], [wh_l]] float32, b2d [L, 4H]."""

    @staticmethod
    def forward(ctx, x_tbc, masks, keep, compute_dtype, b2d, *wcat):
        out, h_all, c_all, gates = train_forward(x_tbc, masks, keep, compute_dtype, b2d, wcat)
        ctx.compute_dtype, ctx.keep, ctx.x_dtype = compute_dtype, keep, x_tbc.dtype
        ctx.save_for_backward(x_tbc, masks, h_all, c_all, gates, *wcat)
        return out

    @staticmethod
    def backward(ctx, g):
        x, masks, h_all, c_all, gates, *wcat = ctx.saved_tensors
        dx, dwcat, db, *_ = train_backward(
            g, x, h_all, c_all, gates, wcat, masks, ctx.keep, ctx.compute_dtype
        )
        return (dx.to(ctx.x_dtype), None, None, None, db, *dwcat)


def lstm_stack_train(
    layers: Sequence, x: torch.Tensor, *,
    masks: torch.Tensor | None = None, keep: float = 1.0,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Training forward of the stacked LSTM: x [B, T, C] -> h_top [B, H] at
    the last step, float32 (float64 under float64), differentiable.

    `masks` are int8 {0, 1} [L-1, T, B, H] (time-major, as the JAX
    package's) dropping each inter-layer output with scale 1/keep, or None.
    """
    if x.device.type == "cpu" or compute_dtype == torch.float64:
        return lstm_stack_plain(layers, x, compute_dtype, masks, keep)
    if x.device.type != "cuda":
        raise TypeError(f"no LSTM kernel for device {x.device}")
    _check_lstm(layers, x, compute_dtype)
    rows, t_len, c_in = x.shape
    hidden = layers[0].wh.shape[0]
    if c_in % 8 or hidden % 8 or c_in > 7 * hidden:
        raise ValueError(
            f"the LSTM training kernels take widths that are multiples of 8 "
            f"with input <= 7 x hidden, got {c_in} and {hidden}"
        )
    cuda_build.dtype_code(x.dtype)
    if masks is not None and (
        masks.dtype != torch.int8 or masks.device != x.device
        or masks.shape != (len(layers) - 1, t_len, rows, hidden)
        or not masks.is_contiguous()
    ):
        raise ValueError(
            f"masks must be contiguous int8 [{len(layers) - 1}, {t_len}, {rows}, "
            f"{hidden}] on the input's device"
        )
    b2d = torch.stack([layer.b for layer in layers])
    wcat = [torch.cat([layer.wx, layer.wh]) for layer in layers]
    return _LstmStackTrain.apply(x.transpose(0, 1), masks, keep, compute_dtype, b2d, *wcat)


lstm_stack_train.launches = 0  # forwards run through the CUDA kernel (row 4)
lstm_stack_train.backward_launches = 0  # backwards run through the kernels (row 5)
