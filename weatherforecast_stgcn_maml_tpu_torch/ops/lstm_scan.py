"""One LSTM layer's recurrence with a hand-written backward: xp [T, B, 4H]
(the hoisted input projection + bias) and wh [H, 4H] -> h_all [T, B, H].

`lstm_recurrence` runs the CUDA kernels behind one `torch.autograd.Function`
on a CUDA tensor at float32 / bfloat16 compute: the forward (kernel row 18,
the cluster forward recurrence of csrc/lstm_scan_fwd.cuh that rows 4, 14 and
16 share, planned by `forward_plan`) emits h_all and c_all in float32, and,
when a backward will follow, the activated gates; the backward (row 19,
`scan_backward`: one C call, csrc/lstm_scan.cu) emits dgates by the cluster
recurrence of csrc/lstm_scan_bwd.cuh that rows 5, 15 and 17 share, and dwh =
round(h_prev)^T @ round(dgates) on the GEMM core's K-split TN product
(csrc/gemm_nn.cu), its partials added in split order; dxp is dgates.
`scan_backward_schedule` states that backward on swappable pieces (the
kernels a launch each, `CARD_PIECES`, or their plain versions,
`PLAIN_PIECES`: the CPU tests). Past the widths whose Wh a cluster holds
(float32 H > 436 forward / 396 backward, bfloat16 H > 512), both
recurrences take streamed plans (`forward_plan`, `recurrence_plan`: what
fits of each block's slice resident, the rest read from L2 at every step),
to H 2048. On a CPU tensor or under float64 it runs the
plain version, `lstm_recurrence_plain`, differentiated by autograd. On a
CUDA tensor a shape or dtype the kernels do not take raises; nothing falls
back to the plain version there. The op is first-order differentiable only:
second-order MAML differentiates the plain route (train/so_fused.py
`plain_route`).

Counterpart of `weatherforecast_stgcn_maml_tpu/ops/lstm_scan.py`
(`lstm_recurrence(kernel="pallas")`; Pallas bodies `_fwd_kernel` and
`_bwd_kernel`, custom VJP `_recurrence_bwd`). The TPU backward recomputes
the gates from xp and h_prev; the CUDA forward stores them instead (see
csrc/lstm_scan.cu), which changes no output.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Callable

import torch
import torch.nn.functional as F

from weatherforecast_stgcn_maml_tpu_torch.models.common import accum_dtype, as_operand
from weatherforecast_stgcn_maml_tpu_torch.ops import cuda_build
from weatherforecast_stgcn_maml_tpu_torch.ops.fused_lstm_stack import (
    _SCAN_FWD,
    _forward_recurrence_plain,
    _plan_text,
    _ptr,
    _sms,
    forward_plan,
    forward_weights,
    launch_recurrence,
    recurrence_plan,
    streams,
)
from weatherforecast_stgcn_maml_tpu_torch.ops.gemm import (
    _NN_REFUSALS,
    NN_MULTIPLE,
    gemm_tn,
    gemm_tn_plain,
    sum_splits,
    sum_splits_plain,
    tn_splits,
    wave_split_rows,
)


def lstm_recurrence_plain(
    xp: torch.Tensor, wh: torch.Tensor, compute_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Plain PyTorch version: per step gates = xp[t] + round(h) @ round(wh)
    (gate order i, f, g, o), zero carries at t = 0 -> h_all [T, B, H]."""
    t_len, b, _ = xp.shape
    hidden = wh.shape[0]
    whc = as_operand(wh, compute_dtype)
    h = torch.zeros((b, hidden), dtype=accum_dtype(compute_dtype), device=xp.device)
    c = torch.zeros_like(h)
    outs = []
    for t in range(t_len):
        gates = xp[t] + torch.matmul(as_operand(h, compute_dtype), whc)
        i, f, g, o = gates.split(hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    return torch.stack(outs)


def scan_backward_plain(
    g: torch.Tensor, gates: torch.Tensor, c_all: torch.Tensor, wh: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32, carries: bool = False,
):
    """Plain version of the backward recurrence of rows 5, 15 and 19
    (csrc/lstm_scan_bwd.cuh): from the gradient g [T, B, H] of the h
    sequence, the activated gates [T, B, 4H] and c_all [T, B, H] (any dtype;
    widened), walking t = T-1 .. 0 with dh / dc carries -> dgates [T, B, 4H]
    in the accumulation dtype; the dh carry is round(dgates) @ round(wh)^T.
    With `carries`, -> (dgates, dh_all, dc_all): each step's dh (g plus the
    carry) and dc (before the * f into the carry) [T, B, H]."""
    acc = accum_dtype(compute_dtype)
    t_len, rows, hidden = g.shape
    wht = as_operand(wh, compute_dtype).t()
    dh_c = torch.zeros((rows, hidden), dtype=acc, device=g.device)
    dc_c = torch.zeros_like(dh_c)
    out, dhs, dcs = [None] * t_len, [None] * t_len, [None] * t_len
    for t in reversed(range(t_len)):
        i, f, gg, o = gates[t].to(acc).split(hidden, dim=-1)
        c_prev = c_all[t - 1].to(acc) if t > 0 else torch.zeros_like(dh_c)
        tc = torch.tanh(c_all[t].to(acc))
        dh = g[t].to(acc) + dh_c
        dc = dc_c + dh * o * (1.0 - tc * tc)
        dgates = torch.cat([dc * gg * i * (1.0 - i), dc * c_prev * f * (1.0 - f),
                            dc * i * (1.0 - gg * gg), dh * tc * o * (1.0 - o)], dim=-1)
        dh_c = torch.matmul(as_operand(dgates, compute_dtype), wht)
        dc_c = dc * f
        out[t], dhs[t], dcs[t] = dgates, dh, dc
    if carries:
        return torch.stack(out), torch.stack(dhs), torch.stack(dcs)
    return torch.stack(out)


def _aligned(w: torch.Tensor) -> torch.Tensor:
    """w contiguous, its data 16-byte aligned (the kernels' cp.async tiles)."""
    w = w.contiguous()
    return w if w.data_ptr() % 16 == 0 else w.clone()


def scan_forward_plain(xp: torch.Tensor, wh: torch.Tensor, compute_dtype: torch.dtype,
                       keep_gates: bool):
    """Plain version of `scan_forward`: the forward recurrence's plain piece
    (`fused_lstm_stack._forward_recurrence_plain`, no bias: xp holds it) ->
    (h_all, c_all [T, B, H] unrounded, the activated gates [T, B, 4H] or
    None), in the accumulation dtype."""
    t_len, rows, g4 = xp.shape
    gates = xp.to(accum_dtype(compute_dtype)).clone()
    h_all = torch.empty((t_len, rows, g4 // 4), dtype=gates.dtype, device=xp.device)
    c_all = torch.empty_like(h_all)
    _forward_recurrence_plain(gates, wh, None, compute_dtype, h_all, c_all)
    return h_all, c_all, gates if keep_gates else None


def scan_forward(xp: torch.Tensor, wh: torch.Tensor, compute_dtype: torch.dtype,
                 keep_gates: bool):
    """Row 18 on a CUDA tensor: -> (h_all, c_all [T, B, H], gates [T, B, 4H]
    or None), float32, by the forward recurrence of csrc/lstm_scan_fwd.cuh
    (one launch: xp holds the bias; the gates go to an array of their own,
    xp being the autograd input)."""
    t_len, rows, g4 = xp.shape
    hidden = g4 // 4
    dev = xp.device
    h_all = torch.empty((t_len, rows, hidden), dtype=torch.float32, device=dev)
    c_all = torch.empty_like(h_all)
    gates = torch.empty_like(xp) if keep_gates else None
    plan = forward_plan(hidden, rows, compute_dtype.itemsize, _sms(dev))
    cs, hcp, rb, k_res = plan
    streamed = streams(plan, hidden)
    # A streamed plan reads Wh as its blocks' slices (bulk copies).
    xp = _aligned(xp)
    w = forward_weights(wh, cs, hcp, compute_dtype) if streamed else _aligned(wh.to(compute_dtype))
    cuda_build.check(
        cuda_build.load().wf_lstm_stack_forward_recurrence(_SCAN_FWD.pack(
            cuda_build.dtype_code(compute_dtype), cs, hcp, rb, xp.data_ptr(),
            0 if gates is None else gates.data_ptr(), w.data_ptr(), g4, 0, h_all.data_ptr(),
            c_all.data_ptr(), 1, 0, 1.0, 0, 0, t_len, rows, hidden, cuda_build.stream_ptr(dev),
            1, *[0] * 8, k_res)),
        f"LSTM recurrence ({_plan_text(plan, hidden)})",
    )
    lstm_recurrence.launches += 1
    lstm_recurrence.streamed_launches += streamed
    return h_all, c_all, gates


@dataclasses.dataclass(frozen=True)
class ScanBackwardPieces:
    """recurrence(g, gates, c_all, wh, compute_dtype, out): the backward
    recurrence from the gradient g [T, R, H] of h_all, the activated gates
    [T, R, 4H] and c_all [T, R, H] (float32) into dgates out [T, R, 4H];
    product_tn: `gemm_tn`'s signature; sum_splits(part [S, M, N], out [M, N],
    what): out = the sum over S."""

    recurrence: Callable
    product_tn: Callable
    sum_splits: Callable


def scan_backward_schedule(g, h_all, c_all, gates, wh, compute_dtype,
                           pieces: ScanBackwardPieces):
    """Row 19's function (JAX `_recurrence_bwd`'s outputs: dxp = dgates [T,
    B, 4H] and dwh [H, 4H], in the accumulation dtype) by csrc/lstm_scan.cu's
    schedule on `pieces`: the recurrence, then dwh = round(h_prev)^T @
    round(dgates) over every step and row as K-split partials, added in
    split order. h_prev is h_all's first (T-1) x B rows at a row offset of B
    (h_{-1} = 0), both operands rounded once (bfloat16: h_all is float32),
    h's columns zero-padded to a multiple of 8 (the TN core's M); the split
    rows make one wave of the core (`wave_split_rows`)."""
    acc = accum_dtype(compute_dtype)
    dev = h_all.device
    t_len, rows, hidden = h_all.shape
    g4 = 4 * hidden
    steps = t_len * rows
    dgates = torch.empty((t_len, rows, g4), dtype=acc, device=dev)
    pieces.recurrence(g, gates, c_all, wh, compute_dtype, dgates)
    h_pad = -(-hidden // NN_MULTIPLE) * NN_MULTIPLE
    h_prev = h_all[:-1].reshape(steps - rows, hidden).to(compute_dtype)
    if h_pad != hidden:
        h_prev = F.pad(h_prev, (0, h_pad - hidden))
    split_rows = wave_split_rows(steps, hidden, g4, 1, _sms(dev) if dev.type == "cuda" else 132)
    part = torch.empty((tn_splits(steps, split_rows), h_pad, g4), dtype=acc, device=dev)
    pieces.product_tn(h_prev, dgates.view(steps, g4).to(compute_dtype), part,
                      compute_dtype=compute_dtype, split_rows=split_rows, a_row_offset=rows,
                      what="LSTM recurrence weight gradient")
    dwh = torch.empty((hidden, g4), dtype=acc, device=dev)
    pieces.sum_splits(part[:, :hidden], dwh, "LSTM recurrence weight gradient partials")
    return dgates, dwh


def _recurrence_card(g, gates, c_all, wh, compute_dtype, out):
    return launch_recurrence(cuda_build.load().wf_lstm_scan_bwd, "LSTM recurrence backward",
                             _aligned(g.to(torch.float32)), gates, c_all, wh, compute_dtype, out)


def _recurrence_plain(g, gates, c_all, wh, compute_dtype, out):
    return out.copy_(scan_backward_plain(g, gates, c_all, wh, compute_dtype))


CARD_PIECES = ScanBackwardPieces(_recurrence_card, gemm_tn, sum_splits)
PLAIN_PIECES = ScanBackwardPieces(_recurrence_plain, gemm_tn_plain, sum_splits_plain)

# Row 19's launch arguments, packed as csrc/lstm_scan.cu's `ScanBackwardLaunch`.
_SCAN_BWD = struct.Struct("<22q")


def scan_backward(g: torch.Tensor, h_all, c_all, gates, wh: torch.Tensor,
                  compute_dtype: torch.dtype):
    """Row 19 on a CUDA tensor, from the gradient g [T, B, H] of h_all and
    row 18's residuals (h_all, c_all, gates float32): -> (dxp = dgates [T, B,
    4H], dwh [H, 4H]), float32, by `scan_backward_schedule`'s schedule
    enqueued by one C call (csrc/lstm_scan.cu): Wh^T's layout for the
    recurrence's plan, the recurrence, the rounding (bfloat16) or padding (H
    % 8) of its operands, dwh's TN partials and their sum."""
    t_len, rows, hidden = h_all.shape
    g4 = 4 * hidden
    steps = t_len * rows
    dev = h_all.device
    sms = _sms(dev)
    plan = recurrence_plan(hidden, rows, compute_dtype.itemsize, sms)
    cs, hcp, rb, k_res = plan
    split_rows = wave_split_rows(steps, hidden, g4, 1, sms)
    h_pad = -(-hidden // NN_MULTIPLE) * NN_MULTIPLE
    bf16 = compute_dtype is torch.bfloat16
    round_h = (bf16 or h_pad != hidden) and t_len > 1  # h_prev rounded or padded
    wts = torch.empty((cs, g4, hcp), dtype=compute_dtype, device=dev)
    h_round = (torch.empty((steps - rows, h_pad), dtype=compute_dtype, device=dev) if round_h
               else None)
    dg_round = torch.empty((steps, g4), dtype=compute_dtype, device=dev) if bf16 else None
    part = torch.empty((tn_splits(steps, split_rows), h_pad, g4), dtype=torch.float32, device=dev)
    g, wh = _aligned(g.to(torch.float32)), _aligned(wh)
    dgates = torch.empty_like(gates)
    dwh = torch.empty((hidden, g4), dtype=torch.float32, device=dev)
    err = cuda_build.load().wf_lstm_scan_backward(_SCAN_BWD.pack(
        cuda_build.dtype_code(compute_dtype), cs, hcp, rb, g.data_ptr(), gates.data_ptr(),
        c_all.data_ptr(), wh.data_ptr(), h_all.data_ptr(), wts.data_ptr(), _ptr(h_round),
        _ptr(dg_round), part.data_ptr(), dgates.data_ptr(), dwh.data_ptr(), t_len, rows, hidden, h_pad,
        split_rows, cuda_build.stream_ptr(dev), k_res))
    if err < 0:
        raise ValueError(f"LSTM recurrence weight gradient: gemm_tn takes {_NN_REFUSALS[err]}")
    cuda_build.check(err, f"LSTM recurrence backward ({_plan_text(plan, g4)}; {split_rows} "
                          f"rows a weight-gradient split)")
    lstm_recurrence.backward_launches += 1
    lstm_recurrence.backward_streamed_launches += streams(plan, g4)
    lstm_recurrence.backward_gemm_tn_launches += 1
    gemm_tn.launches += 1
    return dgates, dwh


class _LstmRecurrence(torch.autograd.Function):
    """Rows 18 and 19 as one differentiable op over (xp, wh)."""

    @staticmethod
    def forward(ctx, xp, wh, compute_dtype, keep_gates):
        h_all, c_all, gates = scan_forward(xp, wh, compute_dtype, keep_gates)
        ctx.compute_dtype, ctx.wh_dtype = compute_dtype, wh.dtype
        ctx.save_for_backward(wh, h_all, c_all, gates)
        return h_all

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        wh, h_all, c_all, gates = ctx.saved_tensors
        if gates is None:
            raise RuntimeError("the LSTM recurrence ran without autograd; it has no backward")
        dgates, dwh = scan_backward(g, h_all, c_all, gates, wh, ctx.compute_dtype)
        return dgates, dwh.to(ctx.wh_dtype), None, None


def lstm_recurrence(
    xp: torch.Tensor, wh: torch.Tensor, *, compute_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Recurrent half of an LSTM layer: xp [T, B, 4H] (float32, float64 under
    float64), wh [H, 4H] -> h_all [T, B, H] in xp's dtype, differentiable
    (first order on a card)."""
    if xp.device.type == "cpu" or compute_dtype == torch.float64:
        return lstm_recurrence_plain(xp, wh, compute_dtype)
    if xp.device.type != "cuda":
        raise TypeError(f"no LSTM recurrence kernel for device {xp.device}")
    cuda_build.dtype_code(compute_dtype)
    if xp.dim() != 3 or wh.dim() != 2:
        raise ValueError(f"xp must be [T, B, 4H] and wh [H, 4H], got {list(xp.shape)}, "
                         f"{list(wh.shape)}")
    hidden = wh.shape[0]
    if xp.shape[2] != 4 * hidden or wh.shape[1] != 4 * hidden:
        raise ValueError(f"xp {list(xp.shape)} and wh {list(wh.shape)} disagree on 4H")
    if hidden % 4:
        raise ValueError(f"the recurrence kernel takes hidden widths that are multiples "
                         f"of 4, got {hidden}")
    if hidden % 8 and compute_dtype == torch.bfloat16:
        raise ValueError(f"the recurrence kernel takes bfloat16 compute at hidden widths that "
                         f"are multiples of 8, got {hidden}")
    if xp.dtype != torch.float32 or wh.dtype != torch.float32 or wh.device != xp.device:
        raise TypeError("xp and wh must be float32 on the same device")
    # The gates are the backward's residual: stored only when one will run.
    keep_gates = torch.is_grad_enabled() and (xp.requires_grad or wh.requires_grad)
    return _LstmRecurrence.apply(xp.contiguous(), wh, compute_dtype, keep_gates)


lstm_recurrence.launches = 0  # forwards run through the CUDA kernel (row 18)
lstm_recurrence.backward_launches = 0  # backwards run through the kernels (row 19)
lstm_recurrence.backward_gemm_tn_launches = 0  # row 19's dwh products on the TN core
# Forwards and backwards on a streamed plan (past the clusters that hold Wh).
lstm_recurrence.streamed_launches = 0
lstm_recurrence.backward_streamed_launches = 0
