"""Second-order (R-operator) ops of the fused LSTM stack, for the
Hessian-vector products of second-order MAML (train/so_fused.py).

Two `torch.autograd.Function`s make the stack's gradient
forward-differentiable, so that `torch.func.jvp` of a gradient composed
from them computes the exact Hessian-vector product:

  * `fwd_op`: the training forward (kernel row 4) -> (h_last, h_all, c_all,
    gates); its `jvp` is the tangent forward (row 10, `hvp_stack_fwd`);
  * `bwd_op`: the training backward (row 5) -> (dx, [dwcat_l], db); its
    `jvp` is the tangent of the backward (row 11, `hvp_stack_bwd`).

Forward mode only: neither has a `backward` (the second-order inner step
only ever jvp's them). Each `forward` runs the primal once and keeps what the
tangent kernels read (the forward's activated gates; the backward's dh, dc
and dgates of every stage), so a `jvp` computes tangents only, layer by
layer: row 10 by `hvp_forward_schedule` (the tangent forward recurrence of
csrc/lstm_scan_fwd_tan.cu and the GEMM core, csrc/gemm_nn.cu), row 11 by
`hvp_backward_schedule` (the tangent recurrence of csrc/lstm_scan_tan.cu
and the GEMM core).

On a CUDA tensor at float32 / bfloat16 these run the hand-written kernels,
and a shape or dtype they do not take raises. On a CPU tensor or under
float64 they run the plain PyTorch versions, `hvp_fwd_plain` and
`hvp_bwd_plain`, which compute the primal and its tangent step by step as
the JAX package's kernels do.

Counterpart of `weatherforecast_stgcn_maml_tpu/ops/fused_lstm_hvp.py`
(`hvp_stack_ops`; Pallas bodies `_hvpfwd_kernel_m` and `_hvpbwd_kernel_m`).
Layouts are the JAX package's: x [T, B, C] time-major, wcat_l = [[wx_l],
[wh_l]] [K_l, 4H] (one tensor a layer), b2d [L, 4H], int8 masks [L-1, T, B,
H] with the 1/keep scale folded in.
"""

from __future__ import annotations

import dataclasses
import functools
import struct
from typing import Callable, Sequence

import torch

from weatherforecast_stgcn_maml_tpu_torch.models.common import (
    accum_dtype,
    apply_mask,
    as_operand,
)
from weatherforecast_stgcn_maml_tpu_torch.ops import cuda_build
from weatherforecast_stgcn_maml_tpu_torch.ops.fused_lstm_stack import (
    _cluster_plan,
    _ptr,
    _sms,
    recurrence_weights,
    scan_fwd_smem,
    scan_smem,
    train_backward,
    train_forward,
)
from weatherforecast_stgcn_maml_tpu_torch.ops.gemm import (
    _NN_REFUSALS,
    gemm_nn,
    gemm_nn_plain,
    gemm_tn,
    gemm_tn_plain,
    sum_splits,
    sum_splits_plain,
    tn_splits,
    wave_split_rows,
)


def _plain(x: torch.Tensor, compute_dtype: torch.dtype) -> bool:
    return x.device.type == "cpu" or compute_dtype == torch.float64


def _gate_slopes(a: torch.Tensor, hidden: int) -> torch.Tensor:
    """d activated gate / d pre-activation, from the activated gates."""
    i, f, g, o = a.split(hidden, -1)
    return torch.cat([i * (1 - i), f * (1 - f), 1 - g * g, o * (1 - o)], -1)


def hvp_fwd_plain(
    x: torch.Tensor, wcat: Sequence[torch.Tensor], b2d: torch.Tensor,
    masks: torch.Tensor | None, keep: float, compute_dtype: torch.dtype,
    tx: torch.Tensor | None = None, twcat: Sequence[torch.Tensor] | None = None,
    tb2d: torch.Tensor | None = None,
):
    """Plain version of rows 4 and 10: the stack forward at (x, wcat, b2d)
    and, given tangents (tx, twcat, tb2d), its directional derivative, step
    by step as `_hvpfwd_kernel_m` computes them.

    Returns (h_last, h_all, c_all, gates) and, with tangents, (th_last,
    th_all, tc_all, tgates) after them: h_all, c_all [L, T, B, H] (and their
    tangents) in the compute dtype, the activated gates (i, f, g, o) [L, T,
    B, 4H] and h_last [B, H] (and their tangents) in the accumulation dtype.
    """
    ad = accum_dtype(compute_dtype)
    t_len, rows, _ = x.shape
    hidden = b2d.shape[1] // 4
    tangent = tx is not None
    inp = x.to(ad)
    tinp = tx.to(ad) if tangent else None
    outs = {k: [] for k in ("h", "c", "a", "th", "tc", "ta")}
    for l, w_f in enumerate(wcat):
        w = as_operand(w_f, compute_dtype)
        tw = as_operand(twcat[l], compute_dtype) if tangent else None
        h = torch.zeros((rows, hidden), dtype=ad, device=x.device)
        c, th, tc = torch.zeros_like(h), torch.zeros_like(h), torch.zeros_like(h)
        seq = {k: [] for k in outs}
        for t in range(t_len):
            xh = torch.cat([as_operand(inp[t], compute_dtype), as_operand(h, compute_dtype)], -1)
            pre = xh @ w + b2d[l]
            a = torch.cat([torch.sigmoid(pre[:, :2 * hidden]),
                           torch.tanh(pre[:, 2 * hidden:3 * hidden]),
                           torch.sigmoid(pre[:, 3 * hidden:])], -1)
            i, f, g, o = a.split(hidden, -1)
            c_prev, c = c, f * c + i * g
            tch = torch.tanh(c)
            h = o * tch
            seq["h"].append(h)
            seq["c"].append(c)
            seq["a"].append(a)
            if tangent:
                txh = torch.cat([as_operand(tinp[t], compute_dtype),
                                 as_operand(th, compute_dtype)], -1)
                ta = _gate_slopes(a, hidden) * (txh @ w + xh @ tw + tb2d[l])
                ti, tf, tg, to = ta.split(hidden, -1)
                tc = tf * c_prev + f * tc + ti * g + i * tg
                th = to * tch + o * (1 - tch * tch) * tc
                seq["th"].append(th)
                seq["tc"].append(tc)
                seq["ta"].append(ta)
        for k, v in seq.items():
            if v:
                outs[k].append(torch.stack(v))
        if l + 1 < len(wcat):
            inp = outs["h"][-1]
            tinp = outs["th"][-1] if tangent else None
            if masks is not None:
                inp = apply_mask(inp, masks[l], keep)
                tinp = apply_mask(tinp, masks[l], keep) if tangent else None
    res = (outs["h"][-1][-1], torch.stack(outs["h"]).to(compute_dtype),
           torch.stack(outs["c"]).to(compute_dtype), torch.stack(outs["a"]))
    if tangent:
        res += (outs["th"][-1][-1], torch.stack(outs["th"]).to(compute_dtype),
                torch.stack(outs["tc"]).to(compute_dtype), torch.stack(outs["ta"]))
    return res


def _shifted(seq: torch.Tensor) -> torch.Tensor:
    """[T, ...] -> the same one step later, zero at t = 0 (h_{t-1})."""
    return torch.cat([torch.zeros_like(seq[:1]), seq[:-1]])


def hvp_bwd_plain(
    g: torch.Tensor, x: torch.Tensor, h_all: torch.Tensor, c_all: torch.Tensor,
    gates: torch.Tensor, wcat: Sequence[torch.Tensor], masks: torch.Tensor | None,
    keep: float, compute_dtype: torch.dtype,
    tg: torch.Tensor | None = None, tx: torch.Tensor | None = None,
    th_all: torch.Tensor | None = None, tc_all: torch.Tensor | None = None,
    tgates: torch.Tensor | None = None, twcat: Sequence[torch.Tensor] | None = None,
):
    """Plain version of rows 5 and 11: the stack backward of the gradient g
    [B, H] of the top layer's last h, and, given the tangents of its inputs,
    its directional derivative, step by step as `_hvpbwd_kernel_m` computes
    them (reading the forward's activated gates and their tangents where the
    TPU kernel recomputes them).

    Returns (dx, [dwcat_l], db, dgates, dh_all, dc_all) and, with tangents,
    (tdx, [tdwcat_l], tdb) after them, all in the accumulation dtype: dgates
    [L, T, B, 4H] and each stage's dh, dc [L, T, B, H] are the backward's
    intermediates the CUDA route hands to row 11.
    """
    ad = accum_dtype(compute_dtype)
    t_len, rows, c_in = x.shape
    n_layers = len(wcat)
    hidden = gates.shape[-1] // 4
    tangent = tg is not None
    op = lambda v: as_operand(v, compute_dtype)  # noqa: E731
    ws = [op(w) for w in wcat]
    tws = [op(w) for w in twcat] if tangent else None
    c_all, gates = c_all.to(ad), gates.to(ad)
    if tangent:
        tc_all, tgates = tc_all.to(ad), tgates.to(ad)
    zero = torch.zeros((rows, hidden), dtype=ad, device=x.device)
    dh_c, dc_c = [zero] * n_layers, [zero] * n_layers
    tdh_c, tdc_c = [zero] * n_layers, [zero] * n_layers
    st = {k: [[None] * t_len for _ in range(n_layers)] for k in ("dg", "dh", "dc", "tdg")}
    dx, tdx = [None] * t_len, [None] * t_len
    for t in range(t_len - 1, -1, -1):
        above = t_above = None
        for l in range(n_layers - 1, -1, -1):
            i, f, gg, o = gates[l, t].split(hidden, -1)
            c_prev = c_all[l, t - 1] if t > 0 else zero
            dh = dh_c[l]
            if l == n_layers - 1 and t == t_len - 1:
                dh = dh + g.to(ad)
            if above is not None:
                dh = dh + above
            tch = torch.tanh(c_all[l, t])
            om = 1 - tch * tch
            dc = dc_c[l] + dh * o * om
            s = _gate_slopes(gates[l, t], hidden)
            si, sf, sg, so = s.split(hidden, -1)
            dgt = torch.cat([dc * gg * si, dc * c_prev * sf, dc * i * sg, dh * tch * so], -1)
            dc_c[l] = dc * f
            dxh = op(dgt) @ ws[l].t()
            kin = c_in if l == 0 else hidden
            dh_c[l] = dxh[:, kin:]
            st["dg"][l][t], st["dh"][l][t], st["dc"][l][t] = dgt, dh, dc
            if tangent:
                ti, tf, tgg, to = tgates[l, t].split(hidden, -1)
                tc_prev = tc_all[l, t - 1] if t > 0 else zero
                tdh = tdh_c[l]
                if l == n_layers - 1 and t == t_len - 1:
                    tdh = tdh + tg.to(ad)
                if t_above is not None:
                    tdh = tdh + t_above
                ttc = om * tc_all[l, t]
                tdc = tdc_c[l] + tdh * o * om + dh * to * om - dh * o * (2 * tch * ttc)
                tdgt = torch.cat([
                    tdc * gg * si + dc * tgg * si + dc * gg * (1 - 2 * i) * ti,
                    tdc * c_prev * sf + dc * tc_prev * sf + dc * c_prev * (1 - 2 * f) * tf,
                    tdc * i * sg + dc * ti * sg - dc * i * (2 * gg * tgg),
                    tdh * tch * so + dh * ttc * so + dh * tch * (1 - 2 * o) * to,
                ], -1)
                tdc_c[l] = tdc * f + dc * tf
                tdxh = op(tdgt) @ ws[l].t() + op(dgt) @ tws[l].t()
                tdh_c[l] = tdxh[:, kin:]
                st["tdg"][l][t] = tdgt
            if l == 0:
                dx[t] = dxh[:, :c_in]
                if tangent:
                    tdx[t] = tdxh[:, :c_in]
            else:
                mk = masks[l - 1, t] if masks is not None else None
                above = dxh[:, :kin] if mk is None else apply_mask(dxh[:, :kin], mk, keep)
                if tangent:
                    t_above = tdxh[:, :kin] if mk is None else apply_mask(tdxh[:, :kin], mk, keep)
    dgates = torch.stack([torch.stack(s) for s in st["dg"]])
    res = (torch.stack(dx), *_weight_grads(x, h_all, dgates, masks, keep, compute_dtype),
           dgates, torch.stack([torch.stack(s) for s in st["dh"]]),
           torch.stack([torch.stack(s) for s in st["dc"]]))
    if tangent:
        tdgates = torch.stack([torch.stack(s) for s in st["tdg"]])
        tdw, tdb = _weight_grads(x, h_all, tdgates, masks, keep, compute_dtype)
        tdw2, _ = _weight_grads(tx, th_all, dgates, masks, keep, compute_dtype)
        res += (torch.stack(tdx), [a + b for a, b in zip(tdw, tdw2)], tdb)
    return res


def _weight_grads(x, h_all, dgates, masks, keep, compute_dtype):
    """([dwcat_l], db) = ([inp | h_prev]^T @ dgates_l summed over steps and
    rows, colsum(dgates_l)), operands rounded to the compute dtype."""
    ad = accum_dtype(compute_dtype)
    n_layers, t_len, rows, g4 = dgates.shape
    dws = []
    for l in range(n_layers):
        if l == 0:
            inp = x.to(ad)
        else:
            inp = h_all[l - 1].to(ad)
            if masks is not None:
                inp = apply_mask(inp, masks[l - 1], keep)
        xh = torch.cat([inp, _shifted(h_all[l].to(ad))], -1)
        xh = as_operand(xh, compute_dtype).reshape(t_len * rows, -1)
        dws.append(xh.t() @ as_operand(dgates[l], compute_dtype).reshape(t_len * rows, g4))
    return dws, dgates.sum((1, 2))


def _check(x, wcat, masks, compute_dtype):
    """Raise on what the stack kernels do not take (a CUDA tensor)."""
    t_len, rows, c_in = x.shape
    hidden = wcat[0].shape[1] // 4
    if x.device.type != "cuda":
        raise TypeError(f"no LSTM kernel for device {x.device}")
    cuda_build.dtype_code(compute_dtype)
    for l, w in enumerate(wcat):
        kin = c_in if l == 0 else hidden
        if w.shape != (kin + hidden, 4 * hidden) or w.dtype != torch.float32 or w.device != x.device:
            raise ValueError(f"LSTM layer {l} weights must be float32 [{kin + hidden}, "
                             f"{4 * hidden}] on the input's device")
    if c_in % 8 or hidden % 8 or c_in > 7 * hidden:
        raise ValueError(
            f"the LSTM second-order kernels take widths that are multiples of 8 "
            f"with input <= 7 x hidden, got {c_in} and {hidden}"
        )
    if masks is not None and (
        masks.dtype != torch.int8 or masks.device != x.device
        or masks.shape != (len(wcat) - 1, t_len, rows, hidden) or not masks.is_contiguous()
    ):
        raise ValueError(f"masks must be contiguous int8 [{len(wcat) - 1}, {t_len}, {rows}, "
                         f"{hidden}] on the input's device")


def stack_fwd(x, wcat, b2d, masks, keep, compute_dtype):
    """Row 4: (h_last, h_all, c_all, gates) of the stack forward."""
    if _plain(x, compute_dtype):
        return hvp_fwd_plain(x, wcat, b2d, masks, keep, compute_dtype)
    _check(x, wcat, masks, compute_dtype)
    return train_forward(x, masks, keep, compute_dtype, b2d, wcat)


def stack_bwd(g, x, h_all, c_all, gates, wcat, masks, keep, compute_dtype):
    """Row 5 with its carries: (dx, [dwcat_l], db, dgates, dh_all, dc_all)."""
    if _plain(x, compute_dtype):
        return hvp_bwd_plain(g, x, h_all, c_all, gates, wcat, masks, keep, compute_dtype)
    _check(x, wcat, masks, compute_dtype)
    return train_backward(g, x, h_all, c_all, gates, wcat, masks, keep, compute_dtype,
                          carries=True)


# Row 10 runs layer by layer, on row 4's schedule (fused_lstm_stack.
# forward_schedule), so that only the tangent carry through Wh is on the
# serial chain (the TPU kernel walks all T x L stages as one chain, one
# [tin | th | in | h] @ [[W], [tW]] contraction a stage). Of the tangent
# pre-activation
#     ds_l[t] = round(tin_l[t]) @ round(Wx_l)
#             + round([in_l[t] | h_l[t-1]]) @ round(tW_l)
#             + round(th_l[t-1]) @ round(Wh_l) + tb_l
# (tW_l = twcat_l = [[tWx_l], [tWh_l]]) only the last term depends on the
# chain. For l = 0 .. L-1:
#   1. the off-chain terms: one product of two operand pairs, tin_l @ Wx_l
#      and [in_l | h_l a step back] (K-concatenated, h_{-1} = 0) @ tW_l,
#      into the layer's tangent gates [T, R, 4H], no bias. Both weights are
#      read as they are stored (W_l's first rows, the whole of tW_l): on a
#      card no weight copy in float32, one cast in bfloat16;
#   2. the tangent forward recurrence (csrc/lstm_scan_fwd_tan.cu) over those
#      in place: + tb_l + round(th_{t-1}) @ round(Wh_l), the tangent cell
#      from row 4's activated gates and c_all: the gates' tangents ta, th_l
#      and tc_l; below the top layer the next layer's operands [tin | in |
#      h a step back] = [round(th * mask / keep) | round(round(h_all[l]) *
#      mask / keep) | h_all[l+1] a step back] (tin from the float32 th,
#      JAX's rounding point; in from row 4's stored h, row 11's choice:
#      JAX's value in float32, rounded from round(h) in bfloat16), at the
#      top layer the last th.
# Layer 0's operands are tx and [x | h_all[0] a step back] (one pack launch
# on a card). JAX sums the four products in one contraction; here three
# sums apart, a float32 reordering (`HVP_TOL` in chip_smoke.py: 1e-4
# relative). On a card one C call (`_hvp_forward_card`) enqueues the pack
# and all 2L launches; `hvp_forward_schedule` states the schedule on
# swappable pieces: the kernels a launch each (`CARD_HVP_FWD_PIECES`:
# timing by part) or their plain versions (`PLAIN_HVP_FWD_PIECES`: the CPU
# tests).


@dataclasses.dataclass(frozen=True)
class HvpFwdPieces:
    """product: `gemm_nn`'s signature (ops/gemm.py); recurrence(tgates,
    gates, c, h, h_next, wh, tb, compute_dtype, th_out, tc_out, mask=None,
    inv_keep=1.0, next_in=None, th_last=None): one layer's tangent forward
    recurrence (the arguments as csrc/lstm_scan_fwd_tan.cu's `ScanFwdTan`,
    wh [H, 4H], tb [4H]) over tgates [T, R, 4H] in place (in: the off-chain
    products; out: the gates' tangents), into th_out and tc_out [T, R, H];
    with next_in [T, R, 3H] also the next layer's [tin | in | h_next a step
    back] (tin and in times mask * inv_keep where a mask is given); the last
    th into th_last [R, H] where given."""

    product: Callable
    recurrence: Callable


def hvp_forward_schedule(x, tx, wcat, twcat, tb2d, masks, keep, compute_dtype, res,
                         pieces: HvpFwdPieces):
    """Row 10's function (`hvp_stack_fwd`'s outputs: th_last [B, H], th_all,
    tc_all [L, T, B, H] in the compute dtype, tgates [L, T, B, 4H]; th_last
    and tgates in the accumulation dtype) by the schedule above on `pieces`,
    from res = (h_all, c_all, gates) of row 4 at the same point: x, tx [T, B,
    C]; wcat_l, twcat_l [K_l + H, 4H]; tb2d [L, 4H]; masks [L-1, T, B, H] or
    None."""
    h_all, c_all, gates = res
    acc = accum_dtype(compute_dtype)
    dev = x.device
    t_len, rows, c_in = x.shape
    n_layers, _, _, g4 = gates.shape
    hidden = g4 // 4
    steps = t_len * rows
    th_all = torch.empty(h_all.shape, dtype=compute_dtype, device=dev)
    tc_all = torch.empty_like(th_all)
    tgates = torch.empty(gates.shape, dtype=acc, device=dev)
    th_last = torch.empty((rows, hidden), dtype=acc, device=dev)
    # The next layer's [tin | in | h a step back], one buffer for every layer
    # above 0.
    next_in = (torch.empty((t_len, rows, 3 * hidden), dtype=compute_dtype, device=dev)
               if n_layers > 1 else None)
    tin, inp = tx, torch.cat([x.to(acc), _shifted(h_all[0]).to(acc)], -1)
    for l in range(n_layers):
        k = c_in if l == 0 else hidden
        pieces.product(tin.reshape(steps, k), wcat[l][:k], a2=inp.reshape(steps, k + hidden),
                       b2=twcat[l], compute_dtype=compute_dtype, out=tgates[l].view(steps, g4),
                       what=f"LSTM layer {l} tangent input product")
        top = l == n_layers - 1
        pieces.recurrence(tgates[l], gates[l], c_all[l], h_all[l], None if top else h_all[l + 1],
                          wcat[l][k:], tb2d[l], compute_dtype, th_all[l], tc_all[l],
                          mask=None if top or masks is None else masks[l], inv_keep=1.0 / keep,
                          next_in=None if top else next_in, th_last=th_last if top else None)
        if not top:
            tin, inp = next_in[..., :hidden], next_in[..., hidden:]
    return th_last, th_all, tc_all, tgates


def _tangent_forward_recurrence_plain(tgates, gates, c, h, h_next, wh, tb, compute_dtype,
                                      th_out, tc_out, mask=None, inv_keep=1.0, next_in=None,
                                      th_last=None):
    acc = tgates.dtype
    t_len, rows, g4 = tgates.shape
    hidden = g4 // 4
    whc = as_operand(wh, compute_dtype)
    th = torch.zeros((rows, hidden), dtype=acc, device=tgates.device)
    tc, c_prev = torch.zeros_like(th), torch.zeros_like(th)
    for t in range(t_len):
        a = gates[t].to(acc)
        ta = _gate_slopes(a, hidden) * ((tgates[t] + tb) + as_operand(th, compute_dtype) @ whc)
        i, f, g, o = a.split(hidden, -1)
        ti, tf, tg, to = ta.split(hidden, -1)
        c_t = c[t].to(acc)
        tc = tf * c_prev + f * tc + ti * g + i * tg
        tch = torch.tanh(c_t)
        th = to * tch + o * (1 - tch * tch) * tc
        tgates[t], th_out[t], tc_out[t] = ta, th, tc
        if next_in is not None:
            m = 1.0 if mask is None else mask[t].to(acc) * inv_keep
            next_in[t, :, :hidden] = th * m
            next_in[t, :, hidden:2 * hidden] = h[t].to(acc) * m
            next_in[t, :, 2 * hidden:] = h_next[t - 1] if t > 0 else 0
        c_prev = c_t
    if th_last is not None:
        th_last.copy_(th)
    return tgates


@functools.lru_cache(maxsize=None)
def tangent_forward_plan(hidden: int, rows: int, itemsize: int,
                         sms: int) -> tuple[int, int, int]:
    """(cs, hcp, rb) of row 10's tangent forward recurrence
    (csrc/lstm_scan_fwd_tan.cu): the forward recurrence's plan
    (`forward_plan`: its shared memory is the same) with row tiles of at most
    8 rows, so that a thread owns one (row, 4 units) and its 12 inputs a unit
    stay in registers: at H = 128 and R = 512 on 132 SMs, 2 blocks x 8 rows
    in float32, 1 block x 4 rows in bfloat16."""
    return _cluster_plan(hidden, rows, sms, 1,
                         lambda hcp, rb: scan_fwd_smem(hidden, hcp, rb, itemsize),
                         "tangent forward recurrence holds Wh", hidden, row_tiles=(2, 4, 8))[:3]


# The tangent forward recurrence's launch arguments, packed as
# csrc/lstm_scan_fwd_tan.cu's `ScanFwdTanLaunch`; the whole tangent
# forward's as its `HvpFwdLaunch`, followed by one (Wx_l, Wh_l, tW_l) triple
# a layer.
_SCAN_FWD_TAN = struct.Struct("<15qd6q")
_HVP_FWD = struct.Struct("<13qd10q")


def _tangent_forward_recurrence_card(tgates, gates, c, h, h_next, wh, tb, compute_dtype,
                                     th_out, tc_out, mask=None, inv_keep=1.0, next_in=None,
                                     th_last=None):
    t_len, rows, g4 = tgates.shape
    hidden = g4 // 4
    dev = tgates.device
    cs, hcp, rb = tangent_forward_plan(hidden, rows, compute_dtype.itemsize, _sms(dev))
    wh = wh.to(compute_dtype)
    if wh.stride(-1) != 1:
        wh = wh.contiguous()
    tb = tb.contiguous()
    cuda_build.check(
        cuda_build.load().wf_lstm_tangent_forward_recurrence(_SCAN_FWD_TAN.pack(
            cuda_build.dtype_code(compute_dtype), cs, hcp, rb, tgates.data_ptr(),
            gates.data_ptr(), c.data_ptr(), h.data_ptr(), _ptr(h_next), wh.data_ptr(),
            wh.stride(0), tb.data_ptr(), th_out.data_ptr(), tc_out.data_ptr(), _ptr(mask),
            inv_keep, _ptr(next_in), _ptr(th_last), t_len, rows, hidden,
            cuda_build.stream_ptr(dev))),
        f"LSTM tangent forward recurrence (cluster of {cs}, {hcp} weight columns a block, {rb} "
        f"rows a cluster)",
    )
    _tangent_forward_recurrence_card.launches += 1
    return tgates


_tangent_forward_recurrence_card.launches = 0  # launches of the tangent forward recurrence alone

CARD_HVP_FWD_PIECES = HvpFwdPieces(gemm_nn, _tangent_forward_recurrence_card)
PLAIN_HVP_FWD_PIECES = HvpFwdPieces(gemm_nn_plain, _tangent_forward_recurrence_plain)


def _hvp_forward_card(x, tx, wcat, twcat, tb2d, masks, keep, compute_dtype, res):
    """`hvp_forward_schedule` on the card: the pack of [x | h_0 a step back]
    and its 2L launches enqueued by one C call (csrc/lstm_scan_fwd_tan.cu) ->
    (th_last [B, H] float32, th_all, tc_all in the compute dtype, tgates
    float32)."""
    h_all, c_all, gates = res
    dev = x.device
    t_len, rows, c_in = x.shape
    n_layers, g4 = tb2d.shape
    hidden = g4 // 4
    x = x.to(torch.float32).contiguous()
    tx = tx.to(torch.float32).contiguous()
    # The weights in the compute dtype: float32 as they are, else one cast of
    # all layers (each layer's rows stay 16-byte aligned: 4H columns).
    ws = [*wcat, *twcat]
    if compute_dtype is torch.float32:
        ws = [w.contiguous() for w in ws]
    else:
        ws = torch.cat(ws).to(compute_dtype).split([w.shape[0] for w in ws])
    row_bytes = g4 * compute_dtype.itemsize
    layers = []
    for l in range(n_layers):
        w = ws[l].data_ptr()
        k = c_in if l == 0 else hidden
        layers += [w, w + k * row_bytes, ws[n_layers + l].data_ptr()]
    th_all = torch.empty(h_all.shape, dtype=compute_dtype, device=dev)
    tc_all = torch.empty_like(th_all)
    tgates = torch.empty(gates.shape, dtype=torch.float32, device=dev)
    th_last = torch.empty((rows, hidden), dtype=torch.float32, device=dev)
    pack = torch.empty((t_len, rows, c_in + hidden), dtype=compute_dtype, device=dev)
    next_in = (torch.empty((t_len, rows, 3 * hidden), dtype=compute_dtype, device=dev)
               if n_layers > 1 else None)
    with_masks = masks is not None and n_layers > 1
    tb = tb2d.contiguous()
    cs, hcp, rb = tangent_forward_plan(hidden, rows, compute_dtype.itemsize, _sms(dev))
    launch = _HVP_FWD.pack(
        cuda_build.dtype_code(compute_dtype), cs, hcp, rb, x.data_ptr(), tx.data_ptr(),
        pack.data_ptr(), _ptr(next_in), h_all.data_ptr(), c_all.data_ptr(), gates.data_ptr(),
        tb.data_ptr(), masks.data_ptr() if with_masks else 0, 1.0 / keep, th_all.data_ptr(),
        tc_all.data_ptr(), tgates.data_ptr(), th_last.data_ptr(), t_len, rows, c_in, hidden,
        n_layers, cuda_build.stream_ptr(dev))
    err = cuda_build.load().wf_lstm_hvp_forward(launch + struct.pack(f"<{3 * n_layers}q", *layers))
    if err < 0:
        raise ValueError(f"LSTM second-order forward: its input product takes "
                         f"{_NN_REFUSALS[err]}")
    cuda_build.check(err, f"LSTM second-order forward (tangent recurrences: cluster of {cs}, "
                          f"{hcp} weight columns a block, {rb} rows a cluster)")
    gemm_nn.launches += n_layers
    return th_last, th_all, tc_all, tgates


def hvp_stack_fwd(x, tx, wcat, twcat, b2d, tb2d, masks, keep, compute_dtype, res=None):
    """Row 10: (th_last, th_all, tc_all, tgates), the tangent of the stack
    forward at (x, wcat, b2d) along (tx, twcat, tb2d). On a CUDA tensor
    `hvp_forward_schedule` on the kernels (per layer one gemm_nn product and
    one tangent forward recurrence, all from one C call) reads `res` =
    (h_all, c_all, gates) of row 4 at the same point; the plain version
    recomputes them."""
    if _plain(x, compute_dtype):
        return hvp_fwd_plain(x, wcat, b2d, masks, keep, compute_dtype, tx, twcat, tb2d)[4:]
    _check(x, wcat, masks, compute_dtype)
    out = _hvp_forward_card(x, tx, wcat, twcat, tb2d, masks, keep, compute_dtype, res)
    fwd = hvp_stack_fwd
    fwd.launches += 1
    fwd.recurrence_launches += len(wcat)
    fwd.gemm_nn_launches += len(wcat)
    return out


hvp_stack_fwd.launches = 0  # tangent forwards run through the kernels (row 10)
# Row 10's pieces: its tangent forward recurrences and gemm_nn products (one
# of each a layer).
hvp_stack_fwd.recurrence_launches = 0
hvp_stack_fwd.gemm_nn_launches = 0


# Row 11 on a card runs layer by layer, on row 5's schedule
# (fused_lstm_stack.backward_schedule), so that only the tangent carries
# through Wh^T are on the serial chain (the TPU kernel walks all T x L stages
# as one chain, one [tdgates | dgates] @ [[W], [tW]]^T contraction a stage).
# The tdh carry into t-1 is round(tdgates_t) @ round(Wh)^T + round(dgates_t)
# @ round(tWh)^T, and its second term does not depend on the chain. For l =
# L-1 .. 0:
#   1. p_l = round(dgates_l[t+1]) @ round(tWh_l)^T for t < T-1: one product
#      off the chain, from row 5's stored gate gradients;
#   2. the tangent recurrence (csrc/lstm_scan_tan.cu) from tg_l, the tangent
#      of the gradient of the layer's h sequence (zero but tg at the top
#      layer's last step, the input tangent of the layer above below it),
#      p_l, row 4's gates, row 10's tangents of them and of c, row 5's dh
#      and dc: tdgates_l into one buffer every layer reuses, and the bias
#      tangent tdb_l (a partial a row tile, then one `sum_splits`);
#   3. the input tangent round(tdgates_l) @ round(Wx_l)^T + round(dgates_l)
#      @ round(tWx_l)^T: one product of two operand pairs, times the mask and
#      1/keep (the mask epilogue): tg_{l-1}, or tdx at l = 0;
#   4. the weight-gradient tangents tdWx_l = round(in_l)^T round(tdgates_l) +
#      round(tin_l)^T round(dgates_l) and tdWh_l = round(h_{t-1})^T
#      round(tdgates_l) + round(th_{t-1})^T round(dgates_l) over every step
#      and row: four TN products split over the T x R rows (h_{t-1} and
#      th_{t-1} at a row offset of R: zero at t = 0) into one buffer of
#      float32 partials, added in split order (`sum_splits`: no atomics).
#      in_l and tin_l are x and tx at l = 0, above it h_all[l-1] and
#      th_all[l-1] times the mask and 1/keep, rounded once.
# JAX sums [tdgates | dgates] @ [W; tW]^T in one contraction; here the two
# products are summed apart, a float32 reordering (`HVP_TOL` in
# chip_smoke.py: 1e-4 relative). The pieces are swappable: the kernels on a
# card (`CARD_TANGENT_PIECES`), their plain versions
# (`PLAIN_TANGENT_PIECES`) in the CPU tests.


@dataclasses.dataclass(frozen=True)
class TangentPieces:
    """product: `gemm_nn`'s signature (ops/gemm.py); recurrence(g, p,
    gates, tgates, c, tc, dh, dc, wh, compute_dtype, out, db): one layer's
    tangent recurrence (the arguments as csrc/lstm_scan_tan.cu's `ScanTan`,
    wh [H, 4H]) -> tdgates [T, R, 4H] into out, their column sums [4H] into
    db; product_tn: `gemm_tn`'s signature; sum_splits(part [S, M, N], out
    [M, N], what): out = the sum over S."""

    product: Callable
    recurrence: Callable
    product_tn: Callable
    sum_splits: Callable


def hvp_backward_schedule(tg, x, tx, h_all, th_all, c_all, tc_all, gates, tgates, wcat, twcat,
                          masks, keep, compute_dtype, res, pieces: TangentPieces):
    """Row 11's function (`hvp_bwd_plain`'s tangents: tdx [T, B, C],
    [tdwcat_l], tdb [L, 4H] in the accumulation dtype) by the schedule above
    on `pieces`, from res = (dgates, dh_all, dc_all) of row 5 at the same
    point. x, tx [T, B, C]; h_all, th_all, c_all, tc_all [L, T, B, H] in the
    compute dtype; gates, tgates, dgates [L, T, B, 4H] and dh_all, dc_all
    [L, T, B, H] in the accumulation dtype; wcat_l, twcat_l [K_l + H, 4H];
    masks [L-1, T, B, H] or None."""
    dgates, dh_all, dc_all = res
    acc = accum_dtype(compute_dtype)
    dev = x.device
    t_len, rows, c_in = x.shape
    n_layers, _, _, g4 = gates.shape
    hidden = g4 // 4
    steps = t_len * rows
    tdgates = torch.empty((t_len, rows, g4), dtype=acc, device=dev)  # reused by every layer
    p_l = torch.empty(((t_len - 1) * rows, hidden), dtype=acc, device=dev)
    g_l = torch.zeros((t_len, rows, hidden), dtype=acc, device=dev)
    g_l[-1] = tg
    # The input tangents of the layers below the top, in the masks' layout:
    # the mask epilogue reads the mask at the output's offsets.
    g_below = (torch.empty((n_layers - 1, t_len, rows, hidden), dtype=acc, device=dev)
               if n_layers > 1 else None)
    tdx = torch.empty((steps, c_in), dtype=acc, device=dev)
    tdb = torch.empty((n_layers, g4), dtype=acc, device=dev)
    tdwcat = [torch.empty((w.shape[0], g4), dtype=acc, device=dev) for w in wcat]

    def inputs(x0, h):  # each layer's input [T * B, K_l] in the compute dtype
        above = h[:-1]
        if masks is not None:
            above = apply_mask(above.to(acc), masks, keep)
        above = above.to(compute_dtype)
        return [x0.to(compute_dtype).reshape(steps, c_in),
                *(a.reshape(steps, hidden) for a in above)]

    ins, tins = inputs(x, h_all), inputs(tx, th_all)
    # One split plan for the four TN products of every layer: a wave of the
    # recurrent weight gradient's [H, 4H] tiles.
    split_rows = wave_split_rows(steps, hidden, g4, 1, _sms(dev) if dev.type == "cuda" else 132)
    splits = tn_splits(steps, split_rows)
    part_buf = torch.empty(2 * splits * (max(c_in, hidden) + hidden) * g4, dtype=acc, device=dev)
    for l in reversed(range(n_layers)):
        k = c_in if l == 0 else hidden
        w, tw = wcat[l].to(compute_dtype), twcat[l].to(compute_dtype)
        dg = dgates[l].reshape(steps, g4)
        if t_len > 1:
            pieces.product(dg[rows:], tw[k:].t().contiguous(), compute_dtype=compute_dtype,
                           out=p_l, what=f"LSTM layer {l} tangent carry product")
        pieces.recurrence(g_l, p_l.view(t_len - 1, rows, hidden), gates[l], tgates[l], c_all[l],
                          tc_all[l], dh_all[l], dc_all[l], w[k:], compute_dtype, tdgates, tdb[l])
        tdg = tdgates.view(steps, g4)
        pair = dict(a2=dg, b2=tw[:k].t().contiguous(), compute_dtype=compute_dtype)
        if l == 0:
            pieces.product(tdg, w[:k].t().contiguous(), out=tdx, what="LSTM input tangent",
                           **pair)
        else:
            mask = None if masks is None else masks[l - 1].reshape(steps, hidden)
            g_l = g_below[l - 1]
            pieces.product(tdg, w[:k].t().contiguous(),
                           epilogue="none" if mask is None else "mask", mask=mask,
                           scale=1.0 / keep, out=g_l.view(steps, hidden),
                           what=f"LSTM layer {l} input tangent", **pair)
        part = part_buf[:2 * splits * (k + hidden) * g4].view(2 * splits, k + hidden, g4)
        h_prev = (h_all[l, :-1].reshape(steps - rows, hidden),
                  th_all[l, :-1].reshape(steps - rows, hidden))
        for half, (inp, prev, b) in enumerate(((ins[l], h_prev[0], tdg.to(compute_dtype)),
                                               (tins[l], h_prev[1], dg.to(compute_dtype)))):
            out = part[half * splits:(half + 1) * splits]
            pieces.product_tn(inp, b, out[:, :k], compute_dtype=compute_dtype,
                              split_rows=split_rows,
                              what=f"LSTM layer {l} input weight gradient tangent")
            pieces.product_tn(prev, b, out[:, k:], compute_dtype=compute_dtype,
                              split_rows=split_rows, a_row_offset=rows,
                              what=f"LSTM layer {l} recurrent weight gradient tangent")
        pieces.sum_splits(part.view(2 * splits, 1, -1), tdwcat[l].view(1, -1),
                          f"LSTM layer {l} weight gradient tangent partials")
    return tdx.view(t_len, rows, c_in), tdwcat, tdb


def _tangent_recurrence_plain(g, p, gates, tgates, c, tc, dh, dc, wh, compute_dtype, out, db):
    acc = out.dtype
    t_len, rows, hidden = g.shape
    wht = as_operand(wh, compute_dtype).t()
    zero = torch.zeros((rows, hidden), dtype=acc, device=g.device)
    tdh_c = tdc_c = zero
    for t in reversed(range(t_len)):
        i, f, gg, o = gates[t].to(acc).split(hidden, -1)
        ti, tf, tgg, to = tgates[t].to(acc).split(hidden, -1)
        c_prev, tc_prev = (c[t - 1].to(acc), tc[t - 1].to(acc)) if t > 0 else (zero, zero)
        dh_t, dc_t = dh[t].to(acc), dc[t].to(acc)
        tch = torch.tanh(c[t].to(acc))
        om = 1 - tch * tch
        ttc = om * tc[t].to(acc)
        tdh = (g[t] + p[t] if t < t_len - 1 else g[t]) + tdh_c
        tdc = tdc_c + tdh * o * om + dh_t * to * om - dh_t * o * (2 * tch * ttc)
        si, sf, sg, so = i * (1 - i), f * (1 - f), 1 - gg * gg, o * (1 - o)
        tdgt = torch.cat([
            tdc * gg * si + dc_t * tgg * si + dc_t * gg * (1 - 2 * i) * ti,
            tdc * c_prev * sf + dc_t * tc_prev * sf + dc_t * c_prev * (1 - 2 * f) * tf,
            tdc * i * sg + dc_t * ti * sg - dc_t * i * (2 * gg * tgg),
            tdh * tch * so + dh_t * ttc * so + dh_t * tch * (1 - 2 * o) * to,
        ], -1)
        out[t] = tdgt
        tdh_c = as_operand(tdgt, compute_dtype) @ wht
        tdc_c = tdc * f + dc_t * tf
    db.copy_(out.sum(dim=(0, 1)))
    return out


@functools.lru_cache(maxsize=None)
def tangent_plan(hidden: int, rows: int, itemsize: int, sms: int) -> tuple[int, int, int]:
    """(cs, hcp, rb) of row 11's tangent recurrence (csrc/lstm_scan_tan.cu):
    the backward recurrence's plan (`recurrence_plan`: its shared memory is
    the same) with row tiles of at most 8 rows, so that a thread owns one
    (row, 4 units) and its 15 inputs a unit stay in registers: at H = 128
    and R = 512 on 132 SMs, 2 blocks x 8 rows in float32, 1 block x 4 rows
    in bfloat16."""
    return _cluster_plan(hidden, rows, sms, 1, lambda hcp, rb: scan_smem(hidden, hcp, rb, itemsize),
                         "tangent recurrence holds Wh^T", 4 * hidden, row_tiles=(2, 4, 8))[:3]


# The tangent recurrence's launch arguments, packed as csrc/lstm_scan_tan.cu's
# `ScanTanLaunch`: 20 8-byte integers (pointers as integers).
_SCAN_TAN = struct.Struct("<20q")


def _tangent_recurrence_card(g, p, gates, tgates, c, tc, dh, dc, wh, compute_dtype, out, db):
    t_len, rows, hidden = g.shape
    dev = g.device
    if not all(t.is_contiguous() for t in (g, p, gates, tgates, c, tc, dh, dc, out)):
        raise ValueError("the LSTM tangent recurrence reads and writes contiguous arrays")
    cs, hcp, rb = tangent_plan(hidden, rows, compute_dtype.itemsize, _sms(dev))
    wts = recurrence_weights(wh, cs, hcp, compute_dtype)
    part = torch.empty((-(-rows // rb), 1, 4 * hidden), dtype=torch.float32, device=dev)
    cuda_build.check(
        cuda_build.load().wf_lstm_tangent_recurrence(_SCAN_TAN.pack(
            cuda_build.dtype_code(compute_dtype), cs, hcp, rb, g.data_ptr(), p.data_ptr(),
            gates.data_ptr(), tgates.data_ptr(), c.data_ptr(), tc.data_ptr(), dh.data_ptr(),
            dc.data_ptr(), wts.data_ptr(), out.data_ptr(), part.data_ptr(), 4 * hidden, t_len,
            rows, hidden, cuda_build.stream_ptr(dev))),
        f"LSTM tangent recurrence (cluster of {cs}, {hcp} weight columns a block, {rb} rows a "
        f"cluster)",
    )
    sum_splits(part, db.view(1, -1), "LSTM bias gradient tangent partials")
    _tangent_recurrence_card.launches += 1
    return out


_tangent_recurrence_card.launches = 0  # launches of the tangent recurrence (row 11)

CARD_TANGENT_PIECES = TangentPieces(gemm_nn, _tangent_recurrence_card, gemm_tn, sum_splits)
PLAIN_TANGENT_PIECES = TangentPieces(gemm_nn_plain, _tangent_recurrence_plain, gemm_tn_plain,
                                     sum_splits_plain)


def hvp_stack_bwd(g, tg, x, tx, h_all, th_all, c_all, tc_all, gates, tgates,
                  wcat, twcat, masks, keep, compute_dtype, res=None):
    """Row 11: (tdx, [tdwcat_l], tdb), the tangent of the stack backward of
    g along (tg, tx, th_all, tc_all, tgates, twcat). On a CUDA tensor
    `hvp_backward_schedule` on the kernels (per layer one tangent
    recurrence, two gemm_nn and four gemm_tn launches) reads `res` =
    (dgates, dh_all, dc_all) of row 5 at the same point; the plain version
    recomputes them."""
    if _plain(x, compute_dtype):
        return hvp_bwd_plain(g, x, h_all, c_all, gates, wcat, masks, keep, compute_dtype,
                             tg, tx, th_all, tc_all, tgates, twcat)[6:]
    _check(x, wcat, masks, compute_dtype)
    before = _tangent_recurrence_card.launches, gemm_nn.launches, gemm_tn.launches
    dgates, dh_all, dc_all = res
    out = hvp_backward_schedule(
        tg.to(torch.float32), x, tx, h_all, th_all.contiguous(), c_all, tc_all.contiguous(),
        gates, tgates.contiguous(), wcat, twcat, masks, keep, compute_dtype,
        (dgates.contiguous(), dh_all.contiguous(), dc_all.contiguous()), CARD_TANGENT_PIECES)
    bwd = hvp_stack_bwd
    bwd.launches += 1
    bwd.recurrence_launches += _tangent_recurrence_card.launches - before[0]
    bwd.gemm_nn_launches += gemm_nn.launches - before[1]
    bwd.gemm_tn_launches += gemm_tn.launches - before[2]
    return out


hvp_stack_bwd.launches = 0  # tangent backwards run through the kernels (row 11)
# Row 11's pieces: its tangent recurrence (one a layer), gemm_nn (two a layer,
# one at T = 1) and gemm_tn (four a layer) launches.
hvp_stack_bwd.recurrence_launches = 0
hvp_stack_bwd.gemm_nn_launches = 0
hvp_stack_bwd.gemm_tn_launches = 0


def _values(tensors):
    """The plain tensors under torch.func's wrappers. Under torch.func.jvp a
    Function's setup_context saves, and its jvp rule receives, the
    transform's wrapped tensors, which have no storage for a kernel to read.
    The rule is the outermost transform, so it computes on their values,
    under `_DisableFuncTorch` (else even an op on plain tensors returns a
    wrapped one)."""
    from torch._C._functorch import get_unwrapped, is_functorch_wrapped_tensor

    out = []
    for t in tensors:
        while isinstance(t, torch.Tensor) and is_functorch_wrapped_tensor(t):
            t = get_unwrapped(t)
        out.append(t)
    return out


def _tangent(t: torch.Tensor | None, like: torch.Tensor) -> torch.Tensor:
    """A tangent torch.func passed as None (the input does not depend on the
    jvp's primals) as zeros."""
    return torch.zeros_like(like) if t is None else t


class _StackFwd(torch.autograd.Function):
    @staticmethod
    def forward(x, masks, keep, compute_dtype, b2d, *wcat):
        return stack_fwd(x, wcat, b2d, masks, keep, compute_dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, masks, keep, compute_dtype, b2d, *wcat = inputs
        ctx.masks, ctx.keep, ctx.compute_dtype = masks, keep, compute_dtype
        ctx.save_for_forward(x, b2d, *output[1:], *wcat)

    @staticmethod
    def jvp(ctx, tx, _masks, _keep, _dtype, tb2d, *twcat):
        x, b2d, h_all, c_all, gates, *wcat = _values(ctx.saved_tensors)
        tx, tb2d, *twcat = _values((tx, tb2d, *twcat))
        (masks,) = _values((ctx.masks,))
        with torch._C._DisableFuncTorch():
            twcat = [_tangent(t, w) for t, w in zip(twcat, wcat)]
            return hvp_stack_fwd(
                x, _tangent(tx, x), wcat, twcat, b2d, _tangent(tb2d, b2d), masks,
                ctx.keep, ctx.compute_dtype, res=(h_all, c_all, gates),
            )


class _StackBwd(torch.autograd.Function):
    @staticmethod
    def forward(g, x, h_all, c_all, gates, masks, keep, compute_dtype, *wcat):
        dx, dwcat, db, dgates, dh_all, dc_all = stack_bwd(
            g, x, h_all, c_all, gates, wcat, masks, keep, compute_dtype
        )
        return (dx.to(x.dtype), db, *dwcat, dgates, dh_all, dc_all)

    @staticmethod
    def setup_context(ctx, inputs, output):
        g, x, h_all, c_all, gates, masks, keep, compute_dtype, *wcat = inputs
        ctx.masks, ctx.keep, ctx.compute_dtype = masks, keep, compute_dtype
        ctx.mark_non_differentiable(*output[-3:])
        ctx.save_for_forward(g, x, h_all, c_all, gates, *output[-3:], *wcat)

    @staticmethod
    def jvp(ctx, tg, tx, th_all, tc_all, tgates, _masks, _keep, _dtype, *twcat):
        g, x, h_all, c_all, gates, dgates, dh_all, dc_all, *wcat = _values(ctx.saved_tensors)
        tg, tx, th_all, tc_all, tgates, *twcat = _values((tg, tx, th_all, tc_all, tgates, *twcat))
        (masks,) = _values((ctx.masks,))
        with torch._C._DisableFuncTorch():
            tdx, tdwcat, tdb = hvp_stack_bwd(
                g, _tangent(tg, g), x, _tangent(tx, x), h_all, _tangent(th_all, h_all),
                c_all, _tangent(tc_all, c_all), gates, _tangent(tgates, gates), wcat,
                [_tangent(t, w) for t, w in zip(twcat, wcat)], masks, ctx.keep,
                ctx.compute_dtype, res=(dgates, dh_all, dc_all),
            )
            return (tdx.to(x.dtype), tdb, *tdwcat, None, None, None)


def fwd_op(x, wcat, b2d, masks, keep, compute_dtype):
    """(h_last, h_all, c_all, gates) of the stack forward (row 4), with the
    tangent forward (row 10) as its jvp rule."""
    return _StackFwd.apply(x, masks, keep, compute_dtype, b2d, *wcat)


def bwd_op(g, x, h_all, c_all, gates, wcat, masks, keep, compute_dtype):
    """(dx, [dwcat_l], db) of the stack backward (row 5), with the tangent
    of the backward (row 11) as its jvp rule."""
    out = _StackBwd.apply(g, x, h_all, c_all, gates, masks, keep, compute_dtype, *wcat)
    return out[0], list(out[2:2 + len(wcat)]), out[1]
