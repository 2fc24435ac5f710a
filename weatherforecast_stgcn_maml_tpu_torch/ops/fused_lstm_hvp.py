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
and dgates of every stage), so a `jvp` computes tangents only
(csrc/fused_lstm_hvp.cu).

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

from typing import Sequence

import torch

from weatherforecast_stgcn_maml_tpu_torch.models.common import (
    accum_dtype,
    apply_mask,
    as_operand,
)
from weatherforecast_stgcn_maml_tpu_torch.ops import cuda_build
from weatherforecast_stgcn_maml_tpu_torch.ops.fused_lstm_stack import (
    _rows_per_thread,
    train_backward,
    train_forward,
)
from weatherforecast_stgcn_maml_tpu_torch.ops.gemm import colsum, matmul_tn_sum


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


def _merged2(pairs, transpose: bool, compute_dtype):
    """Per layer [[W_l], [tW_l]] (or [[W_l^T], [tW_l^T]]) in the compute
    dtype: (layer 0, layers 1.. stacked, or layer 0 again when L = 1)."""
    ws = [torch.cat([w.t(), tw.t()] if transpose else [w, tw]).to(compute_dtype).contiguous()
          for w, tw in pairs]
    return ws[0], torch.stack(ws[1:]) if len(ws) > 1 else ws[0]


def hvp_stack_fwd(x, tx, wcat, twcat, b2d, tb2d, masks, keep, compute_dtype, res=None):
    """Row 10: (th_last, th_all, tc_all, tgates), the tangent of the stack
    forward at (x, wcat, b2d) along (tx, twcat, tb2d). On a CUDA tensor the
    kernel reads `res` = (h_all, c_all, gates) of row 4 at the same point;
    the plain version recomputes them."""
    if _plain(x, compute_dtype):
        return hvp_fwd_plain(x, wcat, b2d, masks, keep, compute_dtype, tx, twcat, tb2d)[4:]
    _check(x, wcat, masks, compute_dtype)
    h_all, c_all, gates = res
    lib = cuda_build.load()
    dev = x.device
    t_len, rows, c_in = x.shape
    n_layers, g4 = b2d.shape
    hidden = g4 // 4
    x = x.to(torch.float32).contiguous()
    tx = tx.to(torch.float32).contiguous()
    w2_0, w2_r = _merged2(zip(wcat, twcat), False, compute_dtype)
    tb = tb2d.to(torch.float32).contiguous()
    th_all = torch.empty_like(h_all)
    tc_all = torch.empty_like(c_all)
    tgates = torch.empty_like(gates)
    th_last = torch.empty((rows, hidden), dtype=torch.float32, device=dev)
    cuda_build.check(
        lib.wf_lstm_hvp_fwd(
            cuda_build.dtype_code(compute_dtype), _rows_per_thread(rows, hidden, dev),
            x.data_ptr(), tx.data_ptr(), w2_0.data_ptr(), w2_r.data_ptr(), tb.data_ptr(),
            None if masks is None else masks.data_ptr(), 1.0 / keep,
            h_all.data_ptr(), c_all.data_ptr(), gates.data_ptr(),
            th_all.data_ptr(), tc_all.data_ptr(), tgates.data_ptr(), th_last.data_ptr(),
            t_len, rows, c_in, hidden, n_layers, cuda_build.stream_ptr(dev),
        ),
        "LSTM second-order forward",
    )
    hvp_stack_fwd.launches += 1
    return th_last, th_all, tc_all, tgates


hvp_stack_fwd.launches = 0  # tangent forwards run through the CUDA kernel (row 10)


def hvp_stack_bwd(g, tg, x, tx, h_all, th_all, c_all, tc_all, gates, tgates,
                  wcat, twcat, masks, keep, compute_dtype, res=None):
    """Row 11: (tdx, [tdwcat_l], tdb), the tangent of the stack backward of
    g along (tg, tx, th_all, tc_all, tgates, twcat). On a CUDA tensor the
    kernel reads `res` = (dgates, dh_all, dc_all) of row 5 at the same
    point; the plain version recomputes them."""
    if _plain(x, compute_dtype):
        return hvp_bwd_plain(g, x, h_all, c_all, gates, wcat, masks, keep, compute_dtype,
                             tg, tx, th_all, tc_all, tgates, twcat)[6:]
    _check(x, wcat, masks, compute_dtype)
    dgates, dh_all, dc_all = res
    lib = cuda_build.load()
    dev = x.device
    t_len, rows, c_in = x.shape
    n_layers, _, _, g4 = gates.shape
    hidden = g4 // 4
    inv_keep = 1.0 / keep
    tg = tg.to(torch.float32).contiguous()
    tgates = tgates.contiguous()
    wt_0, wt_r = _merged2(zip(wcat, twcat), True, compute_dtype)
    tdx = torch.empty((t_len, rows, c_in), dtype=torch.float32, device=dev)
    tdgates = torch.empty_like(dgates)
    cuda_build.check(
        lib.wf_lstm_hvp_bwd(
            cuda_build.dtype_code(compute_dtype), _rows_per_thread(rows, hidden, dev),
            tg.data_ptr(), gates.data_ptr(), tgates.data_ptr(), c_all.data_ptr(),
            tc_all.contiguous().data_ptr(), dh_all.data_ptr(), dc_all.data_ptr(),
            dgates.data_ptr(), None if masks is None else masks.data_ptr(), inv_keep,
            wt_0.data_ptr(), wt_r.data_ptr(), tdx.data_ptr(), tdgates.data_ptr(),
            t_len, rows, c_in, hidden, n_layers, cuda_build.stream_ptr(dev),
        ),
        "LSTM second-order backward",
    )
    # tdwcat_l = xh^T @ tdgates_l + txh^T @ dgates_l, tdb_l = colsum(tdgates_l),
    # over every step and row; h_{t-1} rows start at t = 1.
    x = x.to(torch.float32).contiguous()
    tx = tx.to(torch.float32).contiguous()
    th_all = th_all.contiguous()
    steps = t_len * rows
    tdwcat, tdb = [], torch.empty((n_layers, g4), dtype=torch.float32, device=dev)
    for l in range(n_layers):
        kin = c_in if l == 0 else hidden
        dg, tdg = dgates[l].view(steps, g4), tdgates[l].view(steps, g4)
        tdw = torch.empty((kin + hidden, g4), dtype=torch.float32, device=dev)
        if l == 0:
            inp, tinp, mask = x.view(steps, c_in), tx.view(steps, c_in), None
        else:
            inp, tinp = h_all[l - 1].view(steps, hidden), th_all[l - 1].view(steps, hidden)
            mask = None if masks is None else masks[l - 1].view(steps, hidden)
        matmul_tn_sum(
            [(inp, tdg, mask, inv_keep), (tinp, dg, mask, inv_keep)], tdw[:kin],
            compute_dtype=compute_dtype, what=f"LSTM layer {l} input weight gradient tangent",
        )
        prev = steps - rows
        matmul_tn_sum(
            [(h_all[l, :-1].reshape(prev, hidden), tdg[rows:], None, 1.0),
             (th_all[l, :-1].reshape(prev, hidden), dg[rows:], None, 1.0)], tdw[kin:],
            compute_dtype=compute_dtype,
            what=f"LSTM layer {l} recurrent weight gradient tangent",
        )
        colsum(tdg, tdb[l], f"LSTM layer {l} bias gradient tangent")
        tdwcat.append(tdw)
    hvp_stack_bwd.launches += 1
    return tdx, tdwcat, tdb


hvp_stack_bwd.launches = 0  # tangent backwards run through the CUDA kernel (row 11)


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
