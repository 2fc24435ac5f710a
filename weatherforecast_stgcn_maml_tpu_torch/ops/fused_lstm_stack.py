"""Fused LSTM stack: x [B, T, C] -> the top layer's last hidden state
[B, H].

Each entry runs hand-written CUDA kernels on a CUDA tensor and its plain
PyTorch version on a CPU tensor or under float64. On a CUDA tensor a shape
or dtype a kernel does not take raises; nothing falls back to the plain
version there.

  * `lstm_stack_last_all`: the eval forward (kernel row 2), no autograd, on
    the card `eval_forward`: row 14's layer-by-layer schedule without
    residuals (one csrc/gemm_nn.cu input product and one cluster recurrence
    of csrc/lstm_scan_fwd.cuh a layer, enqueued by one C call,
    csrc/lstm_stack_fwd.cu) from the layers' own wx, wh and b, which row 20
    (ops/fused_lstm.py) and row 14's eval forward run too;
  * `lstm_stack_train`: the training forward (row 4, emitting h / c
    residuals and the activated gates and applying int8 inter-layer dropout
    masks) and its backward (row 5) behind one `torch.autograd.Function`,
    both layer by layer: the forward (`forward_schedule`, enqueued by one C
    call, csrc/lstm_stack_fwd.cu) as one csrc/gemm_nn.cu input product and
    one cluster recurrence (csrc/lstm_scan_fwd.cuh) a layer; the backward
    (`merged_backward_schedule`) as the recurrence of csrc/lstm_scan_bwd.cuh
    from the stored gates (with the bias gradient), csrc/gemm_nn.cu for the
    input gradient and two of its split-K TN products for the weight
    gradients a layer;
  * `lstm_stack_train_tasks`: rows 4 and 5 for V tasks with their own
    weights (rows 16 and 17), for the task-batched meta step (`_VBATCH`),
    both by rows 4 and 5's layer-by-layer schedules with a task axis: the
    forward (`tasks_forward_schedule`, enqueued by row 4's C call) as one
    gemm_nn launch and one cluster recurrence a layer for all V tasks; the
    backward (`tasks_backward_schedule`) as one recurrence launch, one
    gemm_nn launch and two gemm_tn launches a layer for all V tasks;
  * `lstm_stack_split`: the unmerged-gates stack, which the two entries
    above take under `_MERGED_GATES = False` or `merged=False`: the forward
    (row 14) on row 4's layer-by-layer schedule from its separate weight
    arrays, one gates buffer for every layer (`split_forward_schedule`; the
    eval forward also one h and one c buffer), the backward (row 15) by the
    same layer-by-layer schedule as row 5 with each layer's gates recomputed
    on csrc/gemm_nn.cu (`split_backward_schedule`).

`models/lstm.apply_lstm`'s `lstm_kernel="auto"` asks `stack_planned`
before it calls the training entries and `eval_planned` before the eval
forward: where the widths or no cluster plan that holds Wh fit it takes the
plain stack, as the JAX package's `auto` takes its XLA scan where
`stack_supported` fails (models/hybrid.py asks the same for row 20). That is
a route chosen by shape before any launch. The entries themselves (the
forced `lstm_kernel="pallas_stack"`) run at any width to H 2048: past the
clusters that hold Wh their recurrences take streamed plans, which keep what
fits of each block's slice in shared memory and read the rest from L2 at
every step (`stream_plans`; one task).

Counterpart of `weatherforecast_stgcn_maml_tpu/ops/fused_lstm_stack.py`
(`lstm_stack_last_all`; Pallas bodies `_fwd_kernel_m_lastonly_nomask`,
`_fwd_kernel_m`, `_bwd_kernel_m`, `_fwd_kernel_mv`, `_bwd_kernel_mv`,
`_fwd_kernel` and `_bwd_kernel`). Rows are independent sequences, so a
batch of windows over N nodes is simply B*N rows of one launch.
"""

from __future__ import annotations

import dataclasses
import functools
import struct
from types import SimpleNamespace
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from weatherforecast_stgcn_maml_tpu_torch.models.common import (
    accum_dtype,
    apply_mask,
    as_operand,
)
from weatherforecast_stgcn_maml_tpu_torch.ops import cuda_build
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
    workspace,
)

# The JAX package's two routing flags, with its names and defaults. Both are
# read at call time, so a caller (the tests, chip_smoke.py) flips them in
# process as the JAX package's tests monkeypatch them; neither has a config
# key or a CLI option, in either package.
#
# _MERGED_GATES: True runs the merged-gates stack (on the TPU the forwards
# one [in | h] @ [[Wx], [Wh]] contraction a stage, rows 2 and 4; its
# backward, row 5, from the gates row 4 stores; on a card row 2 is the eval
# forward that row 14 runs too, and only the counters tell them apart).
# False sends `lstm_stack_last_all` and `lstm_stack_train` to the
# unmerged-gates stack `lstm_stack_split`
# (x @ Wx and h @ Wh as two contractions; rows 14 and 15). Second order
# keeps rows 4-5 and 10-11 where it differentiates twice
# (train/so_fused.py calls them directly), as the JAX package's fhvp does.
_MERGED_GATES = True
# _VBATCH: True makes the first-order meta step of the hybrid family on the
# merged fused stack (`model.lstm_kernel` auto / pallas_stack) run the tasks
# of a micro-batch in lockstep (train/maml.py `lockstep_route`), their LSTM
# stacks in one launch each way (`lstm_stack_train_tasks`, rows 16-17) and
# their inner updates as one batched clip + SGD (row 9). The plain stack
# (`lstm_kernel="xla"`) takes the lockstep loop too, with the same
# arithmetic and no kernel. The routes with no merged stack (the stgcn
# family, `lstm_kernel="pallas"`, the train-mode row 20 of
# `use_pallas_lstm` at dropout 0, unmerged gates) and second order keep
# their serial route; on a mesh a rank's tasks run in lockstep (the dp step
# and the dp x sp shardmap step). The JAX package gates it by
# `vbatch_supported` (V chains within a TPU core's VMEM); the port by the
# cluster plans (`stack_planned` for V tasks), falling back as JAX does.
_VBATCH = False
# _ROWFOLD: the JAX package's route for a vmap over windows that share the
# weights (the adaptation step's window batch). True folds the windows into
# the single-task stack's rows (row 4 / row 5 at B x N rows; "a wash" on
# the TPU, JAX's comment says). False with `_VBATCH` runs the task-batched
# kernels, one window a task, the weights broadcast over the windows with
# task stride 0 and their gradients summed over them (rows 16-17,
# `models/hybrid.window_batch_unfolded`). Neither flag: JAX runs its
# grid-serialized vmap, which the port folds instead (equal up to the order
# of sums).
_ROWFOLD = False


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
    """Raise on what the LSTM stacks' kernels do not take (the weights'
    shapes, dtype and device; widths that are multiples of 8, the input
    products' K)."""
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
    if c_in % 8 or hidden % 8:
        raise ValueError(
            f"the LSTM kernels take input and hidden widths that are multiples "
            f"of 8, got {c_in} and {hidden}"
        )
    return cuda_build.dtype_code(compute_dtype)


def lstm_stack_last_all(
    layers: Sequence, x: torch.Tensor, *, compute_dtype: torch.dtype = torch.float32,
    merged: bool | None = None,
) -> torch.Tensor:
    """Run the whole stacked LSTM: x [B, T, C] -> h_top [B, H] at the last
    step, float32 (float64 under float64).

    `layers` are the LSTM's layers, each with `wx` [C_in, 4H], `wh` [H, 4H]
    and the fused bias `b` [4H] (models/lstm.py). `merged` (None: read
    `_MERGED_GATES`) False runs the unmerged-gates forward (row 14): on a
    card the same schedule (`eval_forward`), counted as row 14's.
    """
    cuda_build.no_grad_inputs(
        x, *(p for layer in layers for p in (layer.wx, layer.wh, layer.b))
    )
    if not (_MERGED_GATES if merged is None else merged):
        return lstm_stack_split(layers, x, compute_dtype=compute_dtype, train=False)
    if not _on_card(x, compute_dtype):
        return lstm_stack_plain(layers, x, compute_dtype)
    return eval_forward(layers, x, compute_dtype, lstm_stack_last_all)


lstm_stack_last_all.launches = 0  # eval forwards run through the CUDA kernels (row 2)
# Row 2's pieces: its gemm_nn and forward recurrence launches (one each a layer).
lstm_stack_last_all.forward_gemm_nn_launches = 0
lstm_stack_last_all.forward_recurrence_launches = 0
# Calls whose recurrences ran on a streamed plan (`eval_plan`, or past the
# clusters that hold Wh under `lstm_kernel=pallas_stack`).
lstm_stack_last_all.streamed_launches = 0


def eval_forward(layers: Sequence, x: torch.Tensor, compute_dtype: torch.dtype,
                 counter: Callable) -> torch.Tensor:
    """The eval forward of rows 2, 14 and 20 on a CUDA tensor: x [B, T, C]
    -> the top layer's last h [B, H] float32, no dropout, by row 14's
    schedule without residuals (`split_forward_schedule(...,
    residuals=False)`, its recurrences on `eval_plan`'s plan) from the
    layers' own wx, wh and b: L `gemm_nn` input
    products and L forward recurrences enqueued by one C call
    (csrc/lstm_stack_fwd.cu), one gates buffer and one h buffer for every
    layer, no c and no top-layer h sequence stored. x keeps its [B, T, C]
    layout, read time-major through a view. `counter` is the caller's entry
    (`lstm_stack_last_all`, `lstm_stack_split`, `fused_lstm_last_hidden`):
    the call and its launches count there."""
    _check_lstm(layers, x, compute_dtype)
    b2d = torch.stack([layer.b for layer in layers])
    return _split_forward_card(
        x.transpose(0, 1), [layer.wx for layer in layers], [layer.wh for layer in layers], b2d,
        None, 1.0, compute_dtype, False, counter, f"LSTM eval forward ({counter.__name__})")[0]


# Row 4 on a card runs layer by layer, as its backward does
# (`backward_schedule` below), so that only the h carry through Wh is on the
# serial chain (the TPU kernel walks all T x L stages as one chain, one [in
# | h] @ [[Wx], [Wh]] contraction a stage). For l = 0 .. L-1:
#   1. xp_l = round(in_l) @ round(Wx_l) for all T x R rows: one product into
#      gates[l] [T, R, 4H] float32, batched over the steps. No bias: the core
#      has no bias-only epilogue, so the recurrence adds b_l. in_0 is x; in_l
#      above it is the layer below's h_all, or with masks its masked copy;
#   2. the forward recurrence (csrc/lstm_scan_fwd.cuh) over gates[l] in place:
#      act((xp + b_l) + round(h_{t-1}) @ round(Wh_l)) as the activated gates,
#      h_all[l] = round(h), c_all[l] = round(c), the top layer's last h in
#      float32 and, with masks, the next layer's input round(h * mask_l /
#      keep), rounded from the float32 h (JAX's rounding point; round(h_all)
#      times the mask would round twice in bfloat16).
# On a card one C call (csrc/lstm_stack_fwd.cu, `train_forward`) enqueues
# all 2L launches. `forward_schedule` states the schedule on swappable
# pieces: the kernels a launch each (`FWD_CARD_PIECES`: timing by part) or
# their plain versions (`FWD_PLAIN_PIECES`: the CPU tests). Row 14 (the
# unmerged-gates forward, `split_forward_schedule` and `split_forward`)
# runs the same schedule from its separate Wx and Wh arrays. Its gates and
# JAX's differ in the order of one float32 addition: JAX forms (in Wx + h
# Wh) + b, the recurrence (in Wx + b) + h Wh (the last bit, within the
# float32 gate of 1e-5). Row 16 (`tasks_forward_schedule`, `tasks_forward`)
# runs it for V tasks, each with its own weights, through the same C entry:
# every tensor has a leading task axis, each product is one launch batched
# over the tasks (M = T x R rows a task, x time-major), each recurrence one
# launch with the tasks on the grid's z axis, its plan by task count. One
# task keeps row 4's launches: the product batched over the T steps (x may
# be the model's [B, T, C] layout viewed [T, B, C]).


@dataclasses.dataclass(frozen=True)
class ForwardPieces:
    """product: `gemm_nn`'s signature; recurrence(gates, wh, bias,
    compute_dtype, h_out, c_out, mask=None, inv_keep=1.0, next_in=None,
    h_last=None): one layer's forward recurrence over gates [T, R, 4H]
    float32 in place (in: xp; out: the activated gates), wh [H, 4H], bias
    [4H] float32 (the plain version also takes None: xp holds the bias, as
    row 18's does), into h_out and c_out [T, R, H] in the compute dtype; with
    mask [T, R, H] int8 also next_in = round(h * mask * inv_keep); the last
    step's h into h_last [R, H] where given. With a leading task axis on
    every argument (gates [V, T, R, 4H], wh [V, H, 4H], bias [V, 4H], ...),
    the V tasks' recurrences (one launch on a card)."""

    product: Callable
    recurrence: Callable


def forward_schedule(x, masks, keep, compute_dtype, b2d, wcat, pieces: ForwardPieces):
    """Row 4's function (`train_forward`'s outputs: h_last [B, H], h_all,
    c_all [L, T, B, H] in the compute dtype, the activated gates [L, T, B,
    4H]; h_last and the gates in the accumulation dtype) by the schedule
    above on `pieces`: x [T, B, C], wcat_l = [[Wx_l], [Wh_l]], b2d [L, 4H],
    masks [L-1, T, B, H] or None."""
    hidden = b2d.shape[1] // 4
    out = _forward_layers(x[None], _one_task(masks), keep, compute_dtype, b2d[None],
                          [w[None, :-hidden] for w in wcat], [w[None, -hidden:] for w in wcat],
                          pieces)
    return tuple(t[0] for t in out)


def tasks_forward_schedule(x, masks, keep, compute_dtype, wcat0, wcatr, b2d,
                           pieces: ForwardPieces):
    """Row 16's function (`tasks_forward`'s outputs: h_last [V, B, H], h_all,
    c_all [V, L, T, B, H] in the compute dtype, the activated gates [V, L, T,
    B, 4H]; h_last and the gates in the accumulation dtype) by the schedule
    above on `pieces` for V tasks: x [V, T, B, C], wcat0 [V, C + H, 4H],
    wcatr [V, L-1, 2H, 4H], b2d [V, L, 4H], masks [V, L-1, T, B, H] or
    None."""
    wx, wh = _task_layers(wcat0, wcatr, b2d.shape[-1] // 4)
    return _forward_layers(x, masks, keep, compute_dtype, b2d, wx, wh, pieces)


def _task_layers(wcat0, wcatr, hidden):
    """([Wx_l [V, K_l, 4H]], [Wh_l [V, H, 4H]]): the row blocks of each
    task's wcat_l = [[Wx_l], [Wh_l]] (views)."""
    wcat = [wcat0, *wcatr.unbind(1)]
    return [w[:, :-hidden] for w in wcat], [w[:, -hidden:] for w in wcat]


def split_forward_schedule(x, wx0, wxr, wh, b2d, masks, keep, compute_dtype,
                           pieces: ForwardPieces, residuals=True):
    """Row 14's function (`split_forward_plain`'s outputs: h_last [B, H],
    h_all, c_all [L, T, B, H], or None without `residuals`) by row 4's
    schedule on `pieces`, from the separate weight arrays wx0 [C, 4H], wxr
    [L-1, H, 4H], wh [L, H, 4H]. One gates buffer [T, B, 4H] serves every
    layer (row 15 recomputes the gates); without `residuals` so does one h
    and one c buffer [T, B, H] (layer l+1's product reads layer l's h before
    layer l+1's recurrence writes it)."""
    h_last, h_all, c_all, _ = _forward_layers(
        x[None], _one_task(masks), keep, compute_dtype, b2d[None],
        [wx0[None], *(w[None] for w in wxr)], [w[None] for w in wh], pieces, keep_gates=False,
        residuals=residuals)
    return (h_last[0], h_all[0], c_all[0]) if residuals else (h_last[0], None, None)


def _forward_layers(x, masks, keep, compute_dtype, b2d, wx, wh, pieces: ForwardPieces,
                    keep_gates=True, residuals=True):
    """The schedule above for V tasks over the layers' wx_l [V, K_l, 4H] and
    wh_l [V, H, 4H], from x [V, T, B, C], b2d [V, L, 4H] and masks [V, L-1,
    T, B, H] or None: -> (h_last [V, B, H], h_all, c_all [V, L, T, B, H],
    gates [V, L, T, B, 4H]). Without `keep_gates` one gates buffer [V, T, B,
    4H] serves every layer, without `residuals` one h and one c buffer [V,
    T, B, H]."""
    acc = accum_dtype(compute_dtype)
    dev = x.device
    nv, t_len, rows, _ = x.shape
    n_layers, g4 = b2d.shape[1:]
    hidden = g4 // 4
    one = (nv, t_len, rows, hidden)
    shape = (nv, n_layers, *one[1:]) if residuals else one
    h_all = torch.empty(shape, dtype=compute_dtype, device=dev)
    c_all = torch.empty_like(h_all)
    gates = torch.empty((nv, *((n_layers,) if keep_gates else ()), t_len, rows, g4), dtype=acc,
                        device=dev)
    h_last = torch.empty((nv, rows, hidden), dtype=acc, device=dev)
    # The masked inputs of every layer above 0 in turn: layer l+1's product
    # reads them before layer l+1's recurrence writes the next.
    masked = (torch.empty(one, dtype=compute_dtype, device=dev)
              if masks is not None and n_layers > 1 else None)
    inp = x
    for l in range(n_layers):
        top = l == n_layers - 1
        gates_l = gates[:, l] if keep_gates else gates
        h_l, c_l = (h_all[:, l], c_all[:, l]) if residuals else (h_all, c_all)
        what = f"LSTM layer {l} input product"
        if nv == 1:  # batched over the steps
            pieces.product(inp[0], wx[l][0], compute_dtype=compute_dtype, out=gates_l[0],
                           what=what)
        else:  # batched over the tasks, T x B rows a task
            pieces.product(inp.reshape(nv, t_len * rows, -1), wx[l], compute_dtype=compute_dtype,
                           out=gates_l.view(nv, t_len * rows, g4), what=what)
        mask = None if masked is None or top else masks[:, l]
        pieces.recurrence(gates_l, wh[l], b2d[:, l], compute_dtype, h_l, c_l, mask=mask,
                          inv_keep=1.0 / keep, next_in=None if mask is None else masked,
                          h_last=h_last if top else None)
        inp = h_l if mask is None else masked
    return h_last, h_all, c_all, gates


def _forward_recurrence_plain(gates, wh, bias, compute_dtype, h_out, c_out, mask=None,
                              inv_keep=1.0, next_in=None, h_last=None):
    if gates.dim() == 4:  # V tasks, one at a time
        for v in range(gates.shape[0]):
            _forward_recurrence_plain(
                gates[v], wh[v], _task(bias, v), compute_dtype, h_out[v],
                c_out[v], mask=_task(mask, v), inv_keep=inv_keep, next_in=_task(next_in, v),
                h_last=_task(h_last, v))
        return gates
    acc = gates.dtype
    hidden = wh.shape[0]
    whc = as_operand(wh, compute_dtype)
    h = torch.zeros((gates.shape[1], hidden), dtype=acc, device=gates.device)
    c = torch.zeros_like(h)
    for t in range(gates.shape[0]):
        xp = gates[t] if bias is None else gates[t] + bias
        i, f, g, o = (xp + torch.matmul(as_operand(h, compute_dtype), whc)).split(hidden, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        c = f * c + i * g
        h = o * torch.tanh(c)
        gates[t] = torch.cat([i, f, g, o], dim=-1)
        h_out[t], c_out[t] = h, c
        if next_in is not None:
            next_in[t] = h * (mask[t].to(acc) * inv_keep)
    if h_last is not None:
        h_last.copy_(h)
    return gates


# The forward recurrence's launch arguments, packed as csrc/lstm_stack_fwd.cu's
# `ScanFwdLaunch`; the whole forward's as its `StackFwdLaunch`, followed by
# one (Wx_l, Wh_l, input width, task stride) quadruple a layer.
_SCAN_FWD = struct.Struct("<13qd16q")
_STACK_FWD = struct.Struct("<10qd21q")


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _plan_text(plan, k_rows):
    """A recurrence plan in words, for the launch errors."""
    cs, hcp, rb, k_res = plan
    return (f"cluster of {cs}, {hcp} weight columns a block, {rb} rows a cluster"
            + (f", {k_res} of {k_rows} K-rows resident" if k_res < k_rows else ""))


def _forward_recurrence_card(gates, wh, bias, compute_dtype, h_out, c_out, mask=None,
                             inv_keep=1.0, next_in=None, h_last=None):
    if gates.dim() == 3:  # one task
        _forward_recurrence_card(gates[None], wh[None], bias[None], compute_dtype, h_out[None],
                                 c_out[None], _one_task(mask), inv_keep, _one_task(next_in),
                                 _one_task(h_last))
        return gates
    nv, t_len, rows, g4 = gates.shape
    hidden = g4 // 4
    plan = forward_plan(hidden, rows, compute_dtype.itemsize, _sms(gates.device), nv)
    cs, hcp, rb, k_res = plan
    if streams(plan, hidden):  # the blocks' slices, read by bulk copies
        wh = _per_task(lambda w: forward_weights(w, cs, hcp, compute_dtype), wh)
    else:
        wh = wh.to(compute_dtype)
        if wh.stride(-1) != 1 or not wh[0].is_contiguous():
            wh = wh.contiguous()
    if _task_stride(c_out, nv) != _task_stride(h_out, nv):
        raise ValueError("the LSTM forward recurrence takes h and c in one layout")
    cuda_build.check(
        cuda_build.load().wf_lstm_stack_forward_recurrence(_SCAN_FWD.pack(
            cuda_build.dtype_code(compute_dtype), cs, hcp, rb, gates.data_ptr(), gates.data_ptr(),
            wh.data_ptr(), wh.stride(-2), bias.data_ptr(), h_out.data_ptr(), c_out.data_ptr(), 0,
            _ptr(mask), inv_keep, _ptr(next_in), _ptr(h_last), t_len, rows, hidden,
            cuda_build.stream_ptr(gates.device), nv,
            *(_task_stride(t, nv) for t in (gates, gates, wh, bias, h_out, mask, next_in,
                                            h_last)), k_res)),
        f"LSTM forward recurrence ({nv} task(s), {_plan_text(plan, hidden)})",
    )
    _forward_recurrence_card.launches += 1
    return gates


_forward_recurrence_card.launches = 0  # launches of the forward recurrence alone

FWD_CARD_PIECES = ForwardPieces(gemm_nn, _forward_recurrence_card)
FWD_PLAIN_PIECES = ForwardPieces(gemm_nn_plain, _forward_recurrence_plain)


def train_forward(x_tbc, masks, keep, compute_dtype, b2d, wcat):
    """Row 4 on a CUDA tensor: x_tbc [T, B, C], wcat_l = [[wx_l], [wh_l]]
    float32, b2d [L, 4H] -> (h_last [B, H] float32, h_all, c_all [L, T, B,
    H] in the compute dtype, the activated gates [L, T, B, 4H] float32), by
    `forward_schedule`'s schedule, its L products and L recurrences enqueued
    by one C call (csrc/lstm_stack_fwd.cu)."""
    hidden = b2d.shape[1] // 4
    plan = forward_plan(hidden, x_tbc.shape[1], compute_dtype.itemsize, _sms(x_tbc.device))
    # `weights` keeps the compute-dtype weights alive while the call enqueues.
    layers, weights = _one_task_layers([w[:-hidden] for w in wcat], [w[-hidden:] for w in wcat],
                                       compute_dtype, plan)
    out = _stack_forward_card(x_tbc[None], _one_task(masks), keep, compute_dtype, b2d[None],
                              layers, "LSTM train forward", plan=plan)
    n_layers = len(wcat)
    train = lstm_stack_train
    train.launches += 1
    train.streamed_launches += streams(plan, hidden)
    train.forward_gemm_nn_launches += n_layers
    train.forward_recurrence_launches += n_layers
    return tuple(t[0] for t in out)


def _one_task_layers(wx, wh, compute_dtype, plan):
    """The (Wx_l, Wh_l, K_l, task stride 0) quadruples of `_stack_forward_card`
    for one task's float32 wx_l [K_l, 4H] and wh_l [H, 4H] (row blocks of one
    matrix or arrays of their own) under the recurrences' plan, and the
    tensors they point into: float32 as they are, else one cast of all
    layers (each layer's rows stay 16-byte aligned: 4H columns); under a
    streamed plan each Wh_l laid out as its slices (`forward_weights`)."""
    ws = [*wx, *wh]
    if compute_dtype is torch.float32:
        ws = [w.contiguous() for w in ws]
    else:
        ws = torch.cat(ws).to(compute_dtype).split([w.shape[0] for w in ws])
    n = len(wx)
    if streams(plan, wh[0].shape[0]):
        ws = [*ws[:n], *(forward_weights(w, *plan[:2], compute_dtype) for w in ws[n:])]
    return [(a.data_ptr(), b.data_ptr(), a.shape[0], 0) for a, b in zip(ws[:n], ws[n:])], ws


def _task_layers_card(wcat0, wcatr, c_in, hidden):
    """The (Wx_l, Wh_l, K_l, task stride) quadruples of `_stack_forward_card`
    for V tasks' contiguous wcat0 [V, C + H, 4H] and wcatr [V, L-1, 2H, 4H]:
    the row blocks of each task's wcat_l = [[Wx_l], [Wh_l]], by address."""
    row = 4 * hidden * wcat0.element_size()
    layers = [(wcat0.data_ptr(), wcat0.data_ptr() + c_in * row, c_in, wcat0.stride(0))]
    for l in range(wcatr.shape[1]):
        w = wcatr.data_ptr() + l * wcatr.stride(1) * wcatr.element_size()
        layers.append((w, w + hidden * row, hidden, wcatr.stride(0)))
    return layers


def _stack_forward_card(x, masks, keep, compute_dtype, b2d, layers, what, keep_gates=True,
                        residuals=True, plan=None):
    """`_forward_layers` on the card: its 2L launches enqueued by one C call
    (csrc/lstm_stack_fwd.cu) for V tasks from x [V, T, B, C], b2d [V, L, 4H],
    masks [V, L-1, T, B, H] or None and the layers' weights: a (Wx_l, Wh_l,
    K_l, task stride) quadruple each, addresses of Wx_l [K_l, 4H] and Wh_l
    [H, 4H] in the compute dtype (row stride 4H; under a streamed plan Wh_l's
    slices, `forward_weights`) -> (h_last [V, B, H]
    float32, h_all, c_all in the compute dtype, the gates float32; without
    `residuals` h_all is one layer's scratch, its top layer unwritten, and
    c_all empty). `plan`: the recurrences' (None: `forward_plan`'s, Wh
    resident). One task keeps row 4's launches (x may be a strided view)."""
    dev = x.device
    nv, t_len, rows, _ = x.shape
    n_layers, g4 = b2d.shape[1:]
    hidden = g4 // 4
    if x.dtype is not torch.float32 and x.dtype is not compute_dtype:
        x = x.float()
    if (x.stride(-1) != 1 or x.stride(1) % 8 or x.stride(2) % 8 or x.data_ptr() % 16
            or (nv > 1 and not x.is_contiguous())):
        x = x.contiguous()
    one = (t_len, rows, hidden)
    shape = (nv, n_layers, *one) if residuals else (nv, *one)
    with_masks = masks is not None and n_layers > 1
    # Without residuals only the top layer's last h leaves: no c is stored.
    h_all, c_all, gates, masked = workspace(
        dev, (shape, compute_dtype), (shape if residuals else (0,), compute_dtype),
        ((nv, *((n_layers,) if keep_gates else ()), t_len, rows, g4), torch.float32),
        ((nv, *one) if with_masks else (0,), compute_dtype))
    h_last = torch.empty((nv, rows, hidden), dtype=torch.float32, device=dev)
    if not with_masks:
        masks = masked = None
    elif not masks.is_contiguous():
        masks = masks.contiguous()
    if plan is None:  # the task-batched stack's raw weights: Wh resident
        plan = forward_plan(hidden, rows, compute_dtype.itemsize, _sms(dev), nv)
        if streams(plan, hidden):
            raise ValueError(f"the task-batched LSTM stack (rows 16-17) holds Wh in a "
                             f"cluster's shared memory; hidden width {hidden} does not fit")
    cs, hcp, rb, k_res = plan
    bias = _per_task(torch.Tensor.contiguous, b2d)
    # Task strides: every array here is contiguous (bias: or shared, 0).
    strides = [0 if t is None or nv == 1 else t.stride(0)
               for t in (x, bias, masks, h_all, gates, h_last, masked)]
    launch = _STACK_FWD.pack(
        cuda_build.dtype_code(compute_dtype), cs, hcp, rb, x.data_ptr(), x.stride(1), x.stride(2),
        int(x.dtype is torch.float32), bias.data_ptr(), _ptr(masks), 1.0 / keep,
        h_all.data_ptr(), c_all.data_ptr() if residuals else 0, gates.data_ptr(),
        h_last.data_ptr(), _ptr(masked),
        t_len * rows * hidden if residuals else 0, t_len * rows * g4 if keep_gates else 0, t_len,
        rows, hidden, n_layers, cuda_build.stream_ptr(dev), nv, *strides, k_res)
    err = cuda_build.load().wf_lstm_stack_forward(
        launch + struct.pack(f"<{4 * n_layers}q", *(v for layer in layers for v in layer)))
    if err < 0:
        raise ValueError(f"{what}: its input product takes {_NN_REFUSALS[err]}")
    cuda_build.check(err, f"{what} ({nv} task(s); recurrences: {_plan_text(plan, hidden)})")
    gemm_nn.launches += n_layers
    return h_last, h_all, c_all, gates


def train_backward(g, x_tbc, h_all, c_all, gates, wcat, masks, keep, compute_dtype,
                   carries=False):
    """Row 5 on a CUDA tensor: the gradient g [B, H] of the last h back to
    (dx [T, B, C], [dwcat_l], db [L, 4H]) float32; with `carries`, also the
    gate gradients dgates [L, T, B, 4H] and each stage's dh and dc [L, T, B,
    H] float32 (else None), which the second-order backward reads. By
    `merged_backward_schedule` on the kernels: per layer one recurrence
    launch (csrc/lstm_scan_bwd.cuh, from row 4's stored gates, with the bias
    gradient's partials), one gemm_nn launch for the input gradient and two
    gemm_tn launches for the weight gradients, each followed by the
    `sum_splits` of its partials."""
    before = _recurrence_card.launches, gemm_nn.launches, gemm_tn.launches
    out = merged_backward_schedule(
        g.to(torch.float32), x_tbc.to(torch.float32).contiguous(), h_all, c_all, gates, wcat,
        masks, keep, compute_dtype, CARD_PIECES, carries=carries)
    train = lstm_stack_train
    train.backward_launches += 1
    train.backward_streamed_launches += _backward_streams(h_all, compute_dtype)
    train.backward_recurrence_launches += _recurrence_card.launches - before[0]
    train.backward_gemm_nn_launches += gemm_nn.launches - before[1]
    train.backward_gemm_tn_launches += gemm_tn.launches - before[2]
    return out


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
    compute_dtype: torch.dtype = torch.float32, merged: bool | None = None,
) -> torch.Tensor:
    """Training forward of the stacked LSTM: x [B, T, C] -> h_top [B, H] at
    the last step, float32 (float64 under float64), differentiable.

    `masks` are int8 {0, 1} [L-1, T, B, H] (time-major, as the JAX
    package's) dropping each inter-layer output with scale 1/keep, or None.
    `merged` (None: read `_MERGED_GATES`) False runs the unmerged-gates
    stack (rows 14-15).
    """
    if not (_MERGED_GATES if merged is None else merged):
        return lstm_stack_split(layers, x, masks=masks, keep=keep, compute_dtype=compute_dtype)
    if x.device.type == "cpu" or compute_dtype == torch.float64:
        return lstm_stack_plain(layers, x, compute_dtype, masks, keep)
    if x.device.type != "cuda":
        raise TypeError(f"no LSTM kernel for device {x.device}")
    _check_lstm(layers, x, compute_dtype)
    rows, t_len, c_in = x.shape
    hidden = layers[0].wh.shape[0]
    _check_train(x, masks, rows, t_len, c_in, hidden, len(layers))
    b2d = torch.stack([layer.b for layer in layers])
    wcat = [torch.cat([layer.wx, layer.wh]) for layer in layers]
    return _LstmStackTrain.apply(x.transpose(0, 1), masks, keep, compute_dtype, b2d, *wcat)


lstm_stack_train.launches = 0  # forwards run through the CUDA kernels (row 4)
# Row 4's pieces: its gemm_nn and forward recurrence launches (one each a layer).
lstm_stack_train.forward_gemm_nn_launches = 0
lstm_stack_train.forward_recurrence_launches = 0
lstm_stack_train.backward_launches = 0  # backwards run through the kernels (row 5)
# Row 5's pieces: its recurrence and gemm_nn launches (one each a layer)
# and gemm_tn launches (two a layer).
lstm_stack_train.backward_recurrence_launches = 0
lstm_stack_train.backward_gemm_nn_launches = 0
lstm_stack_train.backward_gemm_tn_launches = 0
# Forwards and backwards whose recurrences ran on a streamed plan (past the
# clusters that hold Wh: `lstm_kernel=pallas_stack`).
lstm_stack_train.streamed_launches = 0
lstm_stack_train.backward_streamed_launches = 0
# Calls that a route chosen by shape sent to the plain stack because no
# cluster plan holds Wh (`stack_planned`): `lstm_kernel="auto"` in
# models/lstm.apply_lstm, second order's fused gradient in train/so_fused.
lstm_stack_train.plain_routes = 0


def _check_train(x, masks, rows, t_len, c_in, hidden, n_layers, lead=()):
    """Raise on what the training kernels do not take (widths, the input's
    dtype, the masks' dtype, shape, device and layout)."""
    if c_in % 8 or hidden % 8 or c_in > 7 * hidden:
        raise ValueError(
            f"the LSTM training kernels take widths that are multiples of 8 "
            f"with input <= 7 x hidden, got {c_in} and {hidden}"
        )
    cuda_build.dtype_code(x.dtype)
    shape = (*lead, n_layers - 1, t_len, rows, hidden)
    if masks is not None and (
        masks.dtype != torch.int8 or masks.device != x.device
        or masks.shape != shape or not masks.is_contiguous()
    ):
        raise ValueError(f"masks must be contiguous int8 {list(shape)} on the input's device")


def _on_card(x: torch.Tensor, compute_dtype: torch.dtype) -> bool:
    """False for the plain versions' inputs (a CPU tensor, float64); True
    on a card; raise on any other device."""
    if x.device.type == "cpu" or compute_dtype == torch.float64:
        return False
    if x.device.type != "cuda":
        raise TypeError(f"no LSTM kernel for device {x.device}")
    return True


# --------------------------------------------------------------------------
# Rows 16-17: the merged training stack for V tasks, each with its own
# weights (the JAX package's custom_vmap rules of the merged stack under
# `_VBATCH`, `_fwd_pallas_mv` / `_bwd_pallas_mv`).


def lstm_stack_tasks_plain(
    x: torch.Tensor, wcat0: torch.Tensor, wcatr: torch.Tensor, b2d: torch.Tensor,
    masks: torch.Tensor | None = None, keep: float = 1.0,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain version of `lstm_stack_train_tasks`: `lstm_stack_plain` per
    task, each layer's [[wx], [wh]] split back. Differentiable."""
    hidden = b2d.shape[-1] // 4

    def layers(v):
        return [SimpleNamespace(wx=w[:-hidden], wh=w[-hidden:], b=b)
                for w, b in zip([wcat0[v], *wcatr[v]], b2d[v])]

    return torch.stack([
        lstm_stack_plain(layers(v), x[v], compute_dtype, None if masks is None else masks[v],
                         keep) for v in range(x.shape[0])])


def _per_task(fn, *ts):
    """fn(*ts) for arrays with a leading task axis; where every one is
    shared by the V tasks (task stride 0, an `expand`), fn of task 0's
    slices broadcast back with task stride 0, so no array is copied a task."""
    nv = ts[0].shape[0]
    if nv > 1 and all(t.stride(0) == 0 for t in ts):
        out = fn(*(t[:1] for t in ts))
        return out.expand(nv, *out.shape[1:])
    return fn(*ts)


def tasks_forward(x_vtbc, masks, keep, compute_dtype, wcat0, wcatr, b2d):
    """Row 16 on a CUDA tensor: x_vtbc [V, T, B, C], wcat0 [V, C + H, 4H],
    wcatr [V, L-1, 2H, 4H], b2d [V, L, 4H] -> (h_last [V, B, H] float32,
    h_all, c_all [V, L, T, B, H] in the compute dtype, the activated gates
    [V, L, T, B, 4H] float32), by `tasks_forward_schedule`'s schedule, its L
    products and L recurrences (each one launch for all V tasks) enqueued by
    one C call (csrc/lstm_stack_fwd.cu). x_vtbc is read time-major in float32
    (a copy unless it is so already); the weights are cast once a call,
    once for all tasks where they share them (task stride 0)."""
    n_layers = b2d.shape[1]
    w0, wr = (_per_task(lambda w: w.to(compute_dtype).contiguous(), w) for w in (wcat0, wcatr))
    out = _stack_forward_card(x_vtbc.to(torch.float32).contiguous(), masks, keep, compute_dtype,
                              b2d, _task_layers_card(w0, wr, x_vtbc.shape[-1], b2d.shape[-1] // 4),
                              "LSTM train forward (tasks)")
    tasks = lstm_stack_train_tasks
    tasks.launches += 1
    tasks.forward_gemm_nn_launches += n_layers
    tasks.forward_recurrence_launches += n_layers
    return out


def tasks_backward(g, x_vtbc, h_all, c_all, gates, wcat0, wcatr, masks, keep,
                   compute_dtype):
    """Row 17 on a CUDA tensor: the gradient g [V, B, H] of each task's last
    h back to (dx [V, T, B, C], dwcat0 [V, C + H, 4H], dwcatr [V, L-1, 2H,
    4H], db [V, L, 4H]) float32 (x_vtbc: row 16's time-major float32 x), by
    `tasks_backward_schedule` on the
    kernels: per layer, for all V tasks at once, one recurrence launch
    (csrc/lstm_scan_bwd.cuh, from row 16's stored gates, with the bias
    gradient's partials), one gemm_nn launch for the input gradient and two
    gemm_tn launches for the weight gradients, each followed by the
    `sum_splits` of its partials."""
    before = _recurrence_card.launches, gemm_nn.launches, gemm_tn.launches
    out = tasks_backward_schedule(
        g.to(torch.float32), x_vtbc.to(torch.float32).contiguous(), h_all, c_all, gates,
        wcat0, wcatr, masks, keep, compute_dtype, CARD_PIECES)
    tasks = lstm_stack_train_tasks
    tasks.backward_launches += 1
    tasks.backward_recurrence_launches += _recurrence_card.launches - before[0]
    tasks.backward_gemm_nn_launches += gemm_nn.launches - before[1]
    tasks.backward_gemm_tn_launches += gemm_tn.launches - before[2]
    return out


class _LstmStackTasks(torch.autograd.Function):
    """Rows 16 and 17 as one differentiable op over (x_vtbc, wcat0, wcatr,
    b2d), every argument with a leading task axis."""

    @staticmethod
    def forward(ctx, x_vtbc, masks, keep, compute_dtype, wcat0, wcatr, b2d):
        # The one time-major float32 copy of x: row 16 reads it, row 17 too.
        x = x_vtbc.to(torch.float32).contiguous()
        out, h_all, c_all, gates = tasks_forward(x, masks, keep, compute_dtype, wcat0, wcatr, b2d)
        ctx.compute_dtype, ctx.keep, ctx.x_dtype = compute_dtype, keep, x_vtbc.dtype
        ctx.save_for_backward(x, masks, h_all, c_all, gates, wcat0, wcatr)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, masks, h_all, c_all, gates, wcat0, wcatr = ctx.saved_tensors
        dx, dwcat0, dwcatr, db = tasks_backward(
            g, x, h_all, c_all, gates, wcat0, wcatr, masks, ctx.keep, ctx.compute_dtype)
        return dx.to(ctx.x_dtype), None, None, None, dwcat0, dwcatr, db


def lstm_stack_train_tasks(
    x: torch.Tensor, wcat0: torch.Tensor, wcatr: torch.Tensor, b2d: torch.Tensor, *,
    masks: torch.Tensor | None = None, keep: float = 1.0,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Training forward of V tasks' stacked LSTMs, each with its own
    weights: x [V, B, T, C] -> h_top [V, B, H] at the last step, float32
    (float64 under float64), differentiable.

    wcat0 [V, C + H, 4H] and wcatr [V, L-1, 2H, 4H] hold each layer's
    [[wx], [wh]] (float32), b2d [V, L, 4H] its fused bias; `masks` are int8
    {0, 1} [V, L-1, T, B, H] (each task's time-major masks) dropping each
    inter-layer output with scale 1/keep, or None.
    """
    if not _on_card(x, compute_dtype):
        return lstm_stack_tasks_plain(x, wcat0, wcatr, b2d, masks, keep, compute_dtype)
    nv, rows, t_len, c_in = x.shape
    n_layers, g4 = b2d.shape[1:]
    hidden = g4 // 4
    if (
        b2d.shape != (nv, n_layers, g4) or g4 % 4
        or wcat0.shape != (nv, c_in + hidden, g4)
        or wcatr.shape != (nv, n_layers - 1, 2 * hidden, g4)
    ):
        raise ValueError(
            f"task-stacked LSTM weights of the wrong shape: x {list(x.shape)}, wcat0 "
            f"{list(wcat0.shape)}, wcatr {list(wcatr.shape)}, b2d {list(b2d.shape)}"
        )
    if any(p.device != x.device or p.dtype != torch.float32 for p in (wcat0, wcatr, b2d)):
        raise TypeError("LSTM weights must be float32 on the input's device")
    _check_train(x, masks, rows, t_len, c_in, hidden, n_layers, lead=(nv,))
    cuda_build.dtype_code(compute_dtype)
    return _LstmStackTasks.apply(x.transpose(1, 2), masks, keep, compute_dtype,
                                 wcat0, wcatr, b2d)


lstm_stack_train_tasks.launches = 0  # forwards run through the CUDA kernels (row 16)
# Row 16's pieces: its gemm_nn and forward recurrence launches (one each a layer).
lstm_stack_train_tasks.forward_gemm_nn_launches = 0
lstm_stack_train_tasks.forward_recurrence_launches = 0
lstm_stack_train_tasks.backward_launches = 0  # backwards run through the kernels (row 17)
# Row 17's pieces: its recurrence and gemm_nn launches (one each a layer)
# and gemm_tn launches (two a layer).
lstm_stack_train_tasks.backward_recurrence_launches = 0
lstm_stack_train_tasks.backward_gemm_nn_launches = 0
lstm_stack_train_tasks.backward_gemm_tn_launches = 0


# --------------------------------------------------------------------------
# Rows 14-15: the unmerged-gates stack (the JAX package's `_stack_pallas`,
# Pallas bodies `_fwd_kernel` and `_bwd_kernel`). Its residuals are JAX's:
# h_all and c_all [L, T, B, H] in the compute dtype, no gates; the backward
# recomputes each stage's gates from them.


def _split_weights(layers):
    """(wx0 [C, 4H], wxr [L-1, H, 4H], wh [L, H, 4H], b2d [L, 4H]) from the
    layers, differentiable; wxr is empty for one layer."""
    wx0 = layers[0].wx
    wxr = (torch.stack([layer.wx for layer in layers[1:]]) if len(layers) > 1
           else wx0.new_zeros((0, *layers[0].wh.shape)))
    wh = torch.stack([layer.wh for layer in layers])
    b2d = torch.stack([layer.b for layer in layers])
    return wx0, wxr, wh, b2d


def split_forward_plain(x_tbc, wx0, wxr, wh, b2d, masks=None, keep=1.0,
                        compute_dtype=torch.float32):
    """Plain version of row 14, JAX `_fwd_kernel`'s arithmetic: x_tbc
    [T, B, C] -> (h_last [B, H] in the accumulation dtype, h_all, c_all
    [L, T, B, H] in the compute dtype)."""
    t_len = x_tbc.shape[0]
    n_layers = wh.shape[0]
    h = [torch.zeros((x_tbc.shape[1], wh.shape[1]), dtype=accum_dtype(compute_dtype),
                     device=x_tbc.device)] * n_layers
    c = list(h)
    hs, cs = [], []
    for t in range(t_len):
        inp = as_operand(x_tbc[t], compute_dtype)
        for l in range(n_layers):
            wx = wx0 if l == 0 else wxr[l - 1]
            gates = (torch.matmul(inp, as_operand(wx, compute_dtype))
                     + torch.matmul(as_operand(h[l], compute_dtype),
                                    as_operand(wh[l], compute_dtype)) + b2d[l])
            i, f, g, o = gates.split(wh.shape[1], dim=-1)
            c[l] = torch.sigmoid(f) * c[l] + torch.sigmoid(i) * torch.tanh(g)
            h[l] = torch.sigmoid(o) * torch.tanh(c[l])
            hs.append(h[l])
            cs.append(c[l])
            if l < n_layers - 1:
                nxt = h[l] if masks is None else apply_mask(h[l], masks[l, t], keep)
                inp = as_operand(nxt, compute_dtype)

    def residual(vals):  # [T * L] in step order -> [L, T, B, H]
        return (torch.stack(vals).view(t_len, n_layers, *vals[0].shape).transpose(0, 1)
                .to(compute_dtype).contiguous())

    return h[-1], residual(hs), residual(cs)


def split_backward_plain(g, x_tbc, h_all, c_all, wx0, wxr, wh, b2d, masks=None, keep=1.0,
                         compute_dtype=torch.float32):
    """Plain version of row 15, JAX `_bwd_kernel`'s arithmetic: from the
    gradient g [B, H] of the top layer's last h and row 14's residuals, the
    reverse-time recurrence recomputing each stage's gates -> (dx [T, B, C],
    dwx0 [C, 4H], dwxr [L-1, H, 4H], dwh [L, H, 4H], db [L, 4H]) in the
    accumulation dtype."""
    acc = accum_dtype(compute_dtype)
    t_len, rows, _ = x_tbc.shape
    n_layers, hidden = wh.shape[:2]

    def op(a):
        return as_operand(a, compute_dtype)

    zero = torch.zeros((rows, hidden), dtype=acc, device=x_tbc.device)
    dh, dc = [zero] * n_layers, [zero] * n_layers
    dx = [None] * t_len
    dwx = [torch.zeros_like(wx0, dtype=acc)] + [torch.zeros_like(w, dtype=acc) for w in wxr]
    dwh = [torch.zeros_like(w, dtype=acc) for w in wh]
    db = [torch.zeros_like(b, dtype=acc) for b in b2d]
    for t in reversed(range(t_len)):
        d_above = None
        for l in reversed(range(n_layers)):
            h_prev = zero if t == 0 else h_all[l, t - 1].to(acc)
            c_prev = zero if t == 0 else c_all[l, t - 1].to(acc)
            if l == 0:
                inp, wx = op(x_tbc[t]), wx0
            else:
                inp = h_all[l - 1, t].to(acc)
                if masks is not None:
                    inp = apply_mask(inp, masks[l - 1, t], keep)
                inp, wx = op(inp), wxr[l - 1]
            gates = torch.matmul(inp, op(wx)) + torch.matmul(op(h_prev), op(wh[l])) + b2d[l]
            i, f, gg, o = gates.split(hidden, dim=-1)
            i, f, gg, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(gg), torch.sigmoid(o)
            tc = torch.tanh(c_all[l, t].to(acc))
            dhl = dh[l]
            if l == n_layers - 1 and t == t_len - 1:
                dhl = dhl + g.to(acc)
            if d_above is not None:
                dhl = dhl + d_above
            dcl = dc[l] + dhl * o * (1.0 - tc * tc)
            dgates = torch.cat([dcl * gg * i * (1.0 - i), dcl * c_prev * f * (1.0 - f),
                                dcl * i * (1.0 - gg * gg), dhl * tc * o * (1.0 - o)], dim=-1)
            dgc = op(dgates)
            dh[l] = torch.matmul(dgc, op(wh[l]).t())
            dc[l] = dcl * f
            d_in = torch.matmul(dgc, op(wx).t())
            if l == 0:
                dx[t] = d_in
            else:
                d_above = d_in if masks is None else apply_mask(d_in, masks[l - 1, t], keep)
            dwx[l] = dwx[l] + torch.matmul(inp.t(), dgc)
            dwh[l] = dwh[l] + torch.matmul(op(h_prev).t(), dgc)
            db[l] = db[l] + dgates.sum(dim=0)
    dwxr = torch.stack(dwx[1:]) if n_layers > 1 else torch.zeros_like(wxr, dtype=acc)
    return torch.stack(dx), dwx[0], dwxr, torch.stack(dwh), torch.stack(db)


def split_forward(x_tbc, wx0, wxr, wh, b2d, masks, keep, compute_dtype, residuals=True,
                  counter=None):
    """Row 14 on a CUDA tensor (its plain version on a CPU tensor or under
    float64): -> (h_last [B, H] float32, h_all, c_all [L, T, B, H] in the
    compute dtype, or None without `residuals`), by
    `split_forward_schedule`'s schedule (row 4's), its L products and L
    recurrences enqueued by one C call (csrc/lstm_stack_fwd.cu). The call
    and its launches count on `counter` (None: `lstm_stack_split`; row 20's
    train-mode forward counts on its own entry)."""
    if not _on_card(x_tbc, compute_dtype):
        return split_forward_plain(x_tbc, wx0, wxr, wh, b2d, masks, keep, compute_dtype)
    return _split_forward_card(x_tbc, [wx0, *wxr], list(wh), b2d, masks, keep, compute_dtype,
                               residuals, counter or lstm_stack_split,
                               "LSTM unmerged-gates forward")


def _split_forward_card(x_tbc, wx, wh, b2d, masks, keep, compute_dtype, residuals, counter,
                        what):
    """Row 14's schedule on the card from the layers' wx = [Wx_l [K_l, 4H]]
    and wh = [Wh_l [H, 4H]] float32, b2d [L, 4H]: one C call, one gates
    buffer for every layer (without `residuals` one h buffer too, no c),
    counted on `counter` (a streamed plan also on its `streamed_launches`).
    The recurrences' plan is `forward_plan`'s, without residuals (the eval
    forward) `eval_plan`'s."""
    n_layers = len(wh)
    plan = (forward_plan if residuals else eval_plan)(
        wh[0].shape[0], x_tbc.shape[1], compute_dtype.itemsize, _sms(x_tbc.device))
    # `weights` keeps the compute-dtype weights alive while the call enqueues.
    layers, weights = _one_task_layers(wx, wh, compute_dtype, plan)
    h_last, h_all, c_all, _ = _stack_forward_card(
        x_tbc[None], _one_task(masks), keep, compute_dtype, b2d[None], layers, what,
        keep_gates=False, residuals=residuals, plan=plan)
    counter.launches += 1
    counter.streamed_launches += streams(plan, wh[0].shape[0])
    counter.forward_gemm_nn_launches += n_layers
    counter.forward_recurrence_launches += n_layers
    return (h_last[0], h_all[0], c_all[0]) if residuals else (h_last[0], None, None)


# Rows 5, 15 and 17 on a card run layer by layer, so that only the dh carry
# through Wh^T is on the serial chain (the TPU kernels walk all T x L
# stages as one chain: rows 5 and 17 with one contraction a stage against
# [Wx; Wh]^T, row 15 with four). Every tensor carries a leading task axis
# V (row 17: V tasks, each with its own weights; rows 5 and 15: V = 1), and
# each product below is one launch for all V tasks. For l = L-1 .. 0:
#   1. row 15 only: the gates of all T x R rows at once, act(round(in_l) @
#      Wx_l + round(h_all[l, t-1]) @ Wh_l + b_l): one product of two operand
#      pairs, the second at a row offset of R (h_{-1} = 0), with the gate
#      epilogue; in_l is x, or h_all[l-1] times its dropout mask and 1/keep,
#      rounded. Rows 5 and 17 read the activated gates rows 4 and 16 stored;
#   2. the recurrence, one contraction a step (csrc/lstm_scan_bwd.cuh), from
#      the gradient g_l of the layer's h sequence: zero but for g at the top
#      layer's last step, the input gradient of the layer above below it;
#      also db_l, the column sums of dgates_l; for second order also each
#      step's dh and dc;
#   3. the input gradient round(dgates_l) @ Wx_l^T: dx at l = 0, else
#      g_{l-1}, times the mask and 1/keep (the mask epilogue);
#   4. the layer's weight gradients, dWx_l = round(in_l)^T round(dgates_l)
#      and dWh_l = round(h_{t-1})^T round(dgates_l) over every step and row:
#      two TN products split over the T x R rows (h_{t-1} at a row offset of
#      R), their float32 partials added in split order (no atomics: two runs
#      give the same bits). One layer's dgates buffer serves every layer,
#      but for second order, which reads every layer's dgates back.
# The pieces are swappable: the kernels on a card (`CARD_PIECES`), their
# plain versions (`PLAIN_PIECES`) in the CPU tests.


@dataclasses.dataclass(frozen=True)
class SplitPieces:
    """product: `gemm_nn`'s signature (ops/gemm.py); recurrence(g, gates,
    c, wh, compute_dtype, out, dh=None, dc=None, db=None) -> dgates [V, T,
    R, 4H] into out (and each step's dh, dc [V, T, R, H] into dh, dc where
    given, the column sums of dgates [V, 4H] into db where given), wh [V, H,
    4H] in the compute dtype; product_tn: `gemm_tn`'s signature;
    sum_splits(part [S, M, N], out [M, N], what): out = the sum over S."""

    product: Callable
    recurrence: Callable
    product_tn: Callable
    sum_splits: Callable


def backward_schedule(g, x, h_all, c_all, wx, wh, masks, keep, compute_dtype,
                      pieces: SplitPieces, gates=None, b2d=None, carries=False):
    """The layer-by-layer schedule above on `pieces` for V tasks, every
    tensor with a leading task axis, from the gradient g [V, B, H] of the
    top layer's last h: -> (dx [V, T, B, C], dw [V, L, K + H, 4H], db [V,
    L, 4H], and with `carries` dgates [V, L, T, B, 4H], dh_all, dc_all [V,
    L, T, B, H], else None) in the accumulation dtype. Layer l's weight
    gradient [[dWx_l], [dWh_l]] is the last K_l + H rows of dw[:, l] (K =
    max(C, H), K_l = C at l = 0, else H; `dwcat_views` cuts the views). x
    [V, T, B, C], h_all, c_all [V, L, T, B, H], wx = [Wx_0 [V, C, 4H], Wx_1
    [V, H, 4H], ...], wh [V, L, H, 4H], masks [V, L-1, T, B, H]. `gates` [V,
    L, T, B, 4H] are the activated gates (rows 5, 17); None recomputes each
    layer's from h_all, c_all and b2d [V, L, 4H] (row 15, one task)."""
    acc = accum_dtype(compute_dtype)
    dev = x.device
    nv, t_len, rows, c_in = x.shape
    n_layers, hidden, g4 = wh.shape[1:]
    steps = t_len * rows
    if gates is None and nv != 1:
        raise ValueError("the schedule recomputes the gates of one task only")
    wxs = [_per_task(lambda t: t.to(compute_dtype), w) for w in wx]
    whs = _per_task(lambda t: t.to(compute_dtype), wh)
    dgates = torch.empty((nv, n_layers if carries else 1, t_len, rows, g4), dtype=acc,
                         device=dev)
    dh_all = dc_all = None
    if carries:
        dh_all = torch.empty((nv, n_layers, t_len, rows, hidden), dtype=acc, device=dev)
        dc_all = torch.empty_like(dh_all)
    g_l = torch.zeros((nv, t_len, rows, hidden), dtype=acc, device=dev)
    g_l[:, -1] = g
    # The input gradients of the layers below the top, in the masks' layout:
    # the mask epilogue reads the mask at the output's offsets.
    g_below = (torch.empty((nv, n_layers - 1, t_len, rows, hidden), dtype=acc, device=dev)
               if n_layers > 1 else None)
    dx = torch.empty((nv, steps, c_in), dtype=acc, device=dev)
    h_in = None
    if n_layers > 1:
        # The layers' inputs above layer 0, masked and rounded once for all.
        h_in = h_all[:, :-1]
        if masks is not None:
            h_in = apply_mask(h_in.to(acc), masks, keep).to(compute_dtype)
    if gates is None:
        gate_buf = torch.empty((nv, steps, g4), dtype=acc, device=dev)  # reused by every layer
    x_c = x.reshape(nv, steps, c_in).to(compute_dtype)
    k_max = max(c_in, hidden)
    # One split plan for both products of every layer: a wave of one task's
    # recurrent weight gradient's [H, 4H] tiles (256 rows at R = 512), at
    # any task count, so that each task's weight gradients are bitwise those
    # of its one-task call (rows 16-17 add as rows 4-5 do, task by task);
    # the partials of one layer at a time.
    split_rows = wave_split_rows(steps, hidden, g4, 1, _card_sms(dev))
    splits = tn_splits(steps, split_rows)
    part_buf = torch.empty(splits * nv * (k_max + hidden) * g4, dtype=acc, device=dev)
    dw = torch.empty((nv, n_layers, k_max + hidden, g4), dtype=acc, device=dev)
    db = torch.empty((nv, n_layers, g4), dtype=acc, device=dev)

    def layer_input(l):
        return x.reshape(nv, steps, c_in) if l == 0 else h_in[:, l - 1].reshape(nv, steps, hidden)

    for l in reversed(range(n_layers)):
        if gates is None:
            prev = {} if t_len == 1 else dict(
                a2=h_all[:, l, :-1].reshape(nv, steps - rows, hidden), b2=whs[:, l],
                row_offset=rows)
            pieces.product(layer_input(l), wxs[l], compute_dtype=compute_dtype, epilogue="gates",
                           bias=b2d[0, l], out=gate_buf, what=f"LSTM layer {l} gates", **prev)
            gates_l = gate_buf.view(nv, t_len, rows, g4)
        else:
            gates_l = gates[:, l]
        dg_l = dgates[:, l if carries else 0]
        pieces.recurrence(g_l, gates_l, c_all[:, l], whs[:, l], compute_dtype, dg_l,
                          *(() if dh_all is None else (dh_all[:, l], dc_all[:, l])),
                          db=db[:, l])
        dg = dg_l.reshape(nv, steps, g4)
        # The transpose just before its use: on a card its host work runs
        # while the recurrence does.
        wxt = _per_task(lambda t: t.transpose(-1, -2).contiguous(), wxs[l])
        if l == 0:
            pieces.product(dg, wxt, compute_dtype=compute_dtype, out=dx,
                           what="LSTM input gradient")
        else:
            mask = None if masks is None else masks[:, l - 1].reshape(nv, steps, hidden)
            g_l = g_below[:, l - 1]
            pieces.product(dg, wxt, compute_dtype=compute_dtype,
                           epilogue="none" if mask is None else "mask", mask=mask,
                           scale=1.0 / keep, out=g_l.reshape(nv, steps, hidden),
                           what=f"LSTM layer {l} input gradient")
        k_l = c_in if l == 0 else hidden
        dgc = dg.to(compute_dtype)
        part = part_buf[:splits * nv * (k_l + hidden) * g4].view(splits, nv, k_l + hidden, g4)
        by_task = part.transpose(0, 1)  # [V, S, K_l + H, 4H]
        pieces.product_tn(x_c if l == 0 else layer_input(l), dgc, by_task[:, :, :k_l],
                          compute_dtype=compute_dtype, split_rows=split_rows,
                          what=f"LSTM layer {l} input weight gradient")
        pieces.product_tn(h_all[:, l, :-1].reshape(nv, steps - rows, hidden), dgc,
                          by_task[:, :, k_l:], compute_dtype=compute_dtype,
                          split_rows=split_rows, a_row_offset=rows,
                          what=f"LSTM layer {l} recurrent weight gradient")
        pieces.sum_splits(part.view(splits, nv, -1), dw[:, l, k_max - k_l:].view(nv, -1),
                          f"LSTM layer {l} weight gradient partials")
    return (dx.view(nv, t_len, rows, c_in), dw, db,
            *((dgates, dh_all, dc_all) if carries else (None, None, None)))


def dwcat_views(dw, c_in):
    """`backward_schedule`'s dw [V, L, K + H, 4H] -> views (dwcat0 [V, C +
    H, 4H], dwcatr [V, L-1, 2H, 4H]), each layer's [[dWx_l], [dWh_l]]."""
    hidden = dw.shape[-1] // 4
    k_max = dw.shape[2] - hidden
    return dw[:, 0, k_max - c_in:], dw[:, 1:, k_max - hidden:]


def _one_task(t):
    return None if t is None else t[None]


def _first_task(t):
    return None if t is None else t[0]


def _task(t, v):
    return None if t is None else t[v]


def split_backward_schedule(g, x_tbc, h_all, c_all, wx0, wxr, wh, b2d, masks, keep,
                            compute_dtype, pieces: SplitPieces):
    """Row 15's function (`split_backward_plain`'s outputs: dx, dwx0, dwxr,
    dwh, db) by `backward_schedule` on `pieces` (one task), each layer's
    gates recomputed. The weight gradients are views of the schedule's dw:
    dwxr [L-1, H, 4H] and dwh [L, H, 4H] strided by its layers."""
    c_in, hidden = x_tbc.shape[-1], wh.shape[1]
    dx, dw, db, *_ = backward_schedule(
        g[None], x_tbc[None], h_all[None], c_all[None], [wx0[None], *(w[None] for w in wxr)],
        wh[None], _one_task(masks), keep, compute_dtype, pieces, b2d=b2d[None])
    k_max = dw.shape[2] - hidden
    dw = dw[0]  # layer l's slot: k_max - K_l unused rows, dWx_l, dWh_l
    return dx[0], dw[0, k_max - c_in:k_max], dw[1:, k_max - hidden:k_max], dw[:, k_max:], db[0]


def merged_backward_schedule(g, x_tbc, h_all, c_all, gates, wcat, masks, keep, compute_dtype,
                             pieces: SplitPieces, carries=False):
    """Row 5's function (`fused_lstm_hvp.hvp_bwd_plain`'s outputs: dx,
    [dwcat_l], db, dgates, dh_all, dc_all; the last three None without
    `carries`) by `backward_schedule` on `pieces` (one task), from row 4's
    stored activated gates [L, T, B, 4H] and the merged weights wcat_l =
    [[Wx_l], [Wh_l]]; each dwcat_l a view of the schedule's dw."""
    hidden = gates.shape[-1] // 4
    wh = torch.stack([w[-hidden:] for w in wcat])
    dx, dw, db, dgates, dh_all, dc_all = backward_schedule(
        g[None], x_tbc[None], h_all[None], c_all[None], [w[:-hidden][None] for w in wcat],
        wh[None], _one_task(masks), keep, compute_dtype, pieces, gates=gates[None],
        carries=carries)
    dwcat0, dwcatr = dwcat_views(dw, x_tbc.shape[-1])
    return (dx[0], [dwcat0[0], *dwcatr[0].unbind(0)], db[0], _first_task(dgates),
            _first_task(dh_all), _first_task(dc_all))


def tasks_backward_schedule(g, x, h_all, c_all, gates, wcat0, wcatr, masks, keep,
                            compute_dtype, pieces: SplitPieces):
    """Row 17's function (`lstm_stack_tasks_plain`'s gradients: dx [V, T,
    B, C], dwcat0 [V, C + H, 4H], dwcatr [V, L-1, 2H, 4H], db [V, L, 4H]) by
    `backward_schedule` on `pieces`, from row 16's stored activated gates
    [V, L, T, B, 4H] and each task's merged weights."""
    hidden = gates.shape[-1] // 4
    wcat = [wcat0, *wcatr.unbind(1)]
    wh = _per_task(lambda *ws: torch.stack([w[:, -hidden:] for w in ws], dim=1), *wcat)
    dx, dw, db, *_ = backward_schedule(
        g, x, h_all, c_all, [w[:, :-hidden] for w in wcat], wh, masks, keep, compute_dtype,
        pieces, gates=gates)
    return dx, *dwcat_views(dw, x.shape[-1]), db


# The backward recurrence's plan (csrc/lstm_scan_bwd.cuh): Wh^T [4H, H]
# stays in shared memory, its columns split over a cluster of cs blocks.
SCAN_MAX_SMEM = 232448  # 227 KB opt-in per block
SCAN_WARPS = 8  # warps a block


def scan_units(hidden: int, cs: int) -> int:
    """The hidden units each block of a cs-block cluster owns (a multiple
    of 4; the last block may own fewer)."""
    return -(-hidden // (4 * cs)) * 4


def scan_smem(hidden: int, hcp: int, rb: int, itemsize: int) -> int:
    """A block's dynamic shared memory: its mbarrier, its weight slice [4H,
    hcp] and two round(dgates) tiles [rb, 4H] in the compute dtype, its
    warps' partial carries [8, rb, hcp] float32 (`scan_bwd_smem`)."""
    return (16 + 4 * hidden * hcp * itemsize + 2 * rb * 4 * hidden * itemsize
            + SCAN_WARPS * rb * hcp * 4)


# A 16-block cluster (Hopper's non-portable size, beside the portable 1-8)
# needs 16 free SMs of one GPC at a block an SM: an H100 SXM runs
# `H100_CLUSTERS_16` such clusters of the recurrences at once
# (cudaOccupancyMaxActiveClusters on the card, chip_smoke.py prints it), not
# 132 / 16. The plans take 16 blocks only where no cluster of 1-8 holds the
# weight slice (the training stack at float32 H 260-396 and bfloat16 H
# 420-512, the forward recurrence alone to float32 H 436), so every plan a
# cluster of at most 8 holds stays as it was.
H100_CLUSTERS_16 = 7
WIDE_CLUSTER = 16
CLUSTER_SIZES = (1, 2, 4, 8, WIDE_CLUSTER)

# Streamed plans (csrc/lstm_scan_bwd.cuh `SliceStream`): where no cluster of
# 1-16 blocks holds the weight slice (float32 H > 396 backward, > 436
# forward; bfloat16 H > 512), a block keeps the first k_res of its slice's K
# rows (the forward's K = H rows of [4, hcp], the backward's K = 4H rows of
# [hcp]) in shared memory and reads the rest from L2 at every step, in
# chunks of `STREAM_CHUNK` bytes through `STREAM_STAGES` stage buffers.
# Clusters of 8 and 16 blocks (the most rows resident), row tiles of
# `STREAM_TILES_FWD` / `STREAM_TILES_BWD` (the instances built: not 16 rows
# at hcp 128 in bfloat16, whose registers spill), k_res a multiple of 16
# bytes' k values; one task (rows 16-17 take no streamed plan:
# `stack_planned`).
STREAM_CHUNK = 32768
STREAM_STAGES = 2
STREAM_HEADER = 64  # bytes of the streamed blocks' mbarriers
STREAM_SIZES = (8, WIDE_CLUSTER)
STREAM_TILES_FWD = (8, 16)
STREAM_TILES_BWD = (2, 4, 8, 16)
# The cost model that picks among streamed plans (and, for the eval forward,
# between a 16-block plan and a streamed one: `eval_plan`): one step of one
# layer takes waves x (STEP_US + a block's FMAs / FMA_PER_US + a block's
# streamed bytes / L2_BYTES_PER_US) microseconds. STEP_US is a step's fixed
# cost (the cluster barrier, the exchange of h or dgates, the cell; the fit
# gives clusters of 8 and of 16 the same); FMA_PER_US an SM's rate on the
# contraction (about 40% of its float32 peak); L2_BYTES_PER_US what a
# streamed byte costs an SM. Least squares over 46 plans' times, float32 H
# 128-1024 and bfloat16 H 640-1024 (tools/stream_plans.py; PERF.md §6;
# mean error 10%, at most 30%).
STEP_US = 3.1
FMA_PER_US = 128e3
L2_BYTES_PER_US = 75e3


def stream_rows(row_bytes: int) -> int:
    """Rows of one streamed chunk whose rows take `row_bytes` each
    (csrc/lstm_scan_bwd.cuh `stream_rows`)."""
    return STREAM_CHUNK // row_bytes


def _slice_row_bytes(hcp: int, itemsize: int, forward: bool) -> int:
    """Bytes of one K-row of a block's weight slice: [4, hcp] in the forward
    recurrence, [hcp] in the backward."""
    return (4 if forward else 1) * hcp * itemsize


def scan_stream_smem(hidden: int, hcp: int, rb: int, itemsize: int, k_res: int) -> int:
    """A streamed backward block's dynamic shared memory: its mbarriers,
    its resident rows [k_res, hcp] and `STREAM_STAGES` stage buffers of a
    chunk's rows,
    its tiles and partials as `scan_smem`'s (`scan_bwd_stream_smem`)."""
    row = hcp * itemsize
    return (STREAM_HEADER + (k_res + STREAM_STAGES * stream_rows(row)) * row
            + 2 * rb * 4 * hidden * itemsize + SCAN_WARPS * rb * hcp * 4)


def scan_fwd_stream_smem(hidden: int, hcp: int, rb: int, itemsize: int, k_res: int) -> int:
    """A streamed forward block's dynamic shared memory: its mbarriers,
    its resident rows [k_res, 4, hcp] and `STREAM_STAGES` stage buffers of
    a chunk's rows, its tiles and partials as `scan_fwd_smem`'s (csrc/lstm_scan_fwd.cuh
    `scan_fwd_stream_smem`)."""
    row = 4 * hcp * itemsize
    return (STREAM_HEADER + (k_res + STREAM_STAGES * stream_rows(row)) * row
            + 2 * rb * hidden * itemsize + 8 * rb * hcp * 4)


def _waves(cs: int, clusters: int, sms: int) -> int:
    """Waves of `clusters` clusters of cs blocks (16-block ones:
    `H100_CLUSTERS_16` at once)."""
    if cs == WIDE_CLUSTER:
        return -(-clusters // H100_CLUSTERS_16)
    return -(-clusters * cs // sms)


def plan_cost(plan, hidden: int, rows: int, itemsize: int, sms: int, forward: bool) -> float:
    """The cost model's time of one step of one layer (µs) of a one-task
    recurrence plan (cs, hcp, rb, k_res): waves x (`STEP_US` + the block's
    FMAs / `FMA_PER_US` + its streamed bytes a step / `L2_BYTES_PER_US`)."""
    cs, hcp, rb, k_res = plan
    k_rows = hidden if forward else 4 * hidden
    fmas = rb * k_rows * (4 * hcp if forward else hcp)
    streamed = (k_rows - k_res) * _slice_row_bytes(hcp, itemsize, forward)
    return _waves(cs, -(-rows // rb), sms) * (
        STEP_US + fmas / FMA_PER_US + streamed / L2_BYTES_PER_US)


def stream_plans(hidden: int, rows: int, itemsize: int, sms: int, forward: bool):
    """The streamed plans (cs, hcp, rb, k_res) of a recurrence, one task, by
    the cost model's time, cheapest first: for each cluster of
    `STREAM_SIZES` and row tile of `STREAM_TILES_FWD` / `_BWD` (not 16 rows
    at 128 bfloat16 weight columns), the largest k_res (a
    multiple of 16 bytes' k values) whose block fits in shared memory, where
    it is short of K. Ties go to the fewer streamed bytes, then the smaller
    cluster. Empty where no block fits (H > 2048, or its tiles alone fill
    shared memory)."""
    k_rows = hidden if forward else 4 * hidden
    vk = 16 // itemsize
    smem = scan_fwd_stream_smem if forward else scan_stream_smem
    found = []
    for cs in STREAM_SIZES:
        hcp = next((p for p in (32, 64, 128) if p >= scan_units(hidden, cs)), None)
        if hcp is None:
            continue
        row = _slice_row_bytes(hcp, itemsize, forward)
        for rb in STREAM_TILES_FWD if forward else STREAM_TILES_BWD:
            if rb == 16 and hcp == 128 and itemsize == 2:
                continue
            k_res = (SCAN_MAX_SMEM - smem(hidden, hcp, rb, itemsize, 0)) // row // vk * vk
            if not 0 <= k_res < k_rows:
                continue
            plan = (cs, hcp, rb, k_res)
            cost = plan_cost(plan, hidden, rows, itemsize, sms, forward)
            found.append((cost, -(-rows // rb) * cs * (k_rows - k_res) * row, cs, plan))
    return [f[-1] for f in sorted(found)]


def _cluster_plan(hidden: int, rows: int, sms: int, tasks: int, smem: Callable,
                  what: str, k_rows: int, row_tiles=(2, 4, 8, 16),
                  sizes=CLUSTER_SIZES, streamed: Callable | None = None
                  ) -> tuple[int, int, int, int]:
    """(cs, hcp, rb, k_res) of a cluster recurrence whose block takes
    smem(hcp, rb) bytes of shared memory and whose weight slice has
    `k_rows` K-rows: the smallest cluster of `sizes` (16 only where
    none of the smaller sizes fits) whose weight slice fits beside the tiles of a row tile
    (of `row_tiles`) that puts the clusters of all `tasks` tasks' rows on
    `sms` SMs in one wave (`_one_wave`), with the smallest such tile; if no
    cluster reaches one wave, the smallest that fits at all, with its
    largest tile; k_res = k_rows (all rows resident). Where no cluster holds
    the slice, one task and `streamed` given: the first plan `streamed()`
    returns (a streamed plan, k_res < k_rows); else ValueError."""
    fallback = None
    for cs in sizes:
        if cs == WIDE_CLUSTER and fallback is not None:
            break
        hcp = next((p for p in (32, 64, 128) if p >= scan_units(hidden, cs)), None)
        if hcp is None:
            continue
        tiles = [rb for rb in row_tiles if smem(hcp, rb) <= SCAN_MAX_SMEM]
        if not tiles:
            continue
        wave = [rb for rb in tiles if _one_wave((cs, hcp, rb), rows, tasks, sms)]
        if wave:
            return cs, hcp, wave[0], k_rows
        fallback = fallback or (cs, hcp, tiles[-1], k_rows)
    if fallback is None and streamed is not None and tasks == 1:
        fallback = next(iter(streamed()), None)
    if fallback is None:
        raise ValueError(f"the {what} in at most {sizes[-1]} blocks' shared memory; "
                         f"hidden width {hidden} does not fit"
                         + (", nor does a streamed slice" if streamed and tasks == 1 else ""))
    return fallback


@functools.lru_cache(maxsize=None)
def recurrence_plan(hidden: int, rows: int, itemsize: int, sms: int,
                    tasks: int = 1) -> tuple[int, int, int, int]:
    """(cs, hcp, rb, k_res) of the backward recurrence: blocks a cluster,
    weight columns a block (hcp >= `scan_units`, 32 x the units a lane
    owns), rows a cluster, resident K-rows of a block's slice (4H: all), by
    `_cluster_plan` with its shared memory (`scan_smem`); one task past the
    clusters that hold Wh^T, the cheapest streamed plan (`stream_plans`)."""
    return _cluster_plan(hidden, rows, sms, tasks,
                         lambda hcp, rb: scan_smem(hidden, hcp, rb, itemsize),
                         "backward recurrence holds Wh^T", 4 * hidden,
                         streamed=lambda: stream_plans(hidden, rows, itemsize, sms, False))


def scan_fwd_smem(hidden: int, hcp: int, rb: int, itemsize: int) -> int:
    """A forward-recurrence block's dynamic shared memory: its weight slice
    [H, 4, hcp] and two round(h) tiles [rb, H] in the compute dtype, its
    warps' partial gates [2, 4, rb, hcp] float32 (`scan_fwd_smem` in
    csrc/lstm_scan_fwd.cuh)."""
    return 4 * hidden * hcp * itemsize + 2 * rb * hidden * itemsize + 8 * rb * hcp * 4


# The forward recurrence's widest row tile, built at hcp <= 16 x the
# element size (64 weight columns in float32, 32 in bfloat16: its
# accumulators fit in registers there, without spilling): taken for one
# task where no tile of 16 rows or less puts every cluster in one wave and
# it does (validate's 1536 rows in float32).
FWD_WIDE_TILE = 32


@functools.lru_cache(maxsize=None)
def forward_plan(hidden: int, rows: int, itemsize: int, sms: int,
                 tasks: int = 1) -> tuple[int, int, int, int]:
    """(cs, hcp, rb, k_res) of the forward recurrence of rows 2, 4, 14, 16,
    18 and 20 (csrc/lstm_scan_fwd.cuh) for `tasks` tasks: blocks a cluster,
    weight columns a block and gate, rows a cluster, resident K-rows of a
    block's slice (H: all), by `_cluster_plan` with its
    shared memory (`scan_fwd_smem`): at H = 128 and R = 512 on 132 SMs, 2
    blocks x 8 rows in float32, 1 block x 4 rows in bfloat16; R = 1024 or
    two tasks (row 16) double the rows. Where no tile of at most 16 rows
    reaches one wave, one task takes `FWD_WIDE_TILE` rows a cluster if that
    does: R = 1536 in float32, 2 blocks x 32 rows (48 clusters, not 192 in
    three waves). One task past the clusters that hold Wh: the cheapest
    streamed plan (`stream_plans`)."""
    def smem(hcp, rb):
        return scan_fwd_smem(hidden, hcp, rb, itemsize)

    what = "forward recurrence holds Wh"
    plan = _cluster_plan(hidden, rows, sms, tasks, smem, what, hidden,
                         streamed=lambda: stream_plans(hidden, rows, itemsize, sms, True))
    if tasks > 1 or plan[3] < hidden or _one_wave(plan, rows, tasks, sms):
        return plan
    try:  # the wide tile is built at hcp <= 16 x itemsize only, in the plan's kind of cluster
        wide = _cluster_plan(
            hidden, rows, sms, tasks,
            lambda hcp, rb: smem(hcp, rb) if hcp <= 16 * itemsize else SCAN_MAX_SMEM + 1,
            what, hidden, row_tiles=(FWD_WIDE_TILE,),
            sizes=CLUSTER_SIZES if plan[0] == WIDE_CLUSTER else CLUSTER_SIZES[:-1])
    except ValueError:
        return plan
    return wide if _one_wave(wide, rows, tasks, sms) else plan


@functools.lru_cache(maxsize=None)
def eval_plan(hidden: int, rows: int, itemsize: int, sms: int) -> tuple[int, int, int, int]:
    """The eval forward's recurrence plan (rows 2, 14 and 20 without
    dropout): `forward_plan`, but where that is a 16-block plan (float32 H
    260-436, bfloat16 H 420-512: 7 clusters a wave, so validate's 1536 rows
    take 14-28 waves) the cheaper by the cost model (`plan_cost`) of it and
    the cheapest streamed plan, whose clusters of 8 fit more to a wave
    (`stream_plans`): at float32 H 320 and 384 and 1536 or 512 rows, 8
    blocks x 32 rows with most of each slice streamed. Every plan a cluster
    of at most 8 holds is `forward_plan`'s."""
    plan = forward_plan(hidden, rows, itemsize, sms)
    if plan[0] != WIDE_CLUSTER or plan[3] < hidden:
        return plan
    return min([plan, *stream_plans(hidden, rows, itemsize, sms, True)[:1]],
               key=lambda p: plan_cost(p, hidden, rows, itemsize, sms, True))


def _one_wave(plan, rows, tasks, sms):
    """Whether the plan's clusters over `tasks` tasks' rows fit on `sms` SMs
    at once (a block an SM; 16-block clusters: `H100_CLUSTERS_16` of them)."""
    cs, _, rb = plan[:3]
    return _waves(cs, tasks * -(-rows // rb), sms) == 1


def streams(plan, k_rows: int) -> bool:
    """Whether a plan (cs, hcp, rb, k_res) streams part of its slices."""
    return plan[3] < k_rows


def stack_planned(hidden: int, rows: int, compute_dtype: torch.dtype, device: torch.device,
                  tasks: int = 1, c_in: int | None = None) -> bool:
    """Whether `forward_plan` and `recurrence_plan` place the recurrences of
    the training stack of hidden width `hidden` over `rows` rows in
    `compute_dtype` on `device`'s card with Wh resident: rows 4-5 and 14-15
    for one task, rows 16-17 for `tasks`. False where no cluster's shared
    memory holds Wh (float32 H > 396, bfloat16 H > 512: not even a 16-block
    cluster; the forced routes take streamed plans there, the routes that
    ask this the plain stack, as the JAX package's do where
    `stack_supported` fails) and,
    where the input width `c_in` is given, at widths the training kernels do
    not take (`_check_train`: not multiples of 8, or C > 7H); True under
    float64, which runs plain on every route. Off a card the plans assume
    an H100, so the answer is the card's. Pure Python: the plans' own
    answer, before any launch."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        return True
    if c_in is not None and (c_in % 8 or hidden % 8 or c_in > 7 * hidden):
        return False
    sms = _card_sms(device)
    try:
        fwd = forward_plan(hidden, rows, compute_dtype.itemsize, sms, tasks)
        bwd = recurrence_plan(hidden, rows, compute_dtype.itemsize, sms, tasks)
    except ValueError:
        return False
    return not streams(fwd, hidden) and not streams(bwd, 4 * hidden)


def eval_planned(c_in: int, hidden: int, rows: int, compute_dtype: torch.dtype,
                 device: torch.device) -> bool:
    """Whether the eval forward's card schedule (`eval_forward`: rows 2, 14
    and 20 without dropout) takes an LSTM of input width `c_in` and hidden
    width `hidden` over `rows` rows in `compute_dtype` on `device`'s card:
    widths that are multiples of 8 (its input products' K) and a cluster
    that holds Wh (`forward_plan` not streamed: none past float32 H 436 and
    bfloat16 H 512, where `auto` runs the plain stack as before). The plan
    it runs is `eval_plan`'s (at float32 H 320 / 384 the streamed plan,
    which beat the plain stack at validate's 1536 rows in three of the four
    card runs that timed both in turns, and the 16-block plan in all four:
    PERF.md §6). True under float64, which runs plain on every route;
    off a card the H100's answer. Pure Python, asked before any launch, as
    `stack_planned` is for the training stack."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        return True
    if c_in % 8 or hidden % 8:
        return False
    try:
        plan = forward_plan(hidden, rows, compute_dtype.itemsize, _card_sms(device))
    except ValueError:
        return False
    return not streams(plan, hidden)


def recurrence_weights(wh: torch.Tensor, cs: int, hcp: int,
                       compute_dtype: torch.dtype) -> torch.Tensor:
    """wh [..., H, 4H] (a leading task axis or none) -> its transpose's
    column slices [..., cs, 4H, hcp] in the compute dtype: slice b holds
    Wh^T[:, b*hc : b*hc + hc] (hc = `scan_units`), zero-padded to hcp
    columns."""
    hidden, g4 = wh.shape[-2:]
    hc = scan_units(hidden, cs)
    wt = wh.to(compute_dtype).transpose(-1, -2)
    if cs * hc != hidden:
        wt = F.pad(wt, (0, cs * hc - hidden))
    wt = wt.reshape(*wt.shape[:-1], cs, hc)
    if hcp != hc:
        wt = F.pad(wt, (0, hcp - hc))
    return wt.transpose(-3, -2).contiguous()


def forward_weights(wh: torch.Tensor, cs: int, hcp: int,
                    compute_dtype: torch.dtype) -> torch.Tensor:
    """wh [..., H, 4H] (a leading task axis or none) -> the forward
    recurrence's slices for a streamed plan, [..., cs, H, 4, hcp] in the
    compute dtype: slice b, row k, gate q holds Wh[k, q*H + b*hc : q*H +
    b*hc + hc] (hc = `scan_units`), zero-padded to hcp columns (a block
    reads its K-rows of [4, hcp] as they lie)."""
    hidden = wh.shape[-2]
    hc = scan_units(hidden, cs)
    w = wh.to(compute_dtype).reshape(*wh.shape[:-1], 4, hidden)
    if cs * hc != hidden:
        w = F.pad(w, (0, cs * hc - hidden))
    w = w.reshape(*w.shape[:-1], cs, hc)
    if hcp != hc:
        w = F.pad(w, (0, hcp - hc))
    return w.movedim(-2, -4).contiguous()


@functools.lru_cache(maxsize=None)
def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


H100_SMS = 132  # the SMs plans assume off a card, so that the CPU tests plan as it does


def _card_sms(dev):
    return _sms(dev) if dev.type == "cuda" else H100_SMS


def _backward_streams(h_all, compute_dtype):
    """Whether the backward recurrence of a stack whose h_all is [..., T, R,
    H] runs on a streamed plan (one task)."""
    rows, hidden = h_all.shape[-2:]
    return streams(recurrence_plan(hidden, rows, compute_dtype.itemsize,
                                   _card_sms(h_all.device)), 4 * hidden)


def launch_recurrence(entry, what, g, gates, c, wh, compute_dtype, out):
    """One layer's backward recurrence on the card through the C entry
    `entry` (wf_lstm_scan_bwd, row 19): g [T, R, H] float32, gates [T, R,
    4H] float32, c [T, R, H], wh [H, 4H] -> dgates into out."""
    t_len, rows, hidden = g.shape
    plan = recurrence_plan(hidden, rows, compute_dtype.itemsize, _sms(g.device))
    cs, hcp, rb, k_res = plan
    wts = recurrence_weights(wh, cs, hcp, compute_dtype)
    cuda_build.check(
        entry(cuda_build.dtype_code(compute_dtype), cs, hcp, rb, k_res, g.data_ptr(),
              gates.data_ptr(), c.data_ptr(), wts.data_ptr(), out.data_ptr(), t_len, rows,
              hidden, cuda_build.stream_ptr(g.device)),
        f"{what} ({_plan_text(plan, 4 * hidden)})",
    )
    return out


# The stack recurrence's launch arguments, packed as csrc/fused_lstm_split.cu's
# `ScanLaunch`: 26 8-byte integers (pointers as integers).
_SCAN_LAUNCH = struct.Struct("<26q")


def _task_stride(t, nv):
    """t's task stride (0 for one task), after checking that each task's
    slice of t is contiguous, as the recurrences read it."""
    if t is None:
        return 0
    if not t[0].is_contiguous():
        raise ValueError(f"the LSTM recurrences read each task's {list(t.shape[1:])} "
                         f"contiguous, got strides {t.stride()}")
    return t.stride(0) if nv > 1 else 0


def _recurrence_card(g, gates, c, wh, compute_dtype, out, dh=None, dc=None, db=None):
    """The backward recurrence of one layer of V tasks' stacks in one launch
    (rows 5, 15 and 17) through wf_lstm_stack_recurrence: g [V, T, R, H]
    float32, gates [V, T, R, 4H] float32, c [V, T, R, H] in the compute
    dtype, wh [V, H, 4H] -> dgates into out [V, T, R, 4H]; each step's dh
    and dc [V, T, R, H] into dh and dc where given; the column sums of
    dgates [V, 4H] into db where given (a partial a row tile, then one
    `sum_splits`). Each task's slice of each array is contiguous, the task
    strides are the arrays' own; without the task axis, one task."""
    if g.dim() == 3:
        _recurrence_card(g[None], gates[None], c[None], wh[None], compute_dtype, out[None],
                         _one_task(dh), _one_task(dc), _one_task(db))
        return out
    nv, t_len, rows, hidden = g.shape
    dev = g.device
    plan = recurrence_plan(hidden, rows, compute_dtype.itemsize, _sms(dev), nv)
    cs, hcp, rb, k_res = plan
    wts = _per_task(lambda w: recurrence_weights(w, cs, hcp, compute_dtype), wh)
    part = None
    if db is not None:
        part = torch.empty((-(-rows // rb), nv, 4 * hidden), dtype=torch.float32, device=dev)
    sdh = _task_stride(dh, nv)
    if dc is not None and (dc.stride() != dh.stride() or not dc[0].is_contiguous()):
        raise ValueError("the LSTM backward recurrence takes dh and dc in one layout")
    cuda_build.check(
        cuda_build.load().wf_lstm_stack_recurrence(_SCAN_LAUNCH.pack(
            cuda_build.dtype_code(compute_dtype), cs, hcp, rb, nv,
            g.data_ptr(), _task_stride(g, nv), gates.data_ptr(), _task_stride(gates, nv),
            c.data_ptr(), _task_stride(c, nv), wts.data_ptr(), _task_stride(wts, nv),
            out.data_ptr(), _task_stride(out, nv),
            0 if dh is None else dh.data_ptr(), 0 if dc is None else dc.data_ptr(), sdh,
            0 if part is None else part.data_ptr(), 4 * hidden, nv * 4 * hidden,
            t_len, rows, hidden, cuda_build.stream_ptr(dev), k_res)),
        f"LSTM backward recurrence ({nv} task(s), {_plan_text(plan, 4 * hidden)})",
    )
    if part is not None:
        sum_splits(part, db, "LSTM bias gradient partials")
    _recurrence_card.launches += 1
    return out


_recurrence_card.launches = 0  # launches of the stack recurrence (rows 5, 15 and 17)


def _recurrence_plain(g, gates, c, wh, compute_dtype, out, dh=None, dc=None, db=None):
    from weatherforecast_stgcn_maml_tpu_torch.ops.lstm_scan import scan_backward_plain

    for v in range(g.shape[0]):
        dgates, dh_v, dc_v = scan_backward_plain(g[v], gates[v], c[v], wh[v], compute_dtype,
                                                 carries=True)
        out[v].copy_(dgates)
        if dh is not None:
            dh[v].copy_(dh_v)
            dc[v].copy_(dc_v)
        if db is not None:
            db[v].copy_(dgates.sum(dim=(0, 1)))
    return out


CARD_PIECES = SplitPieces(gemm_nn, _recurrence_card, gemm_tn, sum_splits)
PLAIN_PIECES = SplitPieces(gemm_nn_plain, _recurrence_plain, gemm_tn_plain, sum_splits_plain)


def split_backward(g, x_tbc, h_all, c_all, wx0, wxr, wh, b2d, masks, keep, compute_dtype,
                   counter=None):
    """Row 15 on a CUDA tensor (its plain version on a CPU tensor or under
    float64): -> (dx [T, B, C], dwx0, dwxr, dwh, db) float32, by
    `split_backward_schedule` on the kernels: per layer one gemm_nn launch
    for the gates, one recurrence launch (csrc/lstm_scan_bwd.cuh, with the
    bias gradient's partials), one gemm_nn launch for the input gradient and
    two gemm_tn launches for the weight gradients, each followed by the
    `sum_splits` of its partials. The call and its TN launches count on
    `counter` (None: `lstm_stack_split`)."""
    if not _on_card(x_tbc, compute_dtype):
        return split_backward_plain(g, x_tbc, h_all, c_all, wx0, wxr, wh, b2d, masks, keep,
                                    compute_dtype)
    counter = counter or lstm_stack_split
    before = gemm_tn.launches
    out = split_backward_schedule(
        g.to(torch.float32), x_tbc.to(torch.float32).contiguous(),
        h_all.to(compute_dtype).contiguous(), c_all.to(compute_dtype).contiguous(),
        wx0, wxr, wh, b2d.to(torch.float32), masks, keep, compute_dtype, CARD_PIECES)
    counter.backward_launches += 1
    counter.backward_streamed_launches += _backward_streams(h_all, compute_dtype)
    counter.backward_gemm_tn_launches += gemm_tn.launches - before
    return out


class _LstmStackSplit(torch.autograd.Function):
    """Rows 14 and 15 as one differentiable op over (x_tbc, wx0, wxr, wh,
    b2d)."""

    @staticmethod
    def forward(ctx, x_tbc, masks, keep, compute_dtype, wx0, wxr, wh, b2d):
        h_last, h_all, c_all = split_forward(x_tbc, wx0, wxr, wh, b2d, masks, keep,
                                             compute_dtype)
        ctx.compute_dtype, ctx.keep = compute_dtype, keep
        ctx.save_for_backward(x_tbc, masks, h_all, c_all, wx0, wxr, wh, b2d)
        return h_last

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, masks, h_all, c_all, wx0, wxr, wh, b2d = ctx.saved_tensors
        dx, dwx0, dwxr, dwh, db = split_backward(g, x, h_all, c_all, wx0, wxr, wh, b2d, masks,
                                                 ctx.keep, ctx.compute_dtype)
        return dx.to(x.dtype), None, None, None, dwx0, dwxr, dwh, db


def lstm_stack_split(
    layers: Sequence, x: torch.Tensor, *,
    masks: torch.Tensor | None = None, keep: float = 1.0,
    compute_dtype: torch.dtype = torch.float32, train: bool = True,
) -> torch.Tensor:
    """The unmerged-gates stack: x [B, T, C] -> h_top [B, H] at the last
    step, float32 (float64 under float64). In train mode differentiable
    (rows 14 and 15, `masks` as in `lstm_stack_train`); otherwise the eval
    forward, row 14 without its residual stores (on a card `eval_forward`,
    counted here)."""
    on_card = _on_card(x, compute_dtype)
    if not train and on_card:
        return eval_forward(layers, x, compute_dtype, lstm_stack_split)
    wx0, wxr, wh, b2d = _split_weights(layers)
    x_tbc = x.transpose(0, 1)
    if not train:
        return split_forward_plain(x_tbc, wx0, wxr, wh, b2d, None, 1.0, compute_dtype)[0]
    if on_card:
        _check_lstm(layers, x, compute_dtype)
        rows, t_len, c_in = x.shape
        _check_train(x, masks, rows, t_len, c_in, wh.shape[1], len(layers))
    return _LstmStackSplit.apply(x_tbc, masks, keep, compute_dtype, wx0, wxr, wh, b2d)


lstm_stack_split.launches = 0  # forwards run through the CUDA kernels (row 14)
# Row 14's pieces: its gemm_nn and forward recurrence launches (one each a layer).
lstm_stack_split.forward_gemm_nn_launches = 0
lstm_stack_split.forward_recurrence_launches = 0
lstm_stack_split.backward_launches = 0  # backwards run through the kernels (row 15)
lstm_stack_split.backward_gemm_tn_launches = 0  # row 15's weight gradients (two a layer)
# Forwards and backwards whose recurrences ran on a streamed plan.
lstm_stack_split.streamed_launches = 0
lstm_stack_split.backward_streamed_launches = 0
