"""Fused GCN encoder stack, training: every layer's
`h = relu(A_hat @ (h @ W_l) + b_l) * mask_l / keep` over all time slices,
with a hand-written backward.

`gcn_stack_train` runs the CUDA kernels behind one `torch.autograd.Function`
on a CUDA tensor: the forward (row 6) on the pipelined GEMM core
(csrc/gemm_nn.cu, two products a layer: `forward_schedule`), the backward
(row 7) layer by layer on the same core (NN products and the K-split TN
weight gradient; `backward_schedule`) and
csrc/fused_gcn_train.cu (the top layer's relu / dropout gradient, the
transposes); its plain PyTorch version,
`gcn_stack_train_plain` (the layerwise route, autograd for the backward),
on a CPU tensor or under float64. On a CUDA tensor a shape or dtype the
kernels do not take raises; nothing falls back to the plain version there.

Counterpart of `weatherforecast_stgcn_maml_tpu/ops/fused_gcn_train.py`
(`gcn_stack_train` / `_gcn_train_pallas`, Pallas bodies `_fwd_kernel` and
`_bwd_kernel`). Masks are int8 {0, 1} [n_masks, W, N, hid] with the 1/keep
scale folded into the kernels; the model draws them (models/common.py).
Every layer's post-dropout activation is kept in the compute dtype as the
backward's residual, and the stack's output is the last one, so under
bfloat16 the output is bfloat16.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Sequence

import torch

from weatherforecast_stgcn_maml_tpu_torch.models.common import accum_dtype
from weatherforecast_stgcn_maml_tpu_torch.ops import cuda_build
from weatherforecast_stgcn_maml_tpu_torch.ops.fused_gcn import (
    _layer,
    _rounded_a_hat,
    aligned,
    check_gcn_inputs,
    gcn_stack_plain,
    pad_to,
)
from weatherforecast_stgcn_maml_tpu_torch.ops.gemm import (
    NN_ROW_TILE,
    gemm_nn,
    gemm_nn_plain,
    gemm_tn,
    gemm_tn_plain,
    row_tiles,
    sum_splits,
    sum_splits_plain,
    tile_colsums,
    tn_splits,
    workspace,
)


def gcn_stack_train_plain(
    layers: Sequence, a_hat: torch.Tensor, x: torch.Tensor,
    masks: torch.Tensor | None, keep: float, compute_dtype: torch.dtype,
) -> torch.Tensor:
    """Plain PyTorch version: the layerwise route with dropout masks, the
    output rounded to the compute dtype as the kernel stores it."""
    return gcn_stack_plain(layers, a_hat, x, compute_dtype, masks, keep).to(compute_dtype)


# Row 6 (JAX `_fwd_kernel`'s arithmetic and rounding points) is row 1's
# layer loop (ops/fused_gcn.py `_layer`) with dropout, per layer l:
#   hw = round(round(h) @ round(W_l)) over every slice and node (NN);
#   h = relu(round(A_hat) @ hw + b_l) per slice (NN, batched, float32
#     accumulation), times mask_l / keep for l < n_masks (the bias + relu +
#     mask epilogue), stored in the compute dtype as the backward's residual
#     and the next layer's input.
# round(A_hat) is made once a call (row 7 makes its transpose with the
# weights' in its one transpose-and-round launch, so nothing is shared).


def forward_schedule(x, a_hat, weights, biases, masks, inv_keep, compute_dtype,
                     product=gemm_nn):
    """Row 6 on `product` (`gemm_nn` on a card, `gemm_nn_plain` in the CPU
    tests): x [S, N, C] -> h_all, each layer's post-dropout activation [S,
    N, hid_l] in the compute dtype; two products a layer."""
    a = _rounded_a_hat(a_hat, compute_dtype)
    h_all, h = [], x
    for l, (w, b) in enumerate(zip(weights, biases)):
        mask = masks[l] if masks is not None and l < masks.shape[0] else None
        h = _layer(h, a, w, b, compute_dtype, compute_dtype, product, mask=mask,
                   scale=inv_keep)
        h_all.append(h)
    return h_all


def _forward(x, a_hat, weights, biases, masks, inv_keep, compute_dtype):
    """Row 6 on the card (`forward_schedule` on gemm_nn) -> h_all."""
    before = gemm_nn.launches
    h_all = forward_schedule(x, a_hat, weights, biases, masks, inv_keep, compute_dtype)
    gcn_stack_train.gemm_nn_launches += gemm_nn.launches - before
    return h_all


# Row 7 layer by layer (JAX `_bwd_kernel`'s arithmetic and rounding points).
# From dz_L = g * [h_all[L-1] > 0] * mask / keep (the top pass), per layer l:
#   dhw = round(round(A_hat)^T @ round(dz_l)) per slice (NN, batched);
#   dW_l = round(h_in)^T @ dhw over every slice and node (TN, split over K);
#   d_in = dhw @ round(W_l)^T: dx at l = 0, else, through the relu_grad
#     epilogue, dz_{l-1} = d_in * [h_all[l-1] > 0] * mask / keep in the
#     compute dtype;
# db_l = the column sums of the float32 dz_l, a partial a row tile written
# where dz_l is made. round(A_hat)^T and round(W_l)^T are made once a call,
# and one `sum_splits` a call adds every layer's dW partials, another every
# db partial, each in a fixed order. The pieces are swappable: the kernels on
# a card (`CARD_PIECES`), their plain versions (`PLAIN_PIECES`) in the CPU
# tests.


@dataclasses.dataclass(frozen=True)
class GcnPieces:
    """product: `gemm_nn`'s signature; product_tn: `gemm_tn`'s;
    top_dz(dh, h_post, mask, inv_keep, dz, part, addend=None): dz = (dh [+
    addend, float32]) * [h_post > 0] (* mask * inv_keep) into dz (compute
    dtype) and its row tiles' column sums into part; prep(mats,
    compute_dtype): each (src, dst, trans) of `mats` rounded into dst,
    transposed where trans (dst [cols, drows]: its columns past src's rows
    zero); sum_splits(part [S, 1, T], out [1, T]): out = the sum over S. Row
    13 (ops/fused_gcn_shard.py `backward_schedule`) runs on them too."""

    product: Callable
    product_tn: Callable
    top_dz: Callable
    prep: Callable
    sum_splits: Callable


def backward_schedule(g, x, a_hat, weights, masks, h_all, inv_keep, compute_dtype,
                      pieces: GcnPieces):
    """Row 7 on `pieces` at widths and a node count the pieces take (on a
    card: multiples of 8): g [S, N, hid_L], x [S, N, C], h_all [S, N, hid_l]
    in the compute dtype (the top one may be float32) -> dx [S, N, C], [dW_l
    [C_l, hid_l]], [db_l [hid_l]] in the accumulation dtype."""
    acc = accum_dtype(compute_dtype)
    dev = x.device
    slices, n, c0 = x.shape
    rows = slices * n
    n_layers = len(weights)
    cins = [w.shape[0] for w in weights]
    hids = [w.shape[1] for w in weights]
    hmax = max(hids)
    tiles, splits = row_tiles(rows), tn_splits(rows)
    dw_off = [0]
    for c, h in zip(cins, hids):
        dw_off.append(dw_off[-1] + c * h)
    xr = x.reshape(rows, c0)
    round_x = x.dtype is not compute_dtype and x.dtype is torch.float32
    # The call's scratch in one allocation, its outputs in another.
    at, *wts, dz_buf, dhw_buf, dw_part, db_part, xc = workspace(
        dev, ((n, n), compute_dtype), *[((h, c), compute_dtype) for c, h in zip(cins, hids)],
        ((rows * hmax,), compute_dtype), ((rows * hmax,), compute_dtype),
        ((splits, dw_off[-1]), acc), ((tiles, n_layers * hmax), acc),
        ((rows, c0) if round_x else (0,), compute_dtype))
    dx, dw_flat, db_all = workspace(dev, ((slices, n, c0), acc), ((dw_off[-1],), acc),
                                    ((n_layers, hmax), acc))
    pieces.prep([(a_hat, at, True), *[(w, wt, True) for w, wt in zip(weights, wts)],
                 *([(xr, xc, False)] if round_x else [])], compute_dtype)
    if not round_x:
        xc = xr.to(compute_dtype)
    if len(set(hids)) > 1:  # narrower layers leave columns of their partials unwritten
        db_part.zero_()

    def mask_of(l, width):
        return None if masks is None or l >= masks.shape[0] else masks[l].reshape(rows, width)

    def partials(l, width):
        return db_part[:, l * hmax:l * hmax + width]

    top, h = n_layers - 1, hids[-1]
    pieces.top_dz(g.reshape(rows, h), h_all[top].reshape(rows, h), mask_of(top, h), inv_keep,
                  dz_buf[:rows * h].view(rows, h), partials(top, h))
    for l in reversed(range(n_layers)):
        c, h = cins[l], hids[l]
        dhw = dhw_buf[:rows * h].view(rows, h)
        pieces.product(at, dz_buf[:rows * h].view(slices, n, h), compute_dtype=compute_dtype,
                       out=dhw.view(slices, n, h), what=f"GCN train layer {l} A^T dz")
        pieces.product_tn(xc if l == 0 else h_all[l - 1].reshape(rows, c), dhw,
                          dw_part[:, dw_off[l]:dw_off[l + 1]].view(splits, c, h),
                          compute_dtype=compute_dtype, what=f"GCN train layer {l} weight gradient")
        if l == 0:
            pieces.product(dhw, wts[0], compute_dtype=compute_dtype, out=dx.view(rows, c0),
                           what="GCN train input gradient")
            continue
        # dz_{l-1} over dz_l, which the A^T dz product above has read.
        pieces.product(dhw, wts[l], compute_dtype=compute_dtype, epilogue="relu_grad",
                       residual=h_all[l - 1].reshape(rows, c), mask=mask_of(l - 1, c),
                       scale=inv_keep, colsum=partials(l - 1, c),
                       out=dz_buf[:rows * c].view(rows, c),
                       what=f"GCN train layer {l} input gradient")
    pieces.sum_splits(dw_part.view(splits, 1, -1), dw_flat.view(1, -1))
    pieces.sum_splits(db_part.view(tiles, 1, -1), db_all.view(1, -1))
    return (dx, [dw_flat[dw_off[l]:dw_off[l + 1]].view(cins[l], hids[l]) for l in range(n_layers)],
            [db_all[l, :hids[l]] for l in range(n_layers)])


def _top_dz_card(dh, h_post, mask, inv_keep, dz, part, addend=None):
    code = cuda_build.dtype_code
    rows, cols = dz.shape
    cuda_build.check(
        cuda_build.load().wf_gcn_relu_mask_grad(
            code(dh.dtype), code(h_post.dtype), code(dz.dtype), dh.data_ptr(),
            None if addend is None else addend.data_ptr(), h_post.data_ptr(),
            None if mask is None else mask.data_ptr(), inv_keep, dz.data_ptr(), part.data_ptr(),
            part.stride(0), rows, cols, NN_ROW_TILE, cuda_build.stream_ptr(dz.device)),
        "GCN train top layer relu/dropout gradient",
    )


def _prep_card(mats, compute_dtype, chunk=8):
    """csrc/fused_gcn_train.cu's transpose-and-round pass, one launch for up
    to `chunk` float32 matrices; a transposed dst wider than its source's
    rows gets zero columns."""
    lib = cuda_build.load()
    for i in range(0, len(mats), chunk):
        part = mats[i:i + chunk]
        k = len(part)

        def ints(vals):
            return (ctypes.c_int * k)(*vals)

        cuda_build.check(
            lib.wf_transpose_round(
                cuda_build.dtype_code(compute_dtype), k,
                (ctypes.c_void_p * k)(*[src.data_ptr() for src, _, _ in part]),
                (ctypes.c_void_p * k)(*[dst.data_ptr() for _, dst, _ in part]),
                ints([src.shape[0] for src, _, _ in part]),
                ints([src.shape[1] for src, _, _ in part]),
                ints([src.stride(0) for src, _, _ in part]), ints([int(t) for _, _, t in part]),
                ints([dst.shape[1] if t else dst.shape[0] for _, dst, t in part]),
                cuda_build.stream_ptr(part[0][1].device)),
            "GCN train transpose and round",
        )


def _sum_splits_card(part, out):
    sum_splits(part, out, "GCN train gradient partials")


def _top_dz_plain(dh, h_post, mask, inv_keep, dz, part, addend=None):
    acc = part.dtype
    v = dh.to(acc) if addend is None else dh.to(acc) + addend.to(acc)
    v = v * (h_post.to(acc) > 0).to(acc)
    if mask is not None:
        v = v * (mask.to(acc) * inv_keep)
    dz.copy_(v)
    part.copy_(tile_colsums(v))


def _prep_plain(mats, compute_dtype):
    for src, dst, trans in mats:
        if not trans:
            dst.copy_(src)
            continue
        dst[:, :src.shape[0]].copy_(src.t())
        dst[:, src.shape[0]:].zero_()


CARD_PIECES = GcnPieces(gemm_nn, gemm_tn, _top_dz_card, _prep_card, _sum_splits_card)
PLAIN_PIECES = GcnPieces(gemm_nn_plain, gemm_tn_plain, _top_dz_plain, _prep_plain,
                         sum_splits_plain)


def _backward(g, x, a_hat, weights, masks, h_all, inv_keep, compute_dtype,
              pieces: GcnPieces = CARD_PIECES):
    """Row 7: -> dx (x's shape), [dW_l], [db_l] in the accumulation dtype, by
    `backward_schedule`. A node count or width that is not a multiple of 8
    is zero-padded to one first (zero rows and columns add nothing to any
    gradient); the reference width (512 nodes, 24 -> 4 x 256) takes no
    padding."""
    slices, n, c0 = x.shape
    widths = [c0] + [w.shape[1] for w in weights]
    n_p, wp = aligned(n), [aligned(c) for c in widths]
    if n_p == n and wp == widths:
        return backward_schedule(g, x, a_hat, weights, masks, h_all, inv_keep, compute_dtype,
                                 pieces)
    dx, dws, dbs = backward_schedule(
        pad_to(g, (slices, n_p, wp[-1])), pad_to(x, (slices, n_p, wp[0])),
        pad_to(a_hat, (n_p, n_p)), [pad_to(w, (wp[l], wp[l + 1])) for l, w in enumerate(weights)],
        None if masks is None else pad_to(masks, (masks.shape[0], slices, n_p, wp[1])),
        [pad_to(h, (slices, n_p, wp[l + 1])) for l, h in enumerate(h_all)], inv_keep,
        compute_dtype, pieces)
    return (dx[:, :n, :c0], [dw[:widths[l], :widths[l + 1]] for l, dw in enumerate(dws)],
            [db[:widths[l + 1]] for l, db in enumerate(dbs)])


class _GcnStackTrain(torch.autograd.Function):
    """Rows 6 and 7 as one differentiable op over (x, w_0, b_0, w_1, ...)."""

    @staticmethod
    def forward(ctx, x, a_hat, masks, keep, compute_dtype, *params):
        weights, biases = params[0::2], params[1::2]
        inv_keep = 1.0 / keep
        xc = x.contiguous()
        a = a_hat.contiguous()
        weights = [w.contiguous() for w in weights]
        biases = [b.contiguous() for b in biases]
        h_all = _forward(xc, a, weights, biases, masks, inv_keep, compute_dtype)
        ctx.compute_dtype, ctx.inv_keep = compute_dtype, inv_keep
        ctx.save_for_backward(xc, a, masks, *weights, *h_all)
        ctx.n_layers = len(weights)
        return h_all[-1]

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        x, a, masks = saved[:3]
        weights = saved[3:3 + ctx.n_layers]
        h_all = saved[3 + ctx.n_layers:]
        dx, dws, dbs = _backward(
            g.contiguous(), x, a, weights, masks, h_all, ctx.inv_keep,
            ctx.compute_dtype,
        )
        gcn_stack_train.backward_launches += 1
        grads = [d for pair in zip(dws, dbs) for d in pair]
        # Masks and a_hat take no gradient (JAX gives them zero cotangents).
        return (dx.to(x.dtype), None, None, None, None, *grads)


def gcn_stack_train(
    layers: Sequence, a_hat: torch.Tensor, x: torch.Tensor, *,
    masks: torch.Tensor | None = None, keep: float = 1.0,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Training forward of the encoder stack: x [W, N, C] -> [W, N, hid] in
    the compute dtype (float64 under float64), differentiable.

    Args:
      layers: the encoder's layers, each with `w` [C_in, C_out] and `b`
        [C_out] (models/stgcn.py).
      a_hat: [N, N] float32.
      masks: int8 {0, 1} [n_masks, W, N, hid] applied after layers
        0..n_masks-1 with scale 1/keep, or None.
    """
    if x.device.type == "cpu" or compute_dtype == torch.float64:
        return gcn_stack_train_plain(layers, a_hat, x, masks, keep, compute_dtype)
    if x.device.type != "cuda":
        raise TypeError(f"no GCN kernel for device {x.device}")
    weights = [layer.w for layer in layers]
    biases = [layer.b for layer in layers]
    if x.dim() != 3:
        raise ValueError(f"the GCN training kernel takes x [W, N, C], got {list(x.shape)}")
    check_gcn_inputs(weights, biases, a_hat, x, node_multiple=1)
    cuda_build.dtype_code(compute_dtype)
    cuda_build.dtype_code(x.dtype)
    if masks is not None:
        hid = weights[0].shape[1]
        if (
            masks.dtype != torch.int8 or masks.device != x.device
            or masks.shape[1:] != (x.shape[0], x.shape[1], hid)
            or masks.shape[0] > len(weights) or not masks.is_contiguous()
        ):
            raise ValueError(
                f"masks must be contiguous int8 [<= {len(weights)}, {x.shape[0]}, "
                f"{x.shape[1]}, {hid}] on the input's device"
            )
    params = [p for pair in zip(weights, biases) for p in pair]
    out = _GcnStackTrain.apply(x, a_hat, masks, keep, compute_dtype, *params)
    gcn_stack_train.launches += 1
    return out


gcn_stack_train.launches = 0  # forwards run through the CUDA kernels (row 6)
gcn_stack_train.gemm_nn_launches = 0  # their gemm_nn launches (two a layer)
gcn_stack_train.backward_launches = 0  # backwards run through them (row 7)
