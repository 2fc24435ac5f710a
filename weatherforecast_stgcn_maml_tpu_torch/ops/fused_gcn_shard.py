"""Node-sharded GCN "sandwich" layer (kernel rows 12-13) and the encoder
that chains it between node all-gathers.

On a node-sharded mesh each rank holds NL of the N padded nodes. One
encoder layer is: transform this rank's rows (hw = h @ W_l), all-gather
every rank's hw over the sp group (hw_full, the only communication), then
the sandwich op

    h_post = relu(A_rows @ hw_full + b_l) * mask / keep     [NL, W, hid]
    hw_next = h_post @ W_{l+1}                              [NL, W, hid_next]

which keeps everything between two gathers in one op. Its backward takes
the cotangents of h_post (g1, absent when only hw_next is used) and hw_next
(g2) and returns this rank's PARTIAL cotangent of hw_full over all N rows
(the gather's backward, a reduce-scatter, sums the partials of every rank),
dW_{l+1} and db_l. A_rows and the mask take no gradient.

`gcn_shard_layer` runs the CUDA kernels (the forward's two products on the
pipelined GEMM core, csrc/gemm_nn.cu, `forward_schedule`; the backward on
the same core and row 7's pieces, `backward_schedule`) behind one
`torch.autograd.Function` on a CUDA tensor in float32 or bfloat16, raises
on a CUDA tensor of another dtype, and runs the plain PyTorch version,
`shard_layer_plain` (autograd for the backward), on a CPU tensor or under
float64. The Function also runs on CPU tensors with `shard_bwd_plain`, the
plain statement of row 13's arithmetic, as its backward (the tests hold it
against the Pallas body).

Layout: activations are node-major, [rows, W, C] (node r's W time slices
side by side), not the JAX package's [W, rows, C]. all_gather_into_tensor
and reduce_scatter_tensor work along dim 0, so node-major rows gather into
hw_full [N, W, hid] and scatter back from d_hw_full [N, W, hid] with no
permute copy, every product is one GEMM over uniform strides, and the last
layer's output is already the LSTM's [nodes, W, hid] input. Masks are int8
{0, 1} [NL, W, hid] in the same layout, with 1/keep folded into the kernels.

Counterpart of `weatherforecast_stgcn_maml_tpu/ops/fused_gcn_shard.py`
(`gcn_shard_encoder`; `_shard_layer_op`, Pallas bodies `_fwd_kernel` and
`_bwd_kernel`; plain `_layer_reference`). The TPU op takes a row block only
where its VMEM budget allows (`shard_layer_supported`, nl % 8); the CUDA
kernels take any NL that divides N. First-order only, as in JAX.
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
from weatherforecast_stgcn_maml_tpu_torch.ops.fused_gcn import aligned
from weatherforecast_stgcn_maml_tpu_torch.ops.fused_gcn_train import CARD_PIECES, GcnPieces
from weatherforecast_stgcn_maml_tpu_torch.ops.gemm import gemm_nn, row_tiles, tn_splits, workspace
from weatherforecast_stgcn_maml_tpu_torch.parallel.mesh import all_gather_nodes


def shard_layer_plain(
    hw_full: torch.Tensor, a_rows: torch.Tensor, b: torch.Tensor,
    w_next: torch.Tensor | None, mask: torch.Tensor | None, keep: float,
    compute_dtype: torch.dtype,
):
    """Plain PyTorch version of the sandwich op (JAX `_layer_reference`),
    node-major: hw_full [N, W, hid], a_rows [NL, N] -> h_post [NL, W, hid]
    (and hw_next [NL, W, hid_next] with w_next), in the compute dtype."""
    n, w, hid = hw_full.shape
    nl = a_rows.shape[0]
    z = torch.matmul(
        as_operand(a_rows, compute_dtype),
        as_operand(hw_full, compute_dtype).reshape(n, w * hid),
    ).reshape(nl, w, hid) + b
    h = torch.relu(z)
    if mask is not None:
        h = apply_mask(h, mask, keep)
    h_post = h.to(compute_dtype)
    if w_next is None:
        return h_post
    hw_next = torch.matmul(
        as_operand(h_post, compute_dtype), as_operand(w_next, compute_dtype)
    ).to(compute_dtype)
    return h_post, hw_next


def shard_bwd_plain(g1, g2, h_post, a_rows, w_next, mask, keep, compute_dtype, hw_dtype):
    """Plain statement of row 13 (JAX `_bwd_kernel`): -> (d_hw_full
    [N, W, hid] in hw_dtype, db [hid], dW_next [hid, hid_next] or None), in
    the accumulation dtype. g1 or g2 may be None (a zero cotangent)."""
    acc = accum_dtype(compute_dtype)
    nl, w, hid = h_post.shape
    n = a_rows.shape[1]
    dev = h_post.device
    dh = torch.zeros((nl, w, hid), dtype=acc, device=dev) if g1 is None else g1.to(acc)
    dw_next = None
    if w_next is not None:
        if g2 is None:
            g2 = torch.zeros((nl, w, w_next.shape[1]), dtype=acc, device=dev)
        g2o = as_operand(g2, compute_dtype)
        dh = dh + torch.matmul(g2o, as_operand(w_next, compute_dtype).T)
        dw_next = as_operand(h_post, compute_dtype).reshape(nl * w, hid).T @ g2o.reshape(
            nl * w, -1)
    dz = dh * (h_post.to(acc) > 0).to(acc)
    if mask is not None:
        dz = apply_mask(dz, mask, keep)
    db = dz.sum(dim=(0, 1))
    d_hw_full = torch.matmul(
        as_operand(a_rows, compute_dtype).T,
        as_operand(dz, compute_dtype).reshape(nl, w * hid),
    ).reshape(n, w, hid).to(hw_dtype)
    return d_hw_full, db, dw_next


def forward_schedule(hw_full, a_rows, b, w_next, mask, inv_keep, dt, product):
    """Row 12's forward on `product` (`gemm_nn` on a card, `gemm_nn_plain` in
    the CPU tests) -> (h_post [NL, W, hid], hw_next [NL, W, hid_next] or None)
    in the compute dtype: the aggregation as one batched product over the
    time slices of the node-major layout (slice s: A_rows @ hw_full[:, s],
    its rows W * hid apart, the slices hid apart) with the bias + relu (+
    mask) epilogue, then hw_next = round(h_post) @ round(W_next)."""
    n, w, hid = hw_full.shape
    nl = a_rows.shape[0]
    h_post = torch.empty((nl, w, hid), dtype=dt, device=hw_full.device)
    product(a_rows, hw_full.transpose(0, 1), compute_dtype=dt,
            epilogue="bias_relu" if mask is None else "bias_relu_mask", bias=b,
            mask=None if mask is None else mask.transpose(0, 1), scale=inv_keep,
            out=h_post.transpose(0, 1), what="GCN sandwich contraction")
    if w_next is None:
        return h_post, None
    hw_next = product(h_post.view(nl * w, hid), w_next, compute_dtype=dt, out_dtype=dt,
                      what="GCN sandwich next transform")
    return h_post, hw_next.view(nl, w, -1)


# Row 13 (JAX `_bwd_kernel`'s arithmetic and rounding points) on row 7's
# pieces (ops/fused_gcn_train.py `GcnPieces`), node-major rows NL x W:
#   dh = g1 + round(g2) @ round(W_next)^T;
#   dz = dh * [h_post > 0] * mask / keep, stored in the compute dtype, with
#     the float32 column sums of each row tile (db's partials): with g2 alone
#     (layers 0..L-2 of the encoder) the product's relu_grad epilogue; with
#     g1 alone (the top layer) the top_dz pass; with both (no path of the
#     encoder, but the op takes it) the product unfused into float32, then
#     top_dz adding it to g1;
#   dW_next = round(h_post)^T round(g2) over the NL x W rows (TN, split K);
#   d_hw_full = round(A_rows)^T [N, NL] @ round(dz) [NL, W * hid] (NN): this
#     rank's partial over all N rows.
# round(A_rows)^T and round(W_next)^T come from one prep launch; NL, the A^T
# product's K, is zero-padded to a multiple of 8 there (A_rows^T's columns)
# and in dz's rows. Two `sum_splits` add the dW_next and db partials.


def backward_schedule(g1, g2, h_post, a_rows, w_next, mask, inv_keep, compute_dtype, hw_dtype,
                      pieces: GcnPieces):
    """Row 13 on `pieces` -> (d_hw_full [N, W, hid] in hw_dtype, db [hid],
    dW_next [hid, hid_next] or None) in the accumulation dtype. g1 [NL, W,
    hid], g2 [NL, W, hid_next] (either may be None, not both), h_post [NL,
    W, hid] in the compute dtype, mask int8 [NL, W, hid] or None."""
    acc = accum_dtype(compute_dtype)
    dev = h_post.device
    nl, w, hid = h_post.shape
    n = a_rows.shape[1]
    rows, nlp = nl * w, aligned(nl)
    hid_next = 0 if w_next is None else w_next.shape[1]
    g2 = None if w_next is None else g2
    tiles, splits = row_tiles(rows), 0 if g2 is None else tn_splits(rows)
    at, wnt, dz, db_part, dw_part = workspace(
        dev, ((n, nlp), compute_dtype), ((hid_next, hid), compute_dtype),
        ((nlp * w * hid,), compute_dtype), ((tiles, hid), acc), ((splits, hid, hid_next), acc))
    db, dw_next = workspace(dev, ((hid,), acc), ((hid, hid_next), acc))
    pieces.prep([(a_rows, at, True)] + ([] if g2 is None else [(w_next, wnt, True)]),
                compute_dtype)
    if nlp > nl:  # zero rows of dz meet A_rows^T's zero columns
        dz[rows * hid:].zero_()
    dz_rows, h2 = dz[:rows * hid].view(rows, hid), h_post.view(rows, hid)
    mask2 = None if mask is None else mask.view(rows, hid)
    if g2 is None:
        pieces.top_dz(g1.reshape(rows, hid), h2, mask2, inv_keep, dz_rows, db_part)
        dw_next.zero_()
    else:
        g2r = g2.reshape(rows, hid_next).to(compute_dtype)
        if g1 is None:
            pieces.product(g2r, wnt, compute_dtype=compute_dtype, epilogue="relu_grad",
                           residual=h2, mask=mask2, scale=inv_keep, colsum=db_part, out=dz_rows,
                           what="GCN sandwich g2 @ W_next^T")
        else:
            t = pieces.product(g2r, wnt, compute_dtype=compute_dtype,
                               what="GCN sandwich g2 @ W_next^T")
            pieces.top_dz(g1.reshape(rows, hid), h2, mask2, inv_keep, dz_rows, db_part, addend=t)
        pieces.product_tn(h2, g2r, dw_part, compute_dtype=compute_dtype,
                          what="GCN sandwich W_next gradient")
        pieces.sum_splits(dw_part.view(splits, 1, -1), dw_next.view(1, -1))
    pieces.sum_splits(db_part.view(tiles, 1, hid), db.view(1, hid))
    # This rank's partial of the gathered activations' cotangent, all N rows:
    # d_hw_full[:, s] = A_rows^T @ dz[:, s] for every slice in one product.
    out_dt = hw_dtype if hw_dtype in (torch.float32, compute_dtype) else acc
    d_hw = pieces.product(at, dz.view(nlp, w * hid), compute_dtype=compute_dtype,
                          out_dtype=out_dt, what="GCN sandwich A_rows^T dz")
    return (d_hw.view(n, w, hid).to(hw_dtype), db,
            None if w_next is None else dw_next)


class _ShardLayer(torch.autograd.Function):
    """Rows 12 and 13 as one differentiable op over (hw_full, b, w_next)."""

    @staticmethod
    def forward(ctx, hw_full, a_rows, b, w_next, mask, keep, compute_dtype):
        if hw_full.device.type == "cuda":
            h_post, hw_next = forward_schedule(hw_full, a_rows, b, w_next, mask, 1.0 / keep,
                                               compute_dtype, gemm_nn)
        else:
            out = shard_layer_plain(hw_full, a_rows, b, w_next, mask, keep, compute_dtype)
            h_post, hw_next = out if w_next is not None else (out, None)
        # The cotangent of an unused output (h_post between layers) stays None.
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(h_post, a_rows, w_next, mask)
        ctx.keep, ctx.compute_dtype = keep, compute_dtype
        ctx.hw_dtype, ctx.b_dtype = hw_full.dtype, b.dtype
        return (h_post, hw_next) if w_next is not None else h_post

    @staticmethod
    def backward(ctx, g1, g2=None):
        h_post, a_rows, w_next, mask = ctx.saved_tensors
        if g1 is None and g2 is None:
            return (None,) * 7
        if h_post.device.type == "cuda":
            d_hw, db, dw_next = backward_schedule(
                g1 if g1 is None else g1.contiguous(), g2 if g2 is None else g2.contiguous(),
                h_post, a_rows, w_next, mask, 1.0 / ctx.keep, ctx.compute_dtype, ctx.hw_dtype,
                CARD_PIECES)
            gcn_shard_layer.backward_launches += 1
        else:
            d_hw, db, dw_next = shard_bwd_plain(g1, g2, h_post, a_rows, w_next, mask,
                                                ctx.keep, ctx.compute_dtype, ctx.hw_dtype)
        # A_rows is a constant of the graph and the mask is data: no gradient.
        return (d_hw, None, db.to(ctx.b_dtype),
                None if dw_next is None else dw_next.to(w_next.dtype), None, None, None)


def _check_cuda_inputs(hw_full, a_rows, b, w_next, mask, compute_dtype) -> None:
    cuda_build.dtype_code(compute_dtype)
    cuda_build.dtype_code(hw_full.dtype)
    dev = hw_full.device
    if hw_full.dim() != 3 or not hw_full.is_contiguous():
        raise ValueError(f"hw_full must be a contiguous [N, W, hid], got {list(hw_full.shape)}")
    n, w, hid = hw_full.shape
    if a_rows.dim() != 2 or a_rows.shape[1] != n or n % a_rows.shape[0]:
        raise ValueError(
            f"a_rows must be [NL, {n}] with NL dividing {n}, got {list(a_rows.shape)}"
        )
    if b.shape != (hid,):
        raise ValueError(f"b must be [{hid}], got {list(b.shape)}")
    if w_next is not None and (w_next.dim() != 2 or w_next.shape[0] != hid):
        raise ValueError(f"w_next must be [{hid}, hid_next], got {list(w_next.shape)}")
    for t in (a_rows, b) + (() if w_next is None else (w_next,)):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError("a_rows, b and w_next must be contiguous float32 on hw_full's device")
    if mask is not None and (
        mask.dtype != torch.int8 or mask.device != dev
        or mask.shape != (a_rows.shape[0], w, hid) or not mask.is_contiguous()
    ):
        raise ValueError(
            f"mask must be a contiguous int8 [{a_rows.shape[0]}, {w}, {hid}] on hw_full's device"
        )


def gcn_shard_layer(
    hw_full: torch.Tensor, a_rows: torch.Tensor, b: torch.Tensor,
    w_next: torch.Tensor | None = None, mask: torch.Tensor | None = None,
    keep: float = 1.0, compute_dtype: torch.dtype = torch.float32,
):
    """One sandwich layer, differentiable w.r.t. hw_full, b and w_next.

    Args:
      hw_full: [N, W, hid] node-major, every rank's transformed rows (the
        all-gather's output), float32 or bfloat16 on a card.
      a_rows: [NL, N] float32, this rank's rows of the adjacency.
      b: [hid] float32; w_next: [hid, hid_next] float32 or None (last layer).
      mask: int8 {0, 1} [NL, W, hid] or None; applied with scale 1/keep.
    Returns h_post [NL, W, hid], and hw_next [NL, W, hid_next] with w_next.
    """
    if hw_full.device.type == "cpu" or compute_dtype == torch.float64:
        return shard_layer_plain(hw_full, a_rows, b, w_next, mask, keep, compute_dtype)
    if hw_full.device.type != "cuda":
        raise TypeError(f"no GCN sandwich kernel for device {hw_full.device}")
    _check_cuda_inputs(hw_full, a_rows, b, w_next, mask, compute_dtype)
    out = _ShardLayer.apply(hw_full, a_rows, b, w_next, mask, keep, compute_dtype)
    gcn_shard_layer.launches += 1
    return out


gcn_shard_layer.launches = 0  # forwards run through the CUDA kernels (row 12)
gcn_shard_layer.backward_launches = 0  # backwards run through them (row 13)


def gcn_shard_encoder(
    layers: Sequence, a_rows: torch.Tensor, x_local: torch.Tensor, group, *,
    masks: torch.Tensor | None = None, keep: float = 1.0,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Node-sharded encoder on the sandwich route: x_local [NL, W, C_in]
    node-major -> [NL, W, hid] in the compute dtype.

    The layer-0 transform is a plain torch.matmul (as in JAX); then per
    layer the all-gather over `group` and the sandwich op. `masks` (int8
    [n, NL, W, hid], or None) drop the outputs of layers 0..n-1 below the
    last (this rank's rows only, drawn by the caller).
    """
    n_layers = len(layers)
    hw = torch.matmul(
        as_operand(x_local, compute_dtype), as_operand(layers[0].w, compute_dtype)
    ).to(compute_dtype)
    h = None
    for l in range(n_layers):
        hw_full = all_gather_nodes(hw, group)
        has_next = l < n_layers - 1
        mask = masks[l] if masks is not None and has_next and l < masks.shape[0] else None
        out = gcn_shard_layer(
            hw_full, a_rows, layers[l].b, layers[l + 1].w if has_next else None, mask,
            keep, compute_dtype,
        )
        if has_next:
            h, hw = out
        else:
            h = out
    return h
