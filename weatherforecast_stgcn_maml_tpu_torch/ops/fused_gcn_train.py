"""Fused GCN encoder stack, training: every layer's
`h = relu(A_hat @ (h @ W_l) + b_l) * mask_l / keep` over all time slices,
with a hand-written backward.

`gcn_stack_train` runs the CUDA kernels (csrc/gemm.cu for the products,
csrc/fused_gcn_train.cu for the relu / dropout gradient) behind one
`torch.autograd.Function` on a CUDA tensor, and its plain PyTorch version,
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

from typing import Sequence

import torch

from weatherforecast_stgcn_maml_tpu_torch.ops import cuda_build
from weatherforecast_stgcn_maml_tpu_torch.ops.fused_gcn import (
    check_gcn_inputs,
    gcn_stack_plain,
)
from weatherforecast_stgcn_maml_tpu_torch.ops.gemm import colsum, gemm, matmul_tn


def gcn_stack_train_plain(
    layers: Sequence, a_hat: torch.Tensor, x: torch.Tensor,
    masks: torch.Tensor | None, keep: float, compute_dtype: torch.dtype,
) -> torch.Tensor:
    """Plain PyTorch version: the layerwise route with dropout masks, the
    output rounded to the compute dtype as the kernel stores it."""
    return gcn_stack_plain(layers, a_hat, x, compute_dtype, masks, keep).to(compute_dtype)


def _forward(x, a_hat, weights, biases, masks, inv_keep, compute_dtype):
    """-> h_all: each layer's post-dropout activation [W, N, hid] in the
    compute dtype."""
    slices, n, c_in = x.shape
    h_all = []
    cur = x
    for l, (w, b) in enumerate(zip(weights, biases)):
        hid = w.shape[1]
        hw = torch.empty((slices * n, hid), dtype=compute_dtype, device=x.device)
        gemm(
            cur, w, hw, m=slices * n, n=hid, k=c_in, lda=c_in, ldb=hid, ldc=hid,
            compute_dtype=compute_dtype, what=f"GCN train layer {l} feature transform",
        )
        out = torch.empty((slices, n, hid), dtype=compute_dtype, device=x.device)
        mask = masks[l] if masks is not None and l < masks.shape[0] else None
        gemm(
            a_hat, hw, out, m=n, n=hid, k=n, lda=n, ldb=hid, ldc=hid,
            sb=n * hid, sc=n * hid, batch=slices, bias=b, relu=True,
            cmask=mask, cscale=inv_keep, compute_dtype=compute_dtype,
            what=f"GCN train layer {l} aggregation",
        )
        h_all.append(out)
        cur, c_in = out, hid
    return h_all


def _backward(g, x, a_hat, weights, masks, h_all, inv_keep, compute_dtype):
    """-> dx (float32, x's shape), [dW_l], [db_l] (float32)."""
    lib = cuda_build.load()
    slices, n, _ = x.shape
    dev = x.device
    stream = cuda_build.stream_ptr(dev)
    rows = slices * n
    dws, dbs = [None] * len(weights), [None] * len(weights)
    dh = g.reshape(rows, -1)
    for l in range(len(weights) - 1, -1, -1):
        w = weights[l]
        c_l, hid = w.shape
        mask = masks[l] if masks is not None and l < masks.shape[0] else None
        dz = torch.empty((rows, hid), dtype=torch.float32, device=dev)
        cuda_build.check(
            lib.wf_gcn_relu_mask_grad(
                cuda_build.dtype_code(dh.dtype), cuda_build.dtype_code(h_all[l].dtype),
                dh.data_ptr(), h_all[l].data_ptr(),
                None if mask is None else mask.data_ptr(), inv_keep,
                dz.data_ptr(), rows * hid, stream,
            ),
            f"GCN train layer {l} relu/dropout gradient",
        )
        dbs[l] = torch.empty((hid,), dtype=torch.float32, device=dev)
        colsum(dz, dbs[l], f"GCN train layer {l} bias gradient")
        # dhw = A_hat^T @ dz per slice (no symmetry assumed).
        dhw = torch.empty((rows, hid), dtype=compute_dtype, device=dev)
        gemm(
            a_hat, dz, dhw, m=n, n=hid, k=n, lda=n, ldb=hid, ldc=hid,
            trans_a=True, sb=n * hid, sc=n * hid, batch=slices,
            compute_dtype=compute_dtype, what=f"GCN train layer {l} A^T dz",
        )
        inp = (x if l == 0 else h_all[l - 1]).view(rows, c_l)
        dws[l] = torch.empty((c_l, hid), dtype=torch.float32, device=dev)
        matmul_tn(
            inp, dhw, dws[l], compute_dtype=compute_dtype,
            what=f"GCN train layer {l} weight gradient",
        )
        d_in = torch.empty((rows, c_l), dtype=torch.float32, device=dev)
        gemm(
            dhw, w, d_in, m=rows, n=c_l, k=hid, lda=hid, ldb=hid, ldc=c_l,
            trans_b=True, compute_dtype=compute_dtype,
            what=f"GCN train layer {l} input gradient",
        )
        dh = d_in
    return dh.reshape(x.shape), dws, dbs


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
gcn_stack_train.backward_launches = 0  # backwards run through them (row 7)
