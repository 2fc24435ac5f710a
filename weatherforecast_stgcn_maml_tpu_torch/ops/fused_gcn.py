"""Fused GCN encoder stack (serving): all L layers of
`h = relu(A_hat @ (h @ W_l) + b_l)` over every time slice.

`fused_gcn_stack` (kernel row 1) runs, on a CUDA tensor, two launches a
layer of the pipelined GEMM core (csrc/gemm_nn.cu; `gcn_stack_schedule`):
hw = round(h) @ round(W) stored in the compute dtype, then relu(round(A_hat)
@ hw + b), stored in the compute dtype below the last layer and in float32
after it; on a CPU tensor or under float64 its plain PyTorch version,
`gcn_stack_plain`. On a CUDA tensor a shape or dtype the kernel does not
take raises; nothing falls back to the plain version there.

`fused_gcn_layer` is one layer, relu(A_hat @ (h @ W) + b), with a
hand-written backward: on a CUDA tensor its forward (kernel row 3) is two
launches of the pipelined GEMM core (csrc/gemm_nn.cu: hw = round(h) @
round(W) stored in the compute dtype, then the aggregation with the bias +
relu epilogue) and its backward (the relu gate, A_hat^T g, dW, dh, db) runs
the kernels of the training stack's backward (ops/fused_gcn_train.py)
behind a `torch.autograd.Function`; on a CPU tensor or under float64 it is
the plain layer, differentiated by autograd.

Counterpart of `weatherforecast_stgcn_maml_tpu/ops/fused_gcn.py`
(`fused_gcn_stack`, whose Pallas body is `_stack_kernel`, and
`fused_gcn_layer`, Pallas body `_kernel`, custom VJP `_fused_bwd`). The TPU
kernel only runs where its VMEM budget allows; the CUDA kernel has no such
gate.
"""

from __future__ import annotations

from typing import Sequence

import torch

from weatherforecast_stgcn_maml_tpu_torch.models.common import apply_mask
from weatherforecast_stgcn_maml_tpu_torch.models.gcn import apply_gcn_layer
from weatherforecast_stgcn_maml_tpu_torch.ops import cuda_build
from weatherforecast_stgcn_maml_tpu_torch.ops.gemm import NN_MULTIPLE, gemm_nn

NODE_MULTIPLE = 128  # the kernel takes node counts that are multiples of this


def gcn_stack_plain(
    layers: Sequence, a_hat: torch.Tensor, h: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
    masks: torch.Tensor | None = None, keep: float = 1.0,
) -> torch.Tensor:
    """Plain PyTorch version: the layerwise route, relu after every layer;
    `masks` (int8 {0, 1} [n, ..., N, C_out]) drop the outputs of layers
    0..n-1 with scale 1/keep."""
    for l, layer in enumerate(layers):
        h = torch.relu(apply_gcn_layer(layer, a_hat, h, compute_dtype=compute_dtype))
        if masks is not None and l < masks.shape[0]:
            h = apply_mask(h, masks[l], keep)
    return h


def check_gcn_inputs(weights, biases, a_hat, h, node_multiple=NODE_MULTIPLE) -> None:
    """Raise on what the GCN kernels do not take."""
    dev = h.device
    n, c_in = h.shape[-2:]
    if n % node_multiple:
        raise ValueError(
            f"the GCN kernel takes node counts that are multiples of "
            f"{node_multiple}, got {n}"
        )
    if a_hat.shape != (n, n):
        raise ValueError(f"a_hat must be [{n}, {n}], got {list(a_hat.shape)}")
    for t in (a_hat, *weights, *biases):
        if t.device != dev or t.dtype != torch.float32:
            raise TypeError("a_hat, weights and biases must be float32 on the input's device")
    for l, w in enumerate(weights):
        if w.shape[0] != c_in:
            raise ValueError(f"layer {l}: weight is {list(w.shape)}, input has {c_in} channels")
        c_in = w.shape[1]


def fused_gcn_stack(
    layers, a_hat: torch.Tensor, h: torch.Tensor, *,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Run a whole GCN layer stack.

    Args:
      layers: the encoder's layers, each with `w` [C_in, C_out] and `b`
        [C_out] (models/stgcn.py).
      a_hat: [N, N] float32; h: [..., N, C_in].
    Returns [..., N, C_out_last] float32 (float64 under float64).
    """
    weights = [layer.w for layer in layers]
    biases = [layer.b for layer in layers]
    cuda_build.no_grad_inputs(h, a_hat, *weights, *biases)
    if h.device.type == "cpu" or compute_dtype == torch.float64:
        return gcn_stack_plain(layers, a_hat, h, compute_dtype)
    if h.device.type != "cuda":
        raise TypeError(f"no GCN kernel for device {h.device}")
    check_gcn_inputs(weights, biases, a_hat, h)
    n, c_in = h.shape[-2:]
    before = gemm_nn.launches
    out = gcn_stack_schedule(weights, biases, a_hat.contiguous(),
                             h.reshape(-1, n, c_in).contiguous(), compute_dtype)
    fused_gcn_stack.launches += 1
    fused_gcn_stack.gemm_nn_launches += gemm_nn.launches - before
    return out.reshape(*h.shape[:-1], out.shape[-1])


fused_gcn_stack.launches = 0  # stacks run through the CUDA kernels (row 1)
fused_gcn_stack.gemm_nn_launches = 0  # their gemm_nn launches (two a layer)


def pad_to(t: torch.Tensor, sizes) -> torch.Tensor:
    """t zero-padded at the end of each dimension to `sizes` (t itself when
    it has them)."""
    if tuple(t.shape) == tuple(sizes):
        return t
    out = t.new_zeros(sizes)
    out[tuple(slice(0, d) for d in t.shape)] = t
    return out


def aligned(n: int) -> int:
    """n rounded up to a multiple of NN_MULTIPLE."""
    return -(-n // NN_MULTIPLE) * NN_MULTIPLE


def _layer(hb, a, w, b, compute_dtype, out_dtype, product, mask=None, scale=1.0):
    """One layer on two products: hb [S, N, C_in] float32 or in the compute
    dtype, a = round(A_hat) [N, N_p] (N_p: N up to a multiple of 8) -> relu(a
    @ (round(h) @ round(W)) + b) [S, N, C_out] in out_dtype (None: the
    product's default), hw stored in the compute dtype; with an int8 `mask`
    [S, N, C_out], times mask * scale (the training stack's dropout). Widths
    and node counts that are not multiples of 8 are zero-padded to them
    (zero rows and columns add nothing); the reference width (512 nodes, 24
    or 256 -> 256) takes no padding."""
    slices, n, c_in = hb.shape
    n_p, c_out = a.shape[1], w.shape[1]
    ci_p, co_p = aligned(c_in), aligned(c_out)
    hb = pad_to(hb, (slices, n, ci_p))
    # hw rows n .. n_p - 1 of each slice stay zero: the aggregation's K tail.
    hw = (torch.empty if n_p == n else torch.zeros)(
        (slices, n_p, co_p), dtype=compute_dtype, device=hb.device)
    product(hb, pad_to(w, (ci_p, co_p)), out=hw[:, :n], compute_dtype=compute_dtype,
            what="GCN layer feature transform")
    masked = {} if mask is None else dict(mask=pad_to(mask, (slices, n, co_p)), scale=scale)
    out = product(a, hw, epilogue="bias_relu_mask" if masked else "bias_relu",
                  bias=pad_to(b, (co_p,)), compute_dtype=compute_dtype, out_dtype=out_dtype,
                  what="GCN layer aggregation", **masked)
    return out if co_p == c_out else out[..., :c_out].contiguous()


def _rounded_a_hat(a_hat, compute_dtype):
    """A_hat rounded once (0.5 MB at 512 nodes) rather than by every block
    as it loads (the bfloat16 path then copies it by cp.async), its columns
    padded to a multiple of 8."""
    n = a_hat.shape[0]
    return pad_to(a_hat, (n, aligned(n))).to(compute_dtype)


def gcn_stack_schedule(weights, biases, a_hat, hb, compute_dtype, product=gemm_nn):
    """Row 1's layer loop on `product` (`gemm_nn` on a card, `gemm_nn_plain`
    in the CPU tests): hb [S, N, C_in] -> [S, N, C_out_last] float32, two
    products a layer, A_hat rounded once a call; each layer's output in the
    compute dtype below the last (JAX `_stack_kernel`'s rounding), the
    last one's in `product`'s default (float32; float64 under float64)."""
    a = _rounded_a_hat(a_hat, compute_dtype)
    for l, (w, b) in enumerate(zip(weights, biases)):
        last = l == len(weights) - 1
        hb = _layer(hb, a, w.contiguous(), b.contiguous(), compute_dtype,
                    None if last else compute_dtype, product)
    return hb


def gcn_layer_forward(hb, a_hat, w, b, compute_dtype):
    """Row 3's forward on a CUDA tensor: hb [S, N, C_in], a_hat [N, N], w
    [C_in, C_out], b [C_out] -> relu(A_hat @ (h @ W) + b) [S, N, C_out]
    float32, two gemm_nn launches (`_layer`)."""
    check_gcn_inputs([w], [b], a_hat, hb, node_multiple=1)
    return _layer(hb, _rounded_a_hat(a_hat, compute_dtype), w, b, compute_dtype, None,
                  gemm_nn)


class _FusedGcnLayer(torch.autograd.Function):
    """Row 3 over (h, w, b): the forward is two gemm_nn launches; the
    backward is JAX's custom VJP. A_hat takes no gradient."""

    @staticmethod
    def forward(ctx, h, a_hat, compute_dtype, w, b):
        hb = h.reshape(-1, *h.shape[-2:]).contiguous()
        a, w = a_hat.contiguous(), w.contiguous()
        out = gcn_layer_forward(hb, a, w, b.contiguous(), compute_dtype)
        ctx.compute_dtype = compute_dtype
        ctx.save_for_backward(hb, a, w, out)
        fused_gcn_layer.launches += 1
        return out.reshape(*h.shape[:-1], w.shape[1])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        from weatherforecast_stgcn_maml_tpu_torch.ops.fused_gcn_train import _backward

        hb, a, w, out = ctx.saved_tensors
        # The relu gate on g, db = sum g, A_hat^T g rounded to the compute
        # dtype, dW = h^T (A_hat^T g), dh = (A_hat^T g) W^T (no mask).
        dh, (dw,), (db,) = _backward(
            g.reshape(out.shape).contiguous(), hb, a, [w], None, [out], 1.0,
            ctx.compute_dtype,
        )
        fused_gcn_layer.backward_launches += 1
        return dh.to(hb.dtype).reshape(g.shape[:-1] + (hb.shape[-1],)), None, None, dw, db


def fused_gcn_layer(
    layer, a_hat: torch.Tensor, h: torch.Tensor, *,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """One GCN layer, relu(A_hat @ (h @ W) + b), differentiable (first order
    on a card).

    Args:
      layer: `w` [C_in, C_out], `b` [C_out] (models/common.Dense).
      a_hat: [N, N] float32; h: [..., N, C_in].
    Returns [..., N, C_out] float32 (float64 under float64).
    """
    if h.device.type == "cpu" or compute_dtype == torch.float64:
        return torch.relu(apply_gcn_layer(layer, a_hat, h, compute_dtype=compute_dtype))
    if h.device.type != "cuda":
        raise TypeError(f"no GCN kernel for device {h.device}")
    cuda_build.dtype_code(compute_dtype)
    cuda_build.dtype_code(h.dtype)
    return _FusedGcnLayer.apply(h, a_hat, compute_dtype, layer.w, layer.b)


fused_gcn_layer.launches = 0  # forwards run through the CUDA kernel (row 3)
fused_gcn_layer.backward_launches = 0  # backwards run through the kernels
