"""Fused GCN encoder stack (serving): all L layers of
`h = relu(A_hat @ (h @ W_l) + b_l)` over every time slice.

`fused_gcn_stack` runs the hand-written CUDA kernel (csrc/fused_gcn.cu) on
a CUDA tensor and its plain PyTorch version, `gcn_stack_plain`, on a CPU
tensor or under float64. On a CUDA tensor a shape or dtype the kernel does
not take raises; nothing falls back to the plain version there.

Counterpart of `weatherforecast_stgcn_maml_tpu/ops/fused_gcn.py`
(`fused_gcn_stack`, whose Pallas body is `_stack_kernel`). The TPU kernel
only runs where its VMEM budget allows; the CUDA kernel has no such gate.
"""

from __future__ import annotations

from typing import Sequence

import torch

from weatherforecast_stgcn_maml_tpu_torch.models.gcn import apply_gcn_layer
from weatherforecast_stgcn_maml_tpu_torch.ops import cuda_build

NODE_MULTIPLE = 128  # the kernel takes node counts that are multiples of this


def gcn_stack_plain(
    layers: Sequence, a_hat: torch.Tensor, h: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version: the layerwise route, relu after every layer."""
    for layer in layers:
        h = torch.relu(apply_gcn_layer(layer, a_hat, h, compute_dtype=compute_dtype))
    return h


def _gcn_stack_cuda(weights, biases, a_hat, h, compute_dtype):
    lib = cuda_build.load()
    dev = h.device
    n, c_in = h.shape[-2:]
    if n % NODE_MULTIPLE:
        raise ValueError(
            f"the GCN kernel takes node counts that are multiples of "
            f"{NODE_MULTIPLE}, got {n}"
        )
    if a_hat.shape != (n, n):
        raise ValueError(f"a_hat must be [{n}, {n}], got {list(a_hat.shape)}")
    for t in (a_hat, *weights, *biases):
        if t.device != dev or t.dtype != torch.float32:
            raise TypeError("a_hat, weights and biases must be float32 on the input's device")
    rd = cuda_build.dtype_code(compute_dtype)
    cur = h.reshape(-1, n, c_in).contiguous()
    slices = cur.shape[0]
    a = a_hat.contiguous()
    stream = cuda_build.stream_ptr(dev)
    for l, (w, b) in enumerate(zip(weights, biases)):
        if w.shape[0] != c_in:
            raise ValueError(f"layer {l}: weight is {list(w.shape)}, input has {c_in} channels")
        w, b = w.contiguous(), b.contiguous()
        c_out = w.shape[1]
        hw = torch.empty((slices * n, c_out), dtype=compute_dtype, device=dev)
        cuda_build.check(
            lib.wf_gcn_gemm(
                cuda_build.dtype_code(cur.dtype), 0, rd, rd, 0,
                cur.data_ptr(), 0, c_in,
                w.data_ptr(), 0, c_out,
                hw.data_ptr(), 0, c_out,
                None, slices * n, c_out, c_in, 1, stream,
            ),
            f"GCN layer {l} feature transform",
        )
        last = l == len(weights) - 1
        out = torch.empty(
            (slices, n, c_out),
            dtype=torch.float32 if last else compute_dtype,
            device=dev,
        )
        cuda_build.check(
            lib.wf_gcn_gemm(
                0, rd, cuda_build.dtype_code(out.dtype), rd, 1,
                a.data_ptr(), 0, n,
                hw.data_ptr(), n * c_out, c_out,
                out.data_ptr(), n * c_out, c_out,
                b.data_ptr(), n, c_out, n, slices, stream,
            ),
            f"GCN layer {l} aggregation",
        )
        cur, c_in = out, c_out
    return cur.reshape(*h.shape[:-1], c_in)


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
    out = _gcn_stack_cuda(weights, biases, a_hat, h, compute_dtype)
    fused_gcn_stack.launches += 1
    return out


fused_gcn_stack.launches = 0  # stack runs through the CUDA kernel
