"""Whole-tree clip + SGD update: `p <- p - lr * clip(g)` over every leaf of a
parameter tree, in place, with torch's clip_grad_norm_ semantics (the
global norm over all leaves; scale by max_norm / (norm + 1e-6) only when
norm > max_norm).

`clip_sgd_update` runs the hand-written CUDA kernel (csrc/fused_sgd.cu) on
CUDA float32 tensors and its plain PyTorch version,
`clip_sgd_update_plain`, on CPU tensors or under float64. On a CUDA tensor
anything else raises; nothing falls back to the plain version there.

With `batched=True` every leaf carries a leading task axis of one size V
and each task is clipped by its own norm (kernel row 9); otherwise the
tree is one task (row 8). Counterpart of
`weatherforecast_stgcn_maml_tpu/ops/fused_sgd.py` (`clip_sgd_update`,
Pallas bodies `_kernel` and `_kernel_batched`). The update is first-order:
it runs outside autograd, and the MAML inner loop calls it under
`torch.no_grad()`, so it needs no backward.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from weatherforecast_stgcn_maml_tpu_torch.ops import cuda_build

MAX_LEAVES = 64  # the kernel's leaf table (csrc/fused_sgd.cu)


@torch.no_grad()
def clip_sgd_update_plain(
    params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], lr: float,
    max_norm: float, *, batched: bool = False,
) -> None:
    """Plain PyTorch version: the squares summed leaf by leaf in the given
    order (in the grads' dtype), then p - (lr * scale) * g on every leaf."""
    if batched:
        sq = sum(torch.sum(torch.square(g).reshape(g.shape[0], -1), dim=1) for g in grads)
    else:
        sq = sum(torch.sum(torch.square(g)) for g in grads)
    norm = torch.sqrt(sq)
    step = lr * torch.where(norm > max_norm, max_norm / (norm + 1e-6), 1.0)
    for p, g in zip(params, grads):
        p.sub_((step.reshape(-1, *[1] * (g.dim() - 1)) if batched else step) * g)


def _check(params, grads, lr, max_norm, batched):
    if not isinstance(lr, (int, float)) or not isinstance(max_norm, (int, float)):
        raise TypeError(
            f"lr and max_norm must be Python numbers, got {type(lr).__name__} and "
            f"{type(max_norm).__name__}"
        )
    if not params or len(params) != len(grads):
        raise ValueError(f"{len(params)} parameters but {len(grads)} gradients")
    dev, dtype = params[0].device, params[0].dtype
    for i, (p, g) in enumerate(zip(params, grads)):
        if p.shape != g.shape:
            raise ValueError(f"leaf {i}: parameter {list(p.shape)}, gradient {list(g.shape)}")
        if {p.device, g.device} != {dev} or {p.dtype, g.dtype} != {dtype}:
            raise TypeError("every parameter and gradient must share one device and dtype")
    if batched and (
        any(p.dim() == 0 for p in params) or len({p.shape[0] for p in params}) != 1
    ):
        raise ValueError("batched leaves must share one leading task axis")
    if torch.is_grad_enabled() and any(g.requires_grad for g in grads):
        raise RuntimeError(
            "the clip + SGD update is first-order and has no backward; pass "
            "gradients that do not require grad, or call it under torch.no_grad()"
        )


def clip_sgd_update(
    params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], lr: float,
    max_norm: float, *, batched: bool = False,
) -> None:
    """Update `params` in place: p <- p - lr * clip(g), the norm over all
    leaves (per task of the leading axis with `batched`).

    Args:
      params: the leaves (the norm sums them in this order); on a card
        contiguous float32 tensors.
      grads: one gradient of the same shape, device and dtype per leaf.
      lr, max_norm: Python numbers (the MAML inner lr and clip norm).
    """
    _check(params, grads, lr, max_norm, batched)
    dev, dtype = params[0].device, params[0].dtype
    if dev.type == "cpu" or dtype == torch.float64:
        return clip_sgd_update_plain(params, grads, lr, max_norm, batched=batched)
    if dev.type != "cuda":
        raise TypeError(f"no clip + SGD kernel for device {dev}")
    if dtype != torch.float32:
        raise TypeError(f"the clip + SGD kernel takes float32 leaves, not {dtype}")
    if len(params) > MAX_LEAVES:
        raise ValueError(f"the clip + SGD kernel takes at most {MAX_LEAVES} leaves")
    if not all(p.is_contiguous() for p in params):
        raise ValueError("the clip + SGD kernel updates contiguous parameters in place")
    grads = [g.contiguous() for g in grads]
    tasks = params[0].shape[0] if batched else 1
    n = len(params)
    sizes = (ctypes.c_longlong * n)(*(p.numel() // tasks for p in params))
    lib = cuda_build.load()
    chunks = lib.wf_clip_sgd_chunks(n, sizes)
    if chunks < 0:
        raise ValueError("the clip + SGD kernel takes non-empty leaves")
    partials = torch.empty(tasks * chunks, dtype=torch.float32, device=dev)
    cuda_build.check(
        lib.wf_clip_sgd_update(
            n, (ctypes.c_void_p * n)(*(p.data_ptr() for p in params)),
            (ctypes.c_void_p * n)(*(g.data_ptr() for g in grads)), sizes, tasks,
            float(lr), float(max_norm), partials.data_ptr(), cuda_build.stream_ptr(dev),
        ),
        "clip + SGD update",
    )
    if batched:
        clip_sgd_update.batched_launches += 1
    else:
        clip_sgd_update.launches += 1


clip_sgd_update.launches = 0  # updates run through the CUDA kernel, one task (row 8)
clip_sgd_update.batched_launches = 0  # with a task axis (row 9)
