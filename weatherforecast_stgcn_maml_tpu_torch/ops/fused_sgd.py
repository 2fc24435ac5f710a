"""Whole-tree clip + SGD update: `p <- p - lr * clip(g)` over every leaf of a
parameter tree, in place, with torch's clip_grad_norm_ semantics (the
global norm over all leaves; scale by max_norm / (norm + 1e-6) only when
norm > max_norm).

`clip_sgd_update` runs the hand-written CUDA kernel (csrc/fused_sgd.cu) on
CUDA float32 tensors and its plain PyTorch version,
`clip_sgd_update_plain`, on CPU tensors or under float64. On a CUDA tensor
anything else raises; nothing falls back to the plain version there. A call
on a card packs one launch from a plan cached for the tree (`_Plan`: the
leaves' addresses and shapes, the kernel's scratch) and makes one C call.

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
import struct
from operator import attrgetter
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


def _card_refusals(params) -> None:
    """What the kernel does not take, beyond `_check`: raise on it."""
    dev, dtype = params[0].device, params[0].dtype
    if not _on_card(params[0]):
        raise TypeError(f"no clip + SGD kernel for device {dev}")
    if dtype != torch.float32:
        raise TypeError(f"the clip + SGD kernel takes float32 leaves, not {dtype}")
    if len(params) > MAX_LEAVES:
        raise ValueError(f"the clip + SGD kernel takes at most {MAX_LEAVES} leaves")
    if not all(p.is_contiguous() for p in params):
        raise ValueError("the clip + SGD kernel updates contiguous parameters in place")


def _on_card(p: torch.Tensor) -> bool:
    return p.is_cuda


def _library():
    return cuda_build.load()


_shape, _needs_grad = attrgetter("shape"), attrgetter("requires_grad")
_ptr, _contiguous = torch.Tensor.data_ptr, torch.Tensor.is_contiguous
# One C++ pass over a tensor list: {(device, dtype): ...} of its tensors.
_by_device_and_dtype = torch._C._group_tensors_by_device_and_dtype


class _Plan:
    """One parameter tree's launch, kept between calls (the MAML inner loop
    updates the same leaves in place at every inner step): the tree's
    signature (the leaves' addresses and shapes), its device, task count,
    the kernel's scratch and the launch's packing."""

    __slots__ = ("pptrs", "shapes", "where", "tasks", "entry", "partials", "launch", "sizes")

    def __init__(self, params, pptrs, shapes, batched):
        n = len(params)
        self.pptrs, self.shapes = pptrs, shapes
        self.where = (params[0].device, torch.float32)
        self.tasks = shapes[0][0] if batched else 1
        # Row 9 (a task axis) has its own entry: csrc/fused_sgd.cu.
        self.entry = "wf_clip_sgd_update_tasks" if batched else "wf_clip_sgd_update"
        sizes = [p.numel() // self.tasks for p in params]
        floats = _library().wf_clip_sgd_plan(n, (ctypes.c_longlong * n)(*sizes), self.tasks)
        if floats < 0:
            raise ValueError("the clip + SGD kernel takes non-empty leaves and at most 65535 "
                             "tasks")
        self.partials = torch.empty(floats, dtype=torch.float32, device=params[0].device)
        # csrc/fused_sgd.cu `SgdLaunch`: n_leaves, n_tasks, lr, max_norm, the
        # partials' and the stream's addresses, the parameters' and the
        # gradients' addresses, then the sizes; 8 bytes each.
        self.launch = struct.Struct(f"<qqddqq{2 * n}q")
        self.sizes = struct.pack(f"<{n}q", *sizes)


_PLANS: dict = {}  # (batched, stream) -> the plan of the tree last updated there


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

    On a card every check of `_check` and `_card_refusals` is made at every
    call, against the cached plan's signature where the tree is the one it
    was made for; the plan is made anew when the leaves' addresses or shapes
    (or the stream) change.
    """
    if (not params or len(params) != len(grads) or not isinstance(lr, (int, float))
            or not isinstance(max_norm, (int, float)) or not _on_card(params[0])
            or params[0].dtype is not torch.float32):
        _check(params, grads, lr, max_norm, batched)
        dev, dtype = params[0].device, params[0].dtype
        if dev.type == "cpu" or dtype == torch.float64:
            return clip_sgd_update_plain(params, grads, lr, max_norm, batched=batched)
        _card_refusals(params)
    pptrs, shapes = tuple(map(_ptr, params)), tuple(map(_shape, params))
    dev = params[0].device
    stream = cuda_build.stream_ptr(dev)
    plan = _PLANS.get((batched, stream))
    if plan is None or plan.pptrs != pptrs or plan.shapes != shapes:
        _check(params, grads, lr, max_norm, batched)
        _card_refusals(params)
        if len(_PLANS) >= 16:
            _PLANS.clear()
        plan = _PLANS[(batched, stream)] = _Plan(params, pptrs, shapes, batched)
    # `_check` and `_card_refusals` against the plan: shapes leaf by leaf, one
    # device and float32 throughout, contiguous parameters (the leaf count
    # and the task axis are the plan's, its shapes being these).
    p_where, g_where = _by_device_and_dtype([params], False), _by_device_and_dtype([grads], False)
    if (tuple(map(_shape, grads)) != shapes or len(p_where) != 1 or plan.where not in p_where
            or len(g_where) != 1 or plan.where not in g_where
            or not all(map(_contiguous, params))):
        _check(params, grads, lr, max_norm, batched)
        _card_refusals(params)
    if torch.is_grad_enabled() and any(map(_needs_grad, grads)):
        _check(params, grads, lr, max_norm, batched)
    if not all(map(_contiguous, grads)):
        grads = [g.contiguous() for g in grads]
    partials = plan.partials
    if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
        partials = torch.empty_like(partials)  # a captured graph's own scratch
    cuda_build.check(
        getattr(_library(), plan.entry)(
            plan.launch.pack(len(pptrs), plan.tasks, lr, max_norm, partials.data_ptr(), stream,
                             *pptrs, *map(_ptr, grads)) + plan.sizes),
        "clip + SGD update",
    )
    if batched:
        clip_sgd_update.batched_launches += 1
    else:
        clip_sgd_update.launches += 1


clip_sgd_update.launches = 0  # updates run through the CUDA kernel, one task (row 8)
clip_sgd_update.batched_launches = 0  # with a task axis (row 9)
