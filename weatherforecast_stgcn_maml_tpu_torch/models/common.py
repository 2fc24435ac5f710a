"""Shared building blocks: the dtype policy, dense layers, the LSTM bias,
dropout masks.

Parameters are stored float32. A product rounds its operands to the compute
dtype and multiplies them in the accumulation dtype (float32, or float64
under float64), which is what the JAX package's
`jnp.dot(..., preferred_element_type=f32)` computes. A bfloat16
`torch.matmul` would round its output to bfloat16 instead, so none is used.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float64": torch.float64,
}


def resolve_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(
            f"unknown compute_dtype {name!r}; known: {sorted(_DTYPES)}"
        ) from None


def accum_dtype(compute_dtype: torch.dtype) -> torch.dtype:
    """float32 accumulation for float32/bfloat16 compute, float64 under float64."""
    return torch.float64 if compute_dtype == torch.float64 else torch.float32


def as_operand(x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """`x` rounded to the compute dtype, widened to the accumulation dtype."""
    return x.to(compute_dtype).to(accum_dtype(compute_dtype))


def draw_mask(
    generator: torch.Generator, shape, rate: float, device: torch.device | str
) -> torch.Tensor:
    """An int8 {0, 1} dropout mask, each element 1 with probability
    1 - rate, drawn from `generator` (a generator on `device`)."""
    return (torch.rand(shape, generator=generator, device=device) < 1.0 - rate).to(
        torch.int8
    )


def apply_mask(x: torch.Tensor, mask: torch.Tensor, keep: float) -> torch.Tensor:
    """Inverted dropout with a drawn mask, in the kernels' form
    x * (m * (1 / keep)); the JAX package's where(m, x / keep, 0) differs
    from it in the last bit at most."""
    return x * (mask.to(x.dtype) * (1.0 / keep))


def train_masks(cfg, x: torch.Tensor, train: bool, generator, masks, draw) -> dict:
    """The dropout masks of a forward: none in eval mode; in train mode the
    given ones, else drawn from `generator`, else none.

    One window x [W, N, C] takes one window's masks, `draw(cfg, generator,
    W, N, device)`. A window batch x [B, W, N, C] takes per-window masks
    with a leading B axis: each window draws its own in turn (its encoder,
    LSTM and head masks, as the JAX package draws them for each window of a
    vmapped batch), and they are stacked per site."""
    if not train:
        return {}
    if x.dim() not in (3, 4):
        raise ValueError(
            f"a train-mode forward takes one window [W, N, C] or a window batch "
            f"[B, W, N, C], got {list(x.shape)}"
        )
    if masks is not None:
        return masks
    if generator is None:
        return {}
    w, n = x.shape[-3], x.shape[-2]
    if x.dim() == 3:
        return draw(cfg, generator, w, n, x.device)
    per_window = [draw(cfg, generator, w, n, x.device) for _ in range(x.shape[0])]
    return {k: torch.stack([m[k] for m in per_window]) for k in per_window[0]}


def fold_slice_masks(masks: torch.Tensor) -> torch.Tensor:
    """Per-window encoder masks [B, n, W, N, C] -> [n, B*W, N, C]: the
    encoder takes the batch's time slices window by window."""
    b, n_masks, w = masks.shape[:3]
    return masks.transpose(0, 1).reshape(n_masks, b * w, *masks.shape[3:]).contiguous()


def fold_row_masks(masks: torch.Tensor) -> torch.Tensor:
    """Per-window LSTM masks [B, n, W, N, H] -> time-major [n, W, B*N, H]:
    row b*N + node of the LSTM is node `node` of window b."""
    b, n_masks, w, n, h = masks.shape
    return masks.permute(1, 2, 0, 3, 4).reshape(n_masks, w, b * n, h).contiguous()


def lstm_bias(layer: Mapping) -> torch.Tensor:
    """Effective gate bias of one LSTM layer given as a mapping of arrays:
    the fused `b`, or the sum of torch-style split `b_ih` + `b_hh`."""
    if "b" in layer:
        return layer["b"]
    return layer["b_ih"] + layer["b_hh"]


def scaled_uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


class Dense(nn.Module):
    """Weight `w` stored [in, out] and bias `b`: a dense layer or a GCN layer."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


def init_dense(generator: torch.Generator, in_dim: int, out_dim: int) -> Dense:
    """Fan-in uniform init (the torch.nn.Linear scheme)."""
    bound = 1.0 / float(in_dim) ** 0.5
    return Dense(
        scaled_uniform((in_dim, out_dim), bound, generator),
        scaled_uniform((out_dim,), bound, generator),
    )


def apply_dense(p: Dense, x: torch.Tensor, *, compute_dtype=torch.float32) -> torch.Tensor:
    return (
        torch.matmul(as_operand(x, compute_dtype), as_operand(p.w, compute_dtype))
        + p.b
    )
