"""Dense-adjacency graph convolution: `out = A_hat @ (H @ W) + b`, applied to
every time slice with weights shared across time."""

from __future__ import annotations

import torch

from weatherforecast_stgcn_maml_tpu_torch.models.common import (
    Dense,
    as_operand,
    scaled_uniform,
)


def init_gcn_layer(generator: torch.Generator, in_dim: int, out_dim: int) -> Dense:
    """Glorot-uniform weight [in, out], zero bias."""
    limit = (6.0 / (in_dim + out_dim)) ** 0.5
    return Dense(
        scaled_uniform((in_dim, out_dim), limit, generator), torch.zeros(out_dim)
    )


def apply_gcn_layer(
    p: Dense, a_hat: torch.Tensor, h: torch.Tensor, *,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """One graph convolution over arbitrary leading dims.

    Args:
      a_hat: [N, N] normalized adjacency.
      h: [..., N, C_in] node features.
    Returns:
      [..., N, C_out] in the accumulation dtype (float32 for float32/bfloat16).
    """
    hw = torch.matmul(as_operand(h, compute_dtype), as_operand(p.w, compute_dtype))
    out = torch.matmul(
        as_operand(a_hat, compute_dtype), as_operand(hw, compute_dtype)
    )
    return out + p.b
