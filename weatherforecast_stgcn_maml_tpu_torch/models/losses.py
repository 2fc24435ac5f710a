"""Losses over padded graphs: the reduction counts only real nodes, so the
padding (graph.py) never reaches a gradient or a metric."""

from __future__ import annotations

import torch


def _masked_mean(err: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """err [..., H, N, C] summed over valid nodes, divided by
    H * C * max(sum(mask), 1) and averaged over the leading dims."""
    per = (err * node_mask[..., :, None]).sum(dim=(-3, -2, -1))
    scale = err.shape[-3] * err.shape[-1] * torch.clamp(node_mask.sum(), min=1.0)
    return per.mean() / scale


def masked_mse(
    preds: torch.Tensor, targets: torch.Tensor, node_mask: torch.Tensor
) -> torch.Tensor:
    """MSE over valid nodes: preds, targets [..., H, N, C]; node_mask [N]
    with 1 for real nodes."""
    return _masked_mean(torch.square(preds - targets), node_mask)


def masked_mae(
    preds: torch.Tensor, targets: torch.Tensor, node_mask: torch.Tensor
) -> torch.Tensor:
    """Mean absolute error over valid nodes (the reduction of masked_mse)."""
    return _masked_mean(torch.abs(preds - targets), node_mask)
