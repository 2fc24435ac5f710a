"""Windowed sample extraction by tensor indexing, on the features' device.

Sample semantics:
  anchor t valid in [window, T - horizon)
  x = features[t-window : t]                      -> [W, N, C]
  y = features[t+1 : t+horizon+1, :, :12]         -> [H, N, 12]
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from weatherforecast_stgcn_maml_tpu_torch.config import NUM_WEATHER_VARS


@dataclass(frozen=True)
class WindowSpec:
    window: int
    horizon: int

    def num_samples(self, num_timesteps: int) -> int:
        return max(0, num_timesteps - self.horizon - self.window)


def gather_batch(
    features: torch.Tensor, anchors: torch.Tensor, spec: WindowSpec
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batch-gather windows: [B] anchors -> (x [B, W, N, C], y [B, H, N, 12])."""
    anchors = anchors.to(device=features.device, dtype=torch.long)
    t = features.shape[0]
    if anchors.numel() and (
        int(anchors.min()) < spec.window or int(anchors.max()) + spec.horizon >= t
    ):
        raise ValueError(
            f"anchors must lie in [{spec.window}, {t - spec.horizon}) for "
            f"{t} timesteps"
        )
    x_idx = anchors[:, None] + torch.arange(
        -spec.window, 0, device=features.device
    )
    y_idx = anchors[:, None] + torch.arange(
        1, spec.horizon + 1, device=features.device
    )
    return features[x_idx], features[y_idx][..., :NUM_WEATHER_VARS]


def contiguous_split(
    num_samples: int, first_fraction: float, max_samples: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Contiguous (temporal, leakage-free) index split: the first
    `max_samples`, the leading `first_fraction` of them apart from the rest."""
    total = num_samples if max_samples is None else min(max_samples, num_samples)
    cut = int(first_fraction * total)
    return np.arange(0, cut), np.arange(cut, total)
