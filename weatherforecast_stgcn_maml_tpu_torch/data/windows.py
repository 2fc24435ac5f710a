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


def slice_window(
    features: torch.Tensor, anchor: int, spec: WindowSpec
) -> tuple[torch.Tensor, torch.Tensor]:
    """One (x [W, N, C], y [H, N, 12]) sample of [T, N, C] at `anchor`."""
    x = features[anchor - spec.window : anchor]
    y = features[anchor + 1 : anchor + spec.horizon + 1, :, :NUM_WEATHER_VARS]
    return x, y


def gather_batch(
    features: torch.Tensor, anchors, spec: WindowSpec
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batch-gather windows: [B] anchors (host integers: a sequence, numpy
    array or CPU tensor) -> (x [B, W, N, C], y [B, H, N, 12])."""
    anchors = [int(a) for a in anchors]
    t = features.shape[0]
    if not anchors or min(anchors) < spec.window or max(anchors) + spec.horizon >= t:
        raise ValueError(
            f"anchors must be at least one index in [{spec.window}, "
            f"{t - spec.horizon}) for {t} timesteps"
        )
    xs, ys = zip(*(slice_window(features, a, spec) for a in anchors))
    return torch.stack(xs), torch.stack(ys)


def contiguous_split(
    num_samples: int, first_fraction: float, max_samples: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Contiguous (temporal, leakage-free) index split: the first
    `max_samples`, the leading `first_fraction` of them apart from the rest."""
    total = num_samples if max_samples is None else min(max_samples, num_samples)
    cut = int(first_fraction * total)
    return np.arange(0, cut), np.arange(cut, total)
