"""Feature assembly: RegionData -> model-ready [T, N, C] array + stats.

The JAX package's `data/preprocess.py`, on its native host pipeline
(`native`) where that is on and on its numpy route otherwise: features
carry weather (12, z-scored) + time (4) channels (+2 optional relative
coordinates); the Koppen embedding is looked up inside the model.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from weatherforecast_stgcn_maml_tpu_torch import native
from weatherforecast_stgcn_maml_tpu_torch.config import NUM_WEATHER_VARS
from weatherforecast_stgcn_maml_tpu_torch.data.region import RegionData
from weatherforecast_stgcn_maml_tpu_torch.data.timefeat import time_features


@dataclass(frozen=True)
class NormStats:
    """Per-variable z-score statistics over (time, nodes)."""

    mean: np.ndarray  # [12]
    std: np.ndarray  # [12]

    def to_dict(self) -> dict:
        return {"mean": self.mean.tolist(), "std": self.std.tolist()}

    @staticmethod
    def from_dict(d: dict) -> "NormStats":
        return NormStats(
            mean=np.asarray(d["mean"], dtype=np.float32),
            std=np.asarray(d["std"], dtype=np.float32),
        )

    def denormalize(self, x: np.ndarray, var_idx: int | None = None) -> np.ndarray:
        """Invert the z-score: all 12 variables along the last axis, or one
        variable when `var_idx` is given."""
        if var_idx is not None:
            return x * self.std[var_idx] + self.mean[var_idx]
        return x * self.std + self.mean


def nan_percentages(weather: np.ndarray) -> np.ndarray:
    """Fraction of NaNs per variable (the last axis)."""
    flat = weather.reshape(-1, weather.shape[-1])
    return np.isnan(flat).mean(axis=0)


def fill_nans_with_mean(weather: np.ndarray) -> np.ndarray:
    """Replace NaNs by the per-variable nanmean (0 if a variable is all-NaN)."""
    if not np.isnan(weather).any():
        return weather
    out = weather.copy()
    for v in range(out.shape[-1]):
        col = out[..., v]
        hole = np.isnan(col)
        valid = col[~hole]
        col[hole] = valid.mean() if valid.size else 0.0
    return out


def compute_stats(weather_nodes: np.ndarray) -> NormStats:
    """Z-score stats over (T, N) per variable with a 1e-8 epsilon guard."""
    mean = weather_nodes.mean(axis=(0, 1))
    std = weather_nodes.std(axis=(0, 1)) + 1e-8
    mean = np.nan_to_num(mean, nan=0.0)
    std = np.nan_to_num(std, nan=1.0)
    return NormStats(mean=mean.astype(np.float32), std=std.astype(np.float32))


def relative_coord_channels(region: RegionData) -> np.ndarray:
    """[N, 2] within-box coordinates, each axis scaled to [-1, 1]."""

    def scaled(v):
        v = np.asarray(v, np.float32)
        span = v.max() - v.min()
        if span <= 0:
            return np.zeros_like(v)
        return 2.0 * (v - v.min()) / span - 1.0

    lat_g, lon_g = np.meshgrid(
        scaled(region.lats), scaled(region.lons), indexing="ij"
    )
    return np.stack([lat_g.ravel(), lon_g.ravel()], axis=-1).astype(np.float32)


def prepare_features(
    region: RegionData,
    *,
    stats: NormStats | None = None,
    rel_coords: bool = False,
) -> tuple[np.ndarray, NormStats]:
    """Build the [T, N, 16(+2)] feature array; returns (features, stats).

    When `stats` is given it is reused (validation and serving normalize
    with the stats saved at adaptation time); otherwise new stats are
    computed. Where the native host pipeline is on (`native`), the NaN fill
    and the stats are one fused C++ pass and the z-score another, in place
    on a fresh copy, as in the JAX package.
    """
    t, la, lo, c = region.weather.shape
    if c != NUM_WEATHER_VARS:
        raise ValueError(f"expected {NUM_WEATHER_VARS} weather vars, got {c}")
    # A fresh C-contiguous copy: the native route fills and normalizes it in
    # place and must never change the caller's RegionData.
    nodes = np.array(region.weather.reshape(t, la * lo, c), dtype=np.float32, order="C")

    fused = native.nan_fill_stats_native(nodes)  # the NaN fill, in place
    if fused is None:
        nodes = fill_nans_with_mean(nodes)
    if stats is None:
        stats = NormStats(mean=fused[0], std=fused[1]) if fused is not None else (
            compute_stats(nodes))
    if not native.normalize_native(nodes, stats.mean, stats.std):
        nodes = (nodes - stats.mean) / stats.std

    tf = time_features(region.times)  # [T, 4]
    tf_tiled = np.broadcast_to(tf[:, None, :], (t, la * lo, tf.shape[-1]))
    parts = [nodes, tf_tiled]
    if rel_coords:
        rc = relative_coord_channels(region)  # [N, 2]
        parts.append(np.broadcast_to(rc[None], (t, la * lo, 2)))
    features = np.concatenate(parts, axis=-1).astype(np.float32)
    if np.isnan(features).any():
        features = np.nan_to_num(features, nan=0.0)
    return features, stats


def pad_nodes(features: np.ndarray, padded_nodes: int) -> np.ndarray:
    """Zero-pad the node axis of [T, N, C] features to `padded_nodes`."""
    t, n, c = features.shape
    if padded_nodes < n:
        raise ValueError(f"padded_nodes={padded_nodes} < N={n}")
    if padded_nodes == n:
        return features
    out = np.zeros((t, padded_nodes, c), dtype=features.dtype)
    out[:, :n] = features
    return out
