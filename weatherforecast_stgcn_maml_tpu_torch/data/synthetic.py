"""Synthetic weather-field generator.

Deterministic, physically-flavored fake ERA5 data: fields are smooth in
space and periodic in time (diurnal + annual cycles plus traveling waves).
Bit-identical to the JAX package's generator for the same arguments, so both
packages serve the same region from the same seed.
"""

from __future__ import annotations

import numpy as np

from weatherforecast_stgcn_maml_tpu_torch.config import NUM_WEATHER_VARS
from weatherforecast_stgcn_maml_tpu_torch.data.region import RegionData

# Per-variable (offset, scale) giving realistic magnitudes: e.g. t2m ~ 288 K,
# sp ~ 1e5 Pa. Index order = config.WEATHER_VARS.
_VAR_OFFSET = np.array(
    [0.0, 0.0, 288.0, 283.0, 1.013e5, 1e-4, 0.0, 0.0, -3e5, 0.5, 0.4, -3e-4],
    dtype=np.float64,
)
_VAR_SCALE = np.array(
    [5.0, 5.0, 8.0, 7.0, 800.0, 3e-4, 8.0, 8.0, 8e4, 0.3, 0.3, 2e-4],
    dtype=np.float64,
)


def synthetic_region(
    lat_min: float = 18.0,
    lat_max: float = 23.0,
    lon_min: float = 75.0,
    lon_max: float = 80.0,
    *,
    num_timesteps: int = 256,
    resolution: float = 0.25,
    start: str = "2020-01-01T00:00",
    step_hours: int = 1,
    seed: int = 0,
    noise: float = 0.05,
    nan_fraction: float = 0.0,
    koppen_code: int = 8,
    name: str = "synthetic",
    hour_offset: int = 0,
) -> RegionData:
    """Generate a RegionData box on a regular grid.

    Each variable v at (t, lat, lon) is
      offset_v + scale_v * [diurnal + annual + traveling wave + noise]
    with variable-specific random phases. Wave parameters depend only on
    (seed, variable), so boxes sharing a seed sample one global field; the
    noise stream is keyed on the box as well.
    """
    lats = np.arange(lat_min, lat_max + 1e-9, resolution)
    lons = np.arange(lon_min, lon_max + 1e-9, resolution)
    t0 = np.datetime64(start) + np.timedelta64(hour_offset, "h")
    times = t0 + np.arange(num_timesteps) * np.timedelta64(step_hours, "h")

    hours = hour_offset + np.arange(num_timesteps) * step_hours
    diurnal = np.sin(2 * np.pi * hours / 24.0)[:, None, None]
    annual = np.sin(2 * np.pi * hours / (24.0 * 365.25))[:, None, None]
    lat_g, lon_g = np.meshgrid(lats, lons, indexing="ij")

    fields = np.empty(
        (num_timesteps, len(lats), len(lons), NUM_WEATHER_VARS), dtype=np.float32
    )
    box_key = (
        int(round((lat_min + 90.0) * 100)),
        int(round((lon_min + 360.0) * 100)),
    )
    for v in range(NUM_WEATHER_VARS):
        prng = np.random.default_rng((seed, v))
        phase = prng.uniform(0, 2 * np.pi)
        kx, ky = prng.uniform(0.5, 2.0, size=2)
        speed = prng.uniform(0.05, 0.2)
        wave = np.sin(
            kx * lat_g[None] + ky * lon_g[None] + speed * hours[:, None, None] + phase
        )
        base = 0.45 * diurnal + 0.25 * annual + 0.5 * wave
        nrng = np.random.default_rng((seed, v, *box_key, hour_offset))
        base = base + noise * nrng.standard_normal(base.shape)
        fields[..., v] = (_VAR_OFFSET[v] + _VAR_SCALE[v] * base).astype(np.float32)

    if nan_fraction > 0:
        nan_rng = np.random.default_rng((seed, 999, *box_key))
        mask = nan_rng.random(fields.shape) < nan_fraction
        fields[mask] = np.nan

    return RegionData(
        weather=fields,
        times=times,
        lats=lats.astype(np.float64),
        lons=lons.astype(np.float64),
        koppen_code=koppen_code,
        name=name,
    )


def synthetic_region_for_box(
    box: tuple[float, float, float, float],
    *,
    num_timesteps: int = 256,
    resolution: float = 0.25,
    seed: int | None = None,
    **kwargs,
) -> RegionData:
    """Synthetic region keyed deterministically on the box coordinates.

    Pass an explicit shared `seed` to sample all boxes from one global wave
    field (see synthetic_region)."""
    lat_min, lat_max, lon_min, lon_max = box
    if seed is None:
        seed = abs(hash((lat_min, lat_max, lon_min, lon_max))) % (2**31)
    kwargs.setdefault("name", f"synthetic{box}")
    return synthetic_region(
        lat_min,
        lat_max,
        lon_min,
        lon_max,
        num_timesteps=num_timesteps,
        resolution=resolution,
        seed=seed,
        **kwargs,
    )
