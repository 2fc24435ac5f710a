"""Region data container: the 12 gridded surface variables plus coordinates
of one lat/lon box, as plain numpy arrays."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from weatherforecast_stgcn_maml_tpu_torch.config import NUM_WEATHER_VARS


@dataclass
class RegionData:
    """All host-side data for one lat/lon region.

    Attributes:
      weather: [T, lat, lon, 12] float32 raw (un-normalized) variables in
        WEATHER_VARS order. May contain NaNs (filled during preprocessing).
      times: [T] datetime64[ns] timestamps (sorted ascending).
      lats: [num_lat] latitudes.
      lons: [num_lon] longitudes.
      koppen_code: majority Koppen-Geiger class code for the box (1..30),
        0 if unknown/padding, -1 if the map had no data here.
      name: human-readable region name.
    """

    weather: np.ndarray
    times: np.ndarray
    lats: np.ndarray
    lons: np.ndarray
    koppen_code: int = 0
    name: str = ""

    def __post_init__(self):
        t, la, lo, c = self.weather.shape
        if c != NUM_WEATHER_VARS:
            raise ValueError(f"expected {NUM_WEATHER_VARS} weather vars, got {c}")
        if len(self.times) != t or len(self.lats) != la or len(self.lons) != lo:
            raise ValueError("coordinate lengths do not match weather shape")

    @property
    def num_nodes(self) -> int:
        return len(self.lats) * len(self.lons)

    @property
    def num_timesteps(self) -> int:
        return self.weather.shape[0]
