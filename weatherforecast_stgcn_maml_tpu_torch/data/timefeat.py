"""Cyclical time features: sin/cos of year progress (2*pi*day_of_year/365.25)
and of day progress (2*pi*fractional_hour/24) from datetime64 timestamps.
Returns [T, 4] in TIME_VARS order."""

from __future__ import annotations

import numpy as np


def time_features(times: np.ndarray) -> np.ndarray:
    """Compute [T, 4] cyclical features from datetime64 timestamps.

    Column order matches config.TIME_VARS:
    (year_progress_sin, year_progress_cos, day_progress_sin, day_progress_cos).
    """
    ts = np.asarray(times).astype("datetime64[ns]")
    # Day of year: days since Jan 1 of each timestamp's year, 1-based.
    years = ts.astype("datetime64[Y]")
    day_of_year = (ts.astype("datetime64[D]") - years.astype("datetime64[D]")).astype(
        np.int64
    ) + 1
    # Fractional hour of day.
    ns_in_day = (ts - ts.astype("datetime64[D]")).astype("timedelta64[ns]").astype(
        np.int64
    )
    hour_frac = ns_in_day / 3.6e12  # ns per hour

    year_progress = 2.0 * np.pi * day_of_year / 365.25
    day_progress = 2.0 * np.pi * hour_frac / 24.0
    return np.stack(
        [
            np.sin(year_progress),
            np.cos(year_progress),
            np.sin(day_progress),
            np.cos(day_progress),
        ],
        axis=-1,
    ).astype(np.float32)
