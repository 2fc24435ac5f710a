"""Region data resolution. The synthetic generator is the ported backend;
an ERA5 root (NetCDF through xarray) is not ported and raises."""

from __future__ import annotations

import zlib

from weatherforecast_stgcn_maml_tpu_torch.config import DataConfig
from weatherforecast_stgcn_maml_tpu_torch.data.region import RegionData
from weatherforecast_stgcn_maml_tpu_torch.data.synthetic import synthetic_region_for_box

# Hour offset of each workflow stage in the shared synthetic field, standing
# in for distinct ERA5 year ranges (train 2020-24, adapt 2023-24, validate
# and forecast 2025).
_STAGE_OFFSETS = {
    "train": 0,
    "adapt": 3 * 8766,
    "validate": 5 * 8766,
    "forecast": 5 * 8766,
}


def get_region_data(
    box: tuple[float, float, float, float],
    years,
    cfg: DataConfig,
    *,
    tag: str = "",
    name: str = "",
    num_timesteps: int | None = None,
) -> RegionData:
    """Load one region for the given years: the same synthetic data the JAX
    package generates for the same (box, tag, config)."""
    if cfg.root:
        raise NotImplementedError(
            "ERA5 data (data.root) is not ported yet; leave data.root empty "
            "for synthetic regions"
        )
    t = num_timesteps or cfg.synthetic_timesteps
    if cfg.synthetic_shared_seed >= 0:
        offset = _STAGE_OFFSETS.get(tag, 0)
        if tag == "train" and cfg.synthetic_train_time_spread_hours > 0:
            canon = repr(tuple(float(v) for v in box))
            offset += zlib.crc32(canon.encode()) % (
                cfg.synthetic_train_time_spread_hours
            )
        return synthetic_region_for_box(
            box,
            num_timesteps=t,
            seed=cfg.synthetic_shared_seed,
            hour_offset=offset,
            name=name or f"synthetic{box}",
        )
    seed = zlib.crc32(repr((box, tag)).encode()) % (2**31)
    return synthetic_region_for_box(
        box, num_timesteps=t, seed=seed, name=name or f"synthetic{box}"
    )
