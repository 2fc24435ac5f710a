"""Forecast (serving) engine: load the adapted (or base) checkpoint, build
the latest window from the region's data, run the forward once, and emit
denormalized per-variable forecasts (node-averaged series plus the full
per-node grid) as JSON. With `make_plots` the input window's and the
forecast's temperature go to `<out_dir>/forecasts/<region>_forecast.png`;
where matplotlib is missing that raises an ImportError naming `--no-plots`
before any checkpoint or data is read."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import torch

from weatherforecast_stgcn_maml_tpu_torch.config import (
    ExperimentConfig,
    T2M_INDEX,
    WEATHER_VARS,
)
from weatherforecast_stgcn_maml_tpu_torch.data.preprocess import (
    pad_nodes,
    prepare_features,
)
from weatherforecast_stgcn_maml_tpu_torch.data.region import RegionData
from weatherforecast_stgcn_maml_tpu_torch.engines.data_source import get_region_data
from weatherforecast_stgcn_maml_tpu_torch.engines.validate import (
    _load_params_and_stats,
    host_array,
)
from weatherforecast_stgcn_maml_tpu_torch.eval.plots import require_matplotlib, temperature_figure
from weatherforecast_stgcn_maml_tpu_torch.graph import build_region_graph
from weatherforecast_stgcn_maml_tpu_torch.train.supervised import make_predict


@dataclass
class ForecastResult:
    times: np.ndarray  # [H] forecast timestamps
    mean_forecast: np.ndarray  # [H, 12] node-averaged, denormalized
    grid_forecast: np.ndarray  # [H, lat, lon, 12] denormalized
    artifact_path: str
    model_kind: str


def run_forecast(
    cfg: ExperimentConfig,
    box,
    region_name: str,
    *,
    device: torch.device | str,
    region: RegionData | None = None,
    make_plots: bool = False,
    log_cb=print,
) -> ForecastResult:
    if make_plots:
        require_matplotlib()
    model_cfg, data_cfg = cfg.model, cfg.data
    device = torch.device(device)
    params, saved_stats, kind = _load_params_and_stats(
        cfg, box, region_name, log_cb, device
    )

    if region is None:
        region = get_region_data(
            box, (data_cfg.validate_year,), data_cfg, tag="forecast",
            name=region_name,
            num_timesteps=max(model_cfg.window + model_cfg.horizon, 64),
        )
    if region.num_timesteps < model_cfg.window:
        raise ValueError(
            f"region {region_name}: need at least {model_cfg.window} timesteps, "
            f"have {region.num_timesteps}"
        )

    graph = build_region_graph(region.lats, region.lons, k_neighbors=data_cfg.k_neighbors)
    features_np, stats = prepare_features(
        region, stats=saved_stats, rel_coords=model_cfg.relative_coords
    )
    # The most recent full window (no target: this is inference).
    window = pad_nodes(features_np, graph.padded_nodes)[-model_cfg.window :]
    x = torch.from_numpy(window).to(device)[None]

    koppen = 0 if cfg.compat.koppen_zero_in_adapt else max(region.koppen_code, 0)
    predict = make_predict(model_cfg)
    a_hat = torch.from_numpy(graph.a_hat).to(device)
    preds = predict(params, x, a_hat, koppen)[0, :, : graph.num_nodes, :]
    preds = host_array(preds)  # [H, N, 12] normalized

    denorm = stats.denormalize(preds)  # [H, N, 12]
    grid = denorm.reshape(
        model_cfg.horizon, len(region.lats), len(region.lons), len(WEATHER_VARS)
    )
    mean_forecast = denorm.mean(axis=1)  # [H, 12]

    # Training pairs skip one step between the window and the first target
    # (x = f[t-W : t], y = f[t+1 : t+1+H]); with the window ending at
    # times[-1], the first output row is times[-1] + 2*step.
    step = region.times[-1] - region.times[-2]
    times = region.times[-1] + step * np.arange(2, model_cfg.horizon + 2)

    out_dir = os.path.join(cfg.out_dir, "forecasts")
    os.makedirs(out_dir, exist_ok=True)
    artifact = os.path.join(out_dir, f"{region_name}.json")
    with open(artifact, "w") as f:
        json.dump(
            {
                "region": list(box),
                "region_name": region_name,
                "model_kind": kind,
                "issued_from": str(region.times[-1]),
                "times": [str(t) for t in times],
                "variables": list(WEATHER_VARS),
                "mean_forecast": mean_forecast.tolist(),
            },
            f,
            indent=2,
        )

    if make_plots:
        input_temp = stats.denormalize(
            window[:, : graph.num_nodes, T2M_INDEX].mean(axis=1), T2M_INDEX
        )
        temperature_figure(
            os.path.join(out_dir, f"{region_name}_forecast.png"),
            region.times[-model_cfg.window :],
            times,
            input_temp,
            None,  # no truth for a live forecast
            mean_forecast[:, T2M_INDEX],
            region_name,
        )

    t2m = mean_forecast[:, T2M_INDEX]
    log_cb(
        f"[forecast:{region_name}] {kind} model, t2m next {model_cfg.horizon} "
        f"steps: " + ", ".join(f"{v:.1f}K" for v in t2m)
    )
    return ForecastResult(
        times=times,
        mean_forecast=mean_forecast,
        grid_forecast=grid,
        artifact_path=artifact,
        model_kind=kind,
    )
