"""Validation engine.

Loads the adapted checkpoint (falling back to the meta-trained base), takes
the middle <= `validate_max_timesteps` slice of the validation-year data,
normalizes with the stats saved at adaptation time, runs one batched
forward over a few windows, and scores the node-averaged, denormalized
forecasts per variable. With `compat.average_validation_targets` (the
reference protocol) predictions and targets are averaged over the windows
before scoring; otherwise each window is scored and the metrics averaged.
With `make_plots` (the default) the temperature and all-variable figures go
to `<out_dir>/validation/`; where matplotlib is missing that raises an
ImportError naming `--no-plots` before any checkpoint or data is read.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from weatherforecast_stgcn_maml_tpu_torch.config import ExperimentConfig, T2M_INDEX
from weatherforecast_stgcn_maml_tpu_torch.data.preprocess import (
    NormStats,
    pad_nodes,
    prepare_features,
)
from weatherforecast_stgcn_maml_tpu_torch.data.region import RegionData
from weatherforecast_stgcn_maml_tpu_torch.data.windows import WindowSpec, gather_batch
from weatherforecast_stgcn_maml_tpu_torch.engines.adapt import adapted_ckpt_path
from weatherforecast_stgcn_maml_tpu_torch.engines.data_source import get_region_data
from weatherforecast_stgcn_maml_tpu_torch.eval.metrics import (
    forecast_table,
    variable_metrics,
)
from weatherforecast_stgcn_maml_tpu_torch.eval.plots import (
    require_matplotlib,
    temperature_figure,
    variables_figure,
)
from weatherforecast_stgcn_maml_tpu_torch.graph import build_region_graph
from weatherforecast_stgcn_maml_tpu_torch.models.registry import init_model, load_params
from weatherforecast_stgcn_maml_tpu_torch.train.supervised import make_predict
from weatherforecast_stgcn_maml_tpu_torch.utils.checkpoint import (
    check_family,
    checkpoint_exists,
    load_checkpoint,
)


@dataclass
class ValidationResult:
    results: dict  # {var: {mse, mae}, "average_mse": float}
    table: str
    plots: list
    region_name: str
    model_kind: str  # "adapted" | "base"


def host_array(t: torch.Tensor) -> np.ndarray:
    """A prediction as numpy in its own precision (float64 stays float64, as
    JAX's arrays do under x64); bfloat16, which numpy lacks, as float32."""
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _mean_metric_dicts(dicts: list[dict]) -> dict:
    """Average identically-shaped metric dicts leaf-wise."""
    out = {}
    for key, value in dicts[0].items():
        if isinstance(value, dict):
            out[key] = _mean_metric_dicts([d[key] for d in dicts])
        else:
            out[key] = float(np.mean([d[key] for d in dicts]))
    return out


def _load_params_and_stats(cfg: ExperimentConfig, box, region_name, log_cb, device):
    """Adapted checkpoint first, base fallback. Returns (model on `device`,
    saved stats or None, kind)."""
    adapted = adapted_ckpt_path(cfg.out_dir, region_name, box)
    base = os.path.join(cfg.out_dir, "meta", "ckpt_best")
    if checkpoint_exists(adapted):
        path, kind = adapted, "adapted"
    elif checkpoint_exists(base):
        log_cb(f"[validate:{region_name}] no adapted model, using base checkpoint")
        path, kind = base, "base"
    else:
        raise FileNotFoundError(
            f"no checkpoint found for {region_name}: tried {adapted} and {base}"
        )
    state_dict, meta = load_checkpoint(path)
    check_family(meta, cfg.model.family, path)
    model = init_model(torch.Generator().manual_seed(0), cfg.model)
    load_params(model, state_dict)
    model.requires_grad_(False)
    stats = (
        NormStats.from_dict(meta["stats"])
        if kind == "adapted" and meta.get("stats")
        else None
    )
    return model.to(device), stats, kind


def run_validation(
    cfg: ExperimentConfig,
    box,
    region_name: str,
    *,
    device: torch.device | str,
    region: RegionData | None = None,
    make_plots: bool = True,
    log_cb=print,
) -> ValidationResult:
    if make_plots:
        require_matplotlib()
    model_cfg, data_cfg = cfg.model, cfg.data
    device = torch.device(device)
    params, saved_stats, kind = _load_params_and_stats(
        cfg, box, region_name, log_cb, device
    )

    if region is None:
        region = get_region_data(
            box,
            (data_cfg.validate_year,),
            data_cfg,
            tag="validate",
            name=region_name,
            num_timesteps=max(
                data_cfg.validate_max_timesteps + model_cfg.window + model_cfg.horizon,
                96,
            ),
        )

    # At least one (window, horizon) pair with its anchor step between them.
    needed = model_cfg.window + model_cfg.horizon + 1
    total = region.num_timesteps
    if total < needed:
        log_cb(
            f"[validate:{region_name}] only {total} timesteps "
            f"(need {needed}) — returning inf MSE"
        )
        return ValidationResult(
            results={"average_mse": float("inf")},
            table="",
            plots=[],
            region_name=region_name,
            model_kind=kind,
        )

    start = max(0, total // 4)
    end = min(total, start + data_cfg.validate_max_timesteps)
    if end - start < needed:
        start, end = 0, min(total, max(needed, data_cfg.validate_max_timesteps))
    sub = RegionData(
        weather=region.weather[start:end],
        times=region.times[start:end],
        lats=region.lats,
        lons=region.lons,
        koppen_code=region.koppen_code,
        name=region.name,
    )

    graph = build_region_graph(sub.lats, sub.lons, k_neighbors=data_cfg.k_neighbors)
    features_np, stats = prepare_features(
        sub, stats=saved_stats, rel_coords=model_cfg.relative_coords
    )
    features = torch.from_numpy(pad_nodes(features_np, graph.padded_nodes)).to(device)

    spec = WindowSpec(model_cfg.window, model_cfg.horizon)
    num = min(data_cfg.validate_num_samples, spec.num_samples(sub.num_timesteps))
    anchors = torch.arange(spec.window, spec.window + num)
    x, y = gather_batch(features, anchors, spec)

    koppen = 0 if cfg.compat.koppen_zero_in_adapt else max(region.koppen_code, 0)
    predict = make_predict(model_cfg)
    a_hat = torch.from_numpy(graph.a_hat).to(device)
    preds = host_array(predict(params, x, a_hat, koppen))
    targets = y.cpu().numpy()

    n = graph.num_nodes
    # Node-average the real nodes: [B, H, N, 12] -> [B, H, 12].
    pred_avg_b = preds[:, :, :n, :].mean(axis=2)
    true_avg_b = targets[:, :, :n, :].mean(axis=2)

    pred_avg, true_avg = pred_avg_b.mean(axis=0), true_avg_b.mean(axis=0)
    if cfg.compat.average_validation_targets:
        results = variable_metrics(pred_avg, true_avg, stats)
    else:
        results = _mean_metric_dicts(
            [variable_metrics(pred_avg_b[i], true_avg_b[i], stats) for i in range(num)]
        )

    # t2m table on the first window's timeline.
    input_times = sub.times[: model_cfg.window]
    forecast_times = sub.times[model_cfg.window : model_cfg.window + model_cfg.horizon]
    t_true = stats.denormalize(true_avg[:, T2M_INDEX], T2M_INDEX)
    t_pred = stats.denormalize(pred_avg[:, T2M_INDEX], T2M_INDEX)
    table = forecast_table(forecast_times, t_true, t_pred)
    log_cb(f"[validate:{region_name}] t2m forecast ({kind} model):\n{table}")

    plots = []
    if make_plots:
        plot_dir = os.path.join(cfg.out_dir, "validation")
        x0 = x[0].cpu().numpy()[:, :n, :]  # [W, N, C]
        input_temp = stats.denormalize(x0[..., T2M_INDEX].mean(axis=1), T2M_INDEX)
        plots.append(temperature_figure(
            os.path.join(plot_dir, f"{region_name}_temperature.png"),
            input_times, forecast_times, input_temp, t_true, t_pred, region_name,
        ))
        plots.append(variables_figure(
            os.path.join(plot_dir, f"{region_name}_all_variables.png"),
            true_avg, pred_avg, stats, region_name,
        ))

    summary = ", ".join(
        f"{k}: mse={v['mse']:.3f}" for k, v in results.items() if isinstance(v, dict)
    )
    log_cb(
        f"[validate:{region_name}] {summary}; "
        f"average_mse={results['average_mse']:.3f}"
    )
    return ValidationResult(
        results=results,
        table=table,
        plots=plots,
        region_name=region_name,
        model_kind=kind,
    )
