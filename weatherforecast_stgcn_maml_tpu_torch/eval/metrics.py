"""Per-variable forecast metrics: node-averaged, denormalized MSE and MAE
over the horizon for the first `num_scored` variables, with surface
pressure (`sp`) excluded from the reported average."""

from __future__ import annotations

import numpy as np

from weatherforecast_stgcn_maml_tpu_torch.config import WEATHER_VARS
from weatherforecast_stgcn_maml_tpu_torch.data.preprocess import NormStats


def variable_metrics(
    pred_norm: np.ndarray,
    true_norm: np.ndarray,
    stats: NormStats,
    *,
    num_scored: int = 6,
    exclude_from_average: tuple[str, ...] = ("sp",),
) -> dict:
    """Score node-averaged normalized forecasts.

    Args:
      pred_norm, true_norm: [H, 12] node-averaged normalized values.
    Returns:
      {var: {"mse": float, "mae": float}, ..., "average_mse": float}
    """
    results: dict = {}
    total, count = 0.0, 0
    for idx in range(min(num_scored, pred_norm.shape[-1])):
        var = WEATHER_VARS[idx]
        p = stats.denormalize(pred_norm[:, idx], idx)
        t = stats.denormalize(true_norm[:, idx], idx)
        mse = float(np.mean((p - t) ** 2))
        mae = float(np.mean(np.abs(p - t)))
        results[var] = {"mse": mse, "mae": mae}
        if var not in exclude_from_average:
            total += mse
            count += 1
    results["average_mse"] = total / count if count else 0.0
    return results


def forecast_table(times, true_temp: np.ndarray, pred_temp: np.ndarray) -> str:
    """Render the per-step t2m forecast table."""
    lines = [
        "Step | Timestamp           | TrueK | PredK | ErrorK",
        "-" * 55,
    ]
    for i, (t, p, ts) in enumerate(zip(true_temp, pred_temp, times)):
        lines.append(
            f"{i + 1:>4} | {str(ts)[:19]:<19} | {t:5.1f} | {p:5.1f} | "
            f"{abs(p - t):6.1f}"
        )
    return "\n".join(lines)
