"""Forecast plots (PNG), counterpart of
`weatherforecast_stgcn_maml_tpu/eval/plots.py`: a temperature series (the
input window, the true and the predicted forecast) and a 2x3 grid of the
first six variables over the forecast steps, with the same lines, styles,
labels, limits and titles.

matplotlib is imported lazily, with the Agg backend. It is optional:
`require_matplotlib` raises an ImportError naming `--no-plots` where it is
missing, and the engines call it before they read a checkpoint or data.
"""

from __future__ import annotations

import os

import numpy as np

from weatherforecast_stgcn_maml_tpu_torch.config import WEATHER_VARS


def require_matplotlib() -> None:
    """Raise an ImportError that names `--no-plots` where matplotlib is
    missing."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as err:
        raise ImportError(
            "plots need matplotlib, which is not installed: run `validate` and "
            "`pipeline` with --no-plots, and `forecast` without --plots"
        ) from err


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def temperature_figure(
    path: str,
    input_times,
    forecast_times,
    input_temp: np.ndarray,
    true_temp: np.ndarray | None,
    pred_temp: np.ndarray,
    region_name: str,
) -> str:
    """The input window's temperature, the true forecast (None for a live
    forecast, which has no truth yet) and the predicted one; saved to `path`."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(14, 6))
    ax.plot(input_times, input_temp, "b-", lw=2, alpha=0.7, label="Input temperature")
    if true_temp is not None:
        ax.plot(forecast_times, true_temp, "g-", lw=2, marker="o", label="True forecast")
    ax.plot(forecast_times, pred_temp, "r--", lw=2, marker="s", label="Predicted forecast")
    ax.axvline(forecast_times[0], color="black", ls=":", alpha=0.5, label="Forecast start")
    truth = [true_temp] if true_temp is not None else []
    allv = np.concatenate([input_temp, *truth, pred_temp])
    ax.set_ylim(np.floor(allv.min()) - 2, np.ceil(allv.max()) + 2)
    ax.set_xlabel("Time")
    ax.set_ylabel("Temperature (K)")
    ax.set_title(f"Temperature forecast — {region_name}")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.autofmt_xdate(rotation=45)
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def variables_figure(
    path: str,
    true_avg: np.ndarray,
    pred_avg: np.ndarray,
    stats,
    region_name: str,
    num_vars: int = 6,
) -> str:
    """A 2x3 grid of the denormalized true and predicted series per forecast
    step, from true_avg / pred_avg [H, 12] (node-averaged, normalized);
    saved to `path`."""
    plt = _plt()
    fig, axes = plt.subplots(2, 3, figsize=(15, 10))
    steps = np.arange(1, true_avg.shape[0] + 1)
    for i, ax in enumerate(axes.flat[:num_vars]):
        t = stats.denormalize(true_avg[:, i], i)
        p = stats.denormalize(pred_avg[:, i], i)
        ax.plot(steps, t, "g-", marker="o", label="True")
        ax.plot(steps, p, "r--", marker="s", label="Predicted")
        ax.set_title(WEATHER_VARS[i])
        ax.set_xlabel("Forecast step")
        ax.legend()
        ax.grid(alpha=0.3)
    fig.suptitle(f"All-variable forecast — {region_name}")
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path
