"""The port's forecast plots (`eval/plots.py`) against the JAX package's, on
the CPU: the two figure functions on the same seeded numpy arrays (every
line's x and y data, style and label, each axis's limits, title and labels,
read from the Figure objects handed to `plt.close`, not from pixels); a
float64 `run_validation(make_plots=True)` against JAX's at a tiny width
(the same two files, the same line data at 1e-8); and the ImportError
naming `--no-plots` where matplotlib is missing, raised before any
checkpoint is read.
"""

import os
import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import jax  # noqa: E402

from weatherforecast_stgcn_maml_tpu import config as jcfg  # noqa: E402
from tests._host_route import restore_host_routes, use_same_host_route  # noqa: E402
from weatherforecast_stgcn_maml_tpu.data.preprocess import NormStats as JaxNormStats  # noqa: E402
from weatherforecast_stgcn_maml_tpu.data.synthetic import (  # noqa: E402
    synthetic_region_for_box as jax_box,
)
from weatherforecast_stgcn_maml_tpu.engines import validate as jax_validate  # noqa: E402
from weatherforecast_stgcn_maml_tpu.eval import plots as jax_plots  # noqa: E402
from weatherforecast_stgcn_maml_tpu.models.registry import (  # noqa: E402
    init_model as jax_init_model,
)
from weatherforecast_stgcn_maml_tpu_torch import cli  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch import config as tcfg  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.data.preprocess import NormStats  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_region_for_box,
)
from weatherforecast_stgcn_maml_tpu_torch.engines import validate  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.engines.adapt import adapted_ckpt_path  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.eval import plots  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.utils.convert import state_dict_from_params  # noqa: E402

BOX = (10.0, 11.0, 20.0, 21.0)
SMALL = dict(hidden_channels=16, gcn_layers=2, lstm_hidden=8, lstm_layers=2, window=6,
             horizon=3, koppen_dim=4)
STATS = {"mean": list(np.linspace(-1.0, 290.0, 12)), "std": list(np.linspace(0.5, 9.0, 12))}


@pytest.fixture()
def closed(monkeypatch):
    """Every Figure handed to plt.close, in order."""
    figs, close = [], plt.close

    def record(fig=None):
        figs.append(fig)
        close(fig)

    monkeypatch.setattr(plt, "close", record)
    return figs


def _figure_data(fig):
    """What a figure draws, axis by axis: every line's data, style and
    label; the axis's limits, title and labels; the figure's title."""
    axes = []
    for ax in fig.axes:
        lines = [(np.asarray(ln.get_xdata()), np.asarray(ln.get_ydata()), ln.get_linestyle(),
                  ln.get_color(), ln.get_marker(), ln.get_linewidth(), ln.get_alpha(),
                  ln.get_label()) for ln in ax.get_lines()]
        legend = ax.get_legend()
        axes.append((lines, ax.get_ylim() if lines else None, ax.get_title(), ax.get_xlabel(),
                     ax.get_ylabel(), legend and [t.get_text() for t in legend.get_texts()]))
    return axes, fig._suptitle and fig._suptitle.get_text()


def _assert_same_figure(got, ref, rtol=0.0):
    (got_axes, got_title), (ref_axes, ref_title) = _figure_data(got), _figure_data(ref)
    assert got_title == ref_title
    assert len(got_axes) == len(ref_axes)
    for (lines, ylim, *labels), (ref_lines, ref_ylim, *ref_labels) in zip(got_axes, ref_axes):
        assert labels == ref_labels
        assert len(lines) == len(ref_lines)
        for (x, y, *style), (rx, ry, *ref_style) in zip(lines, ref_lines):
            assert style == ref_style
            np.testing.assert_array_equal(x, rx)
            np.testing.assert_allclose(y.astype(float), ry.astype(float), rtol=rtol, atol=rtol)
        if ylim is not None:
            np.testing.assert_allclose(ylim, ref_ylim, rtol=rtol)


def _series(seed):
    rng = np.random.default_rng(seed)
    times = np.datetime64("2021-01-01T00") + np.arange(9) * np.timedelta64(1, "h")
    temps = (270 + 5 * rng.standard_normal(9)).astype(np.float32)
    return times[:6], times[6:], temps[:6], temps[6:] + 0.5, temps[6:]


@pytest.mark.parametrize("truth", [True, False], ids=["validate", "forecast"])
def test_temperature_figure_matches_jax(closed, tmp_path, truth):
    """The same lines, styles, limits and titles as JAX's figure; without a
    truth (a live forecast) the true line is left out."""
    in_t, fc_t, in_temp, true_temp, pred_temp = _series(1)
    true_temp = true_temp if truth else None
    for i, mod in enumerate((jax_plots, plots)):
        path = str(tmp_path / f"{i}" / "tiny_temperature.png")
        assert mod.temperature_figure(path, in_t, fc_t, in_temp, true_temp, pred_temp,
                                      "tiny") == path
        assert os.path.getsize(path) > 0
    assert len(closed) == 2
    _assert_same_figure(closed[1], closed[0])
    assert len(closed[1].axes[0].get_lines()) == (4 if truth else 3)


def test_variables_figure_matches_jax(closed, tmp_path):
    rng = np.random.default_rng(2)
    true_avg = rng.standard_normal((8, 12)).astype(np.float32)
    pred_avg = rng.standard_normal((8, 12)).astype(np.float32)
    for i, (mod, stats) in enumerate(((jax_plots, JaxNormStats.from_dict(STATS)),
                                      (plots, NormStats.from_dict(STATS)))):
        path = str(tmp_path / f"{i}" / "tiny_all_variables.png")
        mod.variables_figure(path, true_avg, pred_avg, stats, "tiny")
        assert os.path.getsize(path) > 0
    _assert_same_figure(closed[1], closed[0])
    assert [ax.get_title() for ax in closed[1].axes] == list(tcfg.WEATHER_VARS[:6])


def test_validation_plots_match_jax_float64(closed, tmp_path, monkeypatch):
    """`run_validation(make_plots=True)` in float64 on an adapted checkpoint
    against JAX's: the same metrics (1e-8), the same two files, the same
    line data (1e-8)."""
    use_same_host_route()
    try:
        params = jax.tree.map(np.asarray, jax_init_model(jax.random.key(1),
                                                         jcfg.ModelConfig(**SMALL)))
        f64 = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
        monkeypatch.setattr(jax_validate, "_load_params_and_stats", lambda *a: (
            f64, JaxNormStats.from_dict(STATS), "adapted"))
        model = dict(**SMALL, compute_dtype="float64")
        with jax.enable_x64(True):
            ref = jax_validate.run_validation(
                jcfg.ExperimentConfig(model=jcfg.ModelConfig(**model),
                                      out_dir=str(tmp_path / "jax")),
                BOX, "tiny", region=jax_box(BOX, num_timesteps=96, seed=5, name="tiny"),
                make_plots=True, log_cb=lambda *a: None)
    finally:
        restore_host_routes()
    cfg = tcfg.ExperimentConfig(model=tcfg.ModelConfig(**model), out_dir=str(tmp_path / "port"))
    mc = jcfg.ExperimentConfig(model=jcfg.ModelConfig(**SMALL))
    save_checkpoint(adapted_ckpt_path(cfg.out_dir, "tiny", BOX), state_dict_from_params(params),
                    {"config": jcfg.to_dict(mc), "stats": STATS})
    got = validate.run_validation(
        cfg, BOX, "tiny", device="cpu",
        region=synthetic_region_for_box(BOX, num_timesteps=96, seed=5, name="tiny"),
        log_cb=lambda *a: None)
    assert got.model_kind == ref.model_kind == "adapted"
    np.testing.assert_allclose(got.results["average_mse"], ref.results["average_mse"],
                               rtol=1e-8)
    assert [os.path.relpath(p, cfg.out_dir) for p in got.plots] == [
        os.path.relpath(p, str(tmp_path / "jax")) for p in ref.plots] == [
        os.path.join("validation", "tiny_temperature.png"),
        os.path.join("validation", "tiny_all_variables.png")]
    assert all(os.path.getsize(p) > 0 for p in got.plots)
    assert len(closed) == 4
    for got_fig, ref_fig in zip(closed[2:], closed[:2]):
        _assert_same_figure(got_fig, ref_fig, rtol=1e-8)


@pytest.mark.parametrize("argv", [
    ["validate", "--region", "Moscow"],
    ["forecast", "--region", "Moscow", "--plots"],
    ["pipeline", "--regions", "Moscow"],
], ids=["validate", "forecast", "pipeline"])
def test_missing_matplotlib_names_no_plots(tmp_path, monkeypatch, argv):
    """Without matplotlib, a run that asks for plots raises an ImportError
    naming --no-plots before it reads any checkpoint (none exists here:
    reading one would raise FileNotFoundError) or adapts a region."""
    def no_checkpoint(*a, **kw):
        raise AssertionError("a checkpoint was read before the plots were refused")

    monkeypatch.setattr(validate, "load_checkpoint", no_checkpoint)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="--no-plots"):
        cli.main([*argv, "--device", "cpu", "-o", f"out_dir={tmp_path}"])
    assert not os.listdir(tmp_path)
