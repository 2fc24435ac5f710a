"""The whole serving slice: the JAX package's `run_forecast` / `run_validation`
on a JAX-written checkpoint against the port's CLI (`--device cpu`) on the
converted checkpoint, on the same synthetic region. Plus: the port runs
without jax.

Tolerance: rtol 1e-4 (float32 end to end), with atol 1e-4 on the
normalized-unit-sized values.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from weatherforecast_stgcn_maml_tpu import config as jcfg
from tests._host_route import restore_host_routes, use_same_host_route
from weatherforecast_stgcn_maml_tpu.engines.adapt import adapted_ckpt_path as jax_adapted_path
from weatherforecast_stgcn_maml_tpu.engines.forecast import run_forecast as jax_run_forecast
from weatherforecast_stgcn_maml_tpu.engines.validate import run_validation as jax_run_validation
from weatherforecast_stgcn_maml_tpu.models.registry import init_model as jax_init_model
from weatherforecast_stgcn_maml_tpu.utils import checkpoint as jax_ckpt
from weatherforecast_stgcn_maml_tpu_torch import cli
from weatherforecast_stgcn_maml_tpu_torch.engines.adapt import adapted_ckpt_path
from weatherforecast_stgcn_maml_tpu_torch.utils.checkpoint import save_checkpoint
from weatherforecast_stgcn_maml_tpu_torch.utils.convert import state_dict_from_params

torch.set_num_threads(1)  # small tensors; more threads oversubscribe side-by-side workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX = (10.0, 11.0, 20.0, 21.0)  # the tiny_region fixture's box: 25 nodes
NAME = "tiny"
SMALL = dict(hidden_channels=16, gcn_layers=2, lstm_hidden=8, lstm_layers=2, window=6,
             horizon=3, koppen_dim=4)
OVERRIDES = [a for k, v in SMALL.items() for a in ("-o", f"model.{k}={v}")]


@pytest.fixture()
def outs(tmp_path):
    """A JAX-written base and adapted checkpoint, and their conversions for
    the port (each package under its own out_dir)."""
    use_same_host_route()
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    mc = jcfg.ModelConfig(**SMALL)
    meta = {"config": jcfg.to_dict(jcfg.ExperimentConfig(model=mc))}
    stats = {"mean": list(np.linspace(-1.0, 290.0, 12)), "std": list(np.linspace(0.5, 9.0, 12))}
    ckpts = [
        (os.path.join("meta", "ckpt_best"), 0, meta),
        (os.path.relpath(jax_adapted_path(jax_out, NAME, BOX), jax_out), 1,
         {**meta, "stats": stats}),
    ]
    for rel, seed, m in ckpts:
        params = jax_init_model(jax.random.key(seed), mc)
        jax_ckpt.save_checkpoint(os.path.join(jax_out, rel), {"params": params}, m)
        arrays, saved_meta = jax_ckpt.load_checkpoint(os.path.join(jax_out, rel))
        state_dict = state_dict_from_params(jax.tree.map(np.asarray, arrays["params"]))
        save_checkpoint(os.path.join(port_out, rel), state_dict, saved_meta)
    assert os.path.isdir(adapted_ckpt_path(port_out, NAME, BOX))
    yield jax_out, port_out
    restore_host_routes()


def _port_cli(*argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(list(argv)) == 0
    return buf.getvalue()


def test_forecast_slice_matches_jax(outs, tmp_path):
    jax_out, port_out = outs
    # Only the base checkpoint: the adapted one is for validation.
    ref_cfg = jcfg.ExperimentConfig(model=jcfg.ModelConfig(**SMALL), out_dir=jax_out)
    ref = jax_run_forecast(ref_cfg, BOX, "tiny_base", log_cb=lambda *a: None)

    _port_cli("forecast", "--box", *map(str, BOX), "--name", "tiny_base", "--device", "cpu",
              "-o", f"out_dir={port_out}", *OVERRIDES)
    with open(os.path.join(port_out, "forecasts", "tiny_base.json")) as f:
        got = json.load(f)
    with open(ref.artifact_path) as f:
        want = json.load(f)
    assert got["model_kind"] == want["model_kind"] == "base"
    assert got["times"] == want["times"] and got["issued_from"] == want["issued_from"]
    np.testing.assert_allclose(
        np.asarray(got["mean_forecast"]), np.asarray(want["mean_forecast"]), rtol=1e-4, atol=1e-4
    )


def test_validate_slice_matches_jax(outs):
    jax_out, port_out = outs
    ref_cfg = jcfg.ExperimentConfig(model=jcfg.ModelConfig(**SMALL), out_dir=jax_out)
    ref = jax_run_validation(ref_cfg, BOX, NAME, make_plots=False, log_cb=lambda *a: None)
    assert ref.model_kind == "adapted"

    got = json.loads(_port_cli("validate", "--box", *map(str, BOX), "--name", NAME,
                               "--device", "cpu", "--no-plots",
                               "-o", f"out_dir={port_out}", *OVERRIDES))
    assert got.keys() == ref.results.keys()
    for var, metrics in ref.results.items():
        if isinstance(metrics, dict):
            for k in ("mse", "mae"):
                np.testing.assert_allclose(got[var][k], metrics[k], rtol=1e-4, atol=1e-6)
        else:
            np.testing.assert_allclose(got[var], metrics, rtol=1e-4)


@pytest.mark.parametrize(
    "argv, pngs",
    [
        (["validate"], [os.path.join("validation", f"{NAME}_temperature.png"),
                        os.path.join("validation", f"{NAME}_all_variables.png")]),
        (["forecast", "--plots"], [os.path.join("forecasts", f"{NAME}_forecast.png")]),
    ],
    ids=["validate", "forecast"],
)
def test_cli_plots_are_written(outs, argv, pngs):
    """validate at its defaults and forecast --plots write their figures."""
    _, port_out = outs
    _port_cli(*argv, "--box", *map(str, BOX), "--name", NAME, "--device", "cpu",
              "-o", f"out_dir={port_out}", *OVERRIDES)
    for png in pngs:
        assert os.path.getsize(os.path.join(port_out, png)) > 0, png


@pytest.mark.parametrize(
    "argv, match",
    [
        # The id the case had beside the plot refusals (now cases of
        # test_cli_plots_are_written).
        pytest.param(["forecast", "-o", "data.root=/data/era5"], "ERA5", id="argv2-ERA5"),
    ],
)
def test_unported_cli_options_raise(outs, argv, match):
    _, port_out = outs
    with pytest.raises(NotImplementedError, match=match):
        cli.main([*argv, "--box", *map(str, BOX), "--name", NAME, "--device", "cpu",
                  "-o", f"out_dir={port_out}", *OVERRIDES])


def test_cuda_device_without_card_raises(outs):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, port_out = outs
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["forecast", "--box", *map(str, BOX), "--name", NAME,
                  "-o", f"out_dir={port_out}", *OVERRIDES])


def test_port_serves_without_jax(tmp_path):
    """Importing the port and serving a CPU forecast never imports jax or
    the JAX package."""
    script = f"""
import sys, torch
from weatherforecast_stgcn_maml_tpu_torch import cli, config
from weatherforecast_stgcn_maml_tpu_torch.models.registry import init_model
from weatherforecast_stgcn_maml_tpu_torch.utils.checkpoint import save_checkpoint
mc = config.ModelConfig(**{SMALL!r})
model = init_model(torch.Generator().manual_seed(0), mc)
save_checkpoint({str(tmp_path / "meta" / "ckpt_best")!r}, model.state_dict(),
                {{"config": config.to_dict(config.ExperimentConfig(model=mc))}})
assert cli.main(["forecast", "--region", "Moscow", "--device", "cpu",
                 "-o", "out_dir={tmp_path}", *{OVERRIDES!r}]) == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "weatherforecast_stgcn_maml_tpu"))
assert not bad, bad
"""
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert (tmp_path / "forecasts" / "Moscow.json").exists()
