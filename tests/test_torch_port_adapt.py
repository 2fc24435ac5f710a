"""Regional adaptation and the pipeline in the port, against the JAX package,
on the CPU: the climate-aware Adam (with frozen subtrees) and its schedule
against optax and the JAX schedule, `run_adaptation` against JAX's on one
synthetic region in float64 (dropout 0, shuffle on), streamed against
unstreamed, the adapted-checkpoint path, and the CLI: adapt -> validate ->
pipeline, with its refusals and without jax.

Tolerances: float64 1e-10 on the optimizer alone, 1e-8 on the whole
adaptation (the same operations in another summation order over two
epochs), 1e-10 between two port runs that take the same steps.
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
import jax.numpy as jnp

from weatherforecast_stgcn_maml_tpu import config as jcfg
from tests._host_route import restore_host_routes, use_same_host_route
from weatherforecast_stgcn_maml_tpu.data.synthetic import synthetic_region_for_box as jax_box
from weatherforecast_stgcn_maml_tpu.engines import adapt as jax_adapt
from weatherforecast_stgcn_maml_tpu.models.registry import init_model as jax_init_model
from weatherforecast_stgcn_maml_tpu.train import optimizers as jax_opt
from weatherforecast_stgcn_maml_tpu.utils import checkpoint as jax_ckpt
from weatherforecast_stgcn_maml_tpu_torch import cli
from weatherforecast_stgcn_maml_tpu_torch import config as tcfg
from weatherforecast_stgcn_maml_tpu_torch.data.synthetic import synthetic_region_for_box
from weatherforecast_stgcn_maml_tpu_torch.engines import adapt
from weatherforecast_stgcn_maml_tpu_torch.models import hybrid as port_hybrid
from weatherforecast_stgcn_maml_tpu_torch.models.lstm import lstm_wavefront
from weatherforecast_stgcn_maml_tpu_torch.models.registry import init_model
from weatherforecast_stgcn_maml_tpu_torch.train import optimizers
from weatherforecast_stgcn_maml_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from weatherforecast_stgcn_maml_tpu_torch.utils.convert import state_dict_from_params

torch.set_num_threads(1)  # small tensors; more threads oversubscribe side-by-side workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(hidden_channels=16, gcn_layers=2, lstm_hidden=8, lstm_layers=2, window=6,
             horizon=3, koppen_dim=4)
BOX = (10.0, 11.0, 20.0, 21.0)  # 25 nodes, padded to 128


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tree(seed, scale, like):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: rng.normal(size=a.shape) * scale, like)


@pytest.mark.parametrize("region, freeze", [
    ("Moscow", {}),
    ("Thailand", {"stop_base_gradients": True}),
    ("NewYork", {"train_koppen_embedding": False}),
])
def test_adaptation_optimizer_matches_optax(region, freeze):
    """Four clip -> weight decay -> Adam updates at changing lrs, against the
    JAX chain the engine builds (masked_freeze over trainable_mask when a
    subtree is frozen); a frozen leaf must not move."""
    mc = jcfg.ModelConfig(**SMALL, **freeze)
    template = _np(jax_init_model(jax.random.key(0), mc))
    params = _tree(1, 0.3, template)
    grads = [_tree(10 + i, 0.4, template) for i in range(4)]
    lrs = [6e-4, 5e-4, 1e-3, 2e-4]
    with jax.enable_x64(True):
        tx, lr0 = jax_opt.adaptation_optimizer(region, 6e-4, 1.0)
        p = jax.tree.map(jnp.asarray, params)
        if freeze:
            tx = jax_opt.masked_freeze(tx, jax_opt.trainable_mask(p, mc))
        state = tx.init(p)
        for g, lr in zip(grads, lrs):
            u, state = tx.update(jax.tree.map(jnp.asarray, g), state, p)
            p = jax.tree.map(lambda a, b: a - lr * b, p, u)
        ref = state_dict_from_params(_np(p), np.float64)

    port_tx, port_lr0 = optimizers.adaptation_optimizer(region, 6e-4, 1.0)
    assert port_lr0 == lr0
    got = state_dict_from_params(params, np.float64)
    if freeze:
        port_tx = optimizers.masked_freeze(
            port_tx, optimizers.trainable_mask(got, tcfg.ModelConfig(**SMALL, **freeze)))
    st = port_tx.init(got)
    for g, lr in zip(grads, lrs):
        st = port_tx.update(state_dict_from_params(g, np.float64), st, got, lr)
    start = state_dict_from_params(params, np.float64)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-10, atol=1e-13, err_msg=k)
        frozen = (k.startswith("encoder") and freeze.get("stop_base_gradients")) or (
            k == "koppen" and freeze.get("train_koppen_embedding") is False)
        assert torch.equal(v, start[k]) == bool(frozen), k


def test_climate_schedule_and_zones_match_jax():
    for _, name in tcfg.ADAPTATION_REGIONS:
        assert optimizers.climate_zone(name) == jax_opt.climate_zone(name)
    losses = [1.5, 0.1, 0.5, 2.0, 0.15, 0.7, 1.2, 0.05, 0.3, 3.0, 0.1, 0.9]
    for name in ("Moscow", "Thailand", "NewYork"):
        port = optimizers.ClimateLRSchedule(name, base_lr=6e-4)
        ref = jax_opt.ClimateLRSchedule(name, base_lr=6e-4)
        assert [port.step(v) for v in losses] == [ref.step(v) for v in losses]


def _adapt_cfg(pkg, out_dir, **adapt_kw):
    return pkg.ExperimentConfig(
        model=pkg.ModelConfig(**SMALL, gcn_dropout=0.0, lstm_dropout=0.0,
                              compute_dtype="float64"),
        adapt=pkg.AdaptConfig(epochs=2, batch_size=2, max_samples=40, **adapt_kw),
        out_dir=str(out_dir),
    )


@pytest.fixture()
def meta_ckpt(tmp_path):
    """One set of float32 parameters, as a JAX and a port checkpoint."""
    use_same_host_route()
    mc = jcfg.ModelConfig(**SMALL)
    params = _np(jax_init_model(jax.random.key(3), mc))
    meta = {"epoch": 0, "config": jcfg.to_dict(jcfg.ExperimentConfig(model=mc))}
    jax_path, port_path = str(tmp_path / "jax_meta"), str(tmp_path / "port_meta")
    jax_ckpt.save_checkpoint(jax_path, {"params": params}, meta)
    save_checkpoint(port_path, state_dict_from_params(params), meta)
    yield params, jax_path, port_path
    restore_host_routes()


def test_run_adaptation_matches_jax_float64(meta_ckpt, tmp_path, monkeypatch):
    params, jax_path, port_path = meta_ckpt
    # JAX restores the checkpoint into its template's dtypes; hand it the
    # same (float32-exact) values as float64, as the port holds them.
    f64 = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    monkeypatch.setattr(jax_adapt, "load_checkpoint",
                        lambda path, like=None: ({"params": f64}, {"epoch": 0}))
    with jax.enable_x64(True):
        ref = jax_adapt.run_adaptation(
            _adapt_cfg(jcfg, tmp_path / "jax"), BOX, "tiny", meta_ckpt=jax_path,
            region=jax_box(BOX, num_timesteps=48, seed=5, name="tiny"), log_cb=lambda *a: None,
        )
        ref_params, ref_meta = jax_ckpt.load_checkpoint(ref.ckpt_path)
        ref_sd = state_dict_from_params(_np(ref_params["params"]), np.float64)

    got = adapt.run_adaptation(
        _adapt_cfg(tcfg, tmp_path / "port"), BOX, "tiny", device="cpu", meta_ckpt=port_path,
        region=synthetic_region_for_box(BOX, num_timesteps=48, seed=5, name="tiny"),
        log_cb=lambda *a: None,
    )
    tol = dict(rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(got.epoch_losses, ref.epoch_losses, **tol)
    np.testing.assert_allclose(got.val_mse, ref.val_mse, **tol)
    sd, side = load_checkpoint(got.ckpt_path)
    for k, v in sd.items():
        assert v.dtype == torch.float64
        np.testing.assert_allclose(v.numpy(), ref_sd[k].numpy(), err_msg=k, **tol)
    assert got.ckpt_path.endswith(os.path.join("adapted", "tiny_10_11_20_21"))
    for key in ("schema", "region", "region_name", "climate_zone", "koppen_code", "stats"):
        assert side[key] == ref_meta[key], key
    np.testing.assert_allclose(side["epoch_losses"], ref_meta["epoch_losses"], **tol)
    assert side["config"]["adapt"] == jcfg.to_dict(_adapt_cfg(jcfg, "x").adapt)


def test_streamed_adaptation_equals_unstreamed(meta_ckpt, tmp_path):
    """Batch 1, shuffle off: the chunks take the same windows in the same
    order as the whole tensor, so the runs agree step for step."""
    _, _, port_path = meta_ckpt
    region = synthetic_region_for_box(BOX, num_timesteps=48, seed=5, name="tiny")
    runs, logs = {}, []
    for name, steps in (("whole", 0), ("streamed", 24)):
        cfg = _adapt_cfg(tcfg, tmp_path / name, shuffle=False, max_device_timesteps=steps)
        cfg = tcfg.apply_overrides(cfg, ["adapt.batch_size=1"])
        runs[name] = adapt.run_adaptation(cfg, BOX, "tiny", device="cpu", meta_ckpt=port_path,
                                          region=region, log_cb=logs.append)
    assert any("streaming 48 timesteps" in line and "3 chunks" in line for line in logs)
    tol = dict(rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(runs["streamed"].epoch_losses, runs["whole"].epoch_losses, **tol)
    np.testing.assert_allclose(runs["streamed"].val_mse, runs["whole"].val_mse, **tol)
    a, _ = load_checkpoint(runs["whole"].ckpt_path)
    b, _ = load_checkpoint(runs["streamed"].ckpt_path)
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), err_msg=k, **tol)


@pytest.mark.parametrize("box", [(40, 45, 285, 290), (40.0, 45.0, 285.0, 290.0)])
def test_adapted_ckpt_path_canonicalizes_and_finds_legacy_spellings(tmp_path, box):
    """int (config) and float (CLI --box) coordinates map to one path, as in
    the JAX package; a checkpoint under the older tuple spelling is found."""
    out = str(tmp_path)
    canon = adapt.adapted_ckpt_path(out, "NewYork", box)
    assert canon == adapt.adapted_ckpt_path(out, "NewYork", (40, 45, 285, 290.0))
    assert canon == jax_adapt.adapted_ckpt_path(out, "NewYork", box)
    legacy = os.path.join(out, "adapted", f"NewYork_{tuple(box)}")
    os.makedirs(legacy)
    assert adapt.adapted_ckpt_path(out, "NewYork", box) == legacy
    assert jax_adapt.adapted_ckpt_path(out, "NewYork", box) == legacy
    os.makedirs(canon)
    assert adapt.adapted_ckpt_path(out, "NewYork", box) == canon


CLI_SMALL = [a for k, v in SMALL.items() for a in ("-o", f"model.{k}={v}")] + [
    "-o", "data.synthetic_timesteps=48", "-o", "adapt.epochs=1", "-o", "adapt.max_samples=20",
]


@pytest.fixture()
def base_ckpt(tmp_path):
    mc = tcfg.ModelConfig(**SMALL)
    model = init_model(torch.Generator().manual_seed(0), mc)
    save_checkpoint(str(tmp_path / "meta" / "ckpt_best"), model.state_dict(),
                    {"config": tcfg.to_dict(tcfg.ExperimentConfig(model=mc))})
    return [*CLI_SMALL, "-o", f"out_dir={tmp_path}"]


def _cli(*argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(list(argv))
    return rc, out.getvalue(), err.getvalue()


def test_cli_adapt_then_validate_then_pipeline(base_ckpt, tmp_path):
    """validate and forecast prefer the adapted checkpoint the port wrote."""
    rc, out, _ = _cli("adapt", "--region", "Moscow", "--device", "cpu", *base_ckpt)
    assert rc == 0 and "val_mse=" in out
    path = adapt.adapted_ckpt_path(str(tmp_path), "Moscow", dict(
        (n, b) for b, n in tcfg.ADAPTATION_REGIONS)["Moscow"])
    _, side = load_checkpoint(path)
    assert side["schema"] == "wfstgcn-adapted-v1" and side["climate_zone"] == "cold"
    assert np.isfinite(side["val_mse"]) and len(side["epoch_losses"]) == 1

    rc, out, err = _cli("validate", "--region", "Moscow", "--device", "cpu", "--no-plots",
                        *base_ckpt)
    assert rc == 0 and "(adapted model)" in err
    assert np.isfinite(json.loads(out)["average_mse"])
    rc, out, _ = _cli("forecast", "--region", "Moscow", "--device", "cpu", *base_ckpt)
    assert rc == 0 and "(adapted model)" in out

    # Shard 0 of 2 over three regions takes Moscow (adapted above: reused)
    # and Thailand, whose broken checkpoint fails alone; NewYork is shard 1's.
    broken = adapt.adapted_ckpt_path(str(tmp_path), "Thailand", (8, 13, 98, 103))
    os.makedirs(broken)
    with open(os.path.join(broken, "meta.json"), "w") as f:
        json.dump({}, f)
    rc, _, err = _cli("pipeline", "--regions", "Moscow;NewYork;Thailand", "--shard", "0",
                      "--num-shards", "2", "--no-plots", "--device", "cpu", *base_ckpt)
    assert rc == 1
    assert "using existing adapted model for Moscow" in err and "ERROR in Thailand" in err
    with open(tmp_path / "pipeline.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [(r["region"], r["status"]) for r in records] == [("Moscow", "ok"),
                                                             ("Thailand", "error")]
    rc, _, err = _cli("pipeline", "--regions", "NewYork", "--no-plots", "--device", "cpu",
                      *base_ckpt)
    assert rc == 0 and "[adapt:NewYork] saved" in err


# Each case keeps the id it had beside the plot refusal (argv1, now
# test_cli_pipeline_writes_plots) and the wavefront's (argv5, now
# test_cli_adapt_and_pipeline_on_the_wavefront).
@pytest.mark.parametrize("argv, error, match", [
    pytest.param(["adapt", "--region", "Moscow", "-o", "data.root=/data/era5"],
                 NotImplementedError, "ERA5", id="argv0-NotImplementedError-ERA5"),
    pytest.param(["pipeline", "--regions", "Moscow", "--shard", "1", "--no-plots"], SystemExit,
                 "BOTH", id="argv2-SystemExit-BOTH"),
    pytest.param(["pipeline", "--regions", "Atlantis", "--no-plots"], SystemExit,
                 "unknown region", id="argv3-SystemExit-unknown region"),
    pytest.param(["adapt"], SystemExit, "--region NAME", id="argv4-SystemExit---region NAME"),
])
def test_cli_pipeline_and_adapt_refusals(base_ckpt, tmp_path, argv, error, match):
    with pytest.raises(error, match=match):
        _cli(*argv, "--device", "cpu", *base_ckpt)
    assert not os.path.exists(tmp_path / "adapted")


def test_cli_adapt_and_pipeline_on_the_wavefront(base_ckpt, tmp_path, monkeypatch):
    """`adapt` and `pipeline` with `-o model.lstm_wavefront=true` run their
    train and eval forwards through the wavefront LSTM and report finite
    numbers."""
    calls = []
    monkeypatch.setattr(port_hybrid, "lstm_wavefront",
                        lambda *a, **k: calls.append(1) or lstm_wavefront(*a, **k))
    wf = ["-o", "model.lstm_wavefront=true"]
    rc, out, _ = _cli("adapt", "--region", "Moscow", "--device", "cpu", *base_ckpt, *wf)
    assert rc == 0 and calls
    assert np.isfinite(float(out.split("val_mse=")[1].split()[0]))
    calls.clear()
    rc, _, err = _cli("pipeline", "--regions", "NewYork", "--no-plots", "--device", "cpu",
                      *base_ckpt, *wf)
    assert rc == 0 and "[adapt:NewYork] saved" in err and calls


def test_cli_pipeline_writes_plots(base_ckpt, tmp_path):
    """pipeline at its defaults (no --no-plots) validates with plots."""
    rc, _, err = _cli("pipeline", "--regions", "Moscow", "--device", "cpu", *base_ckpt)
    assert rc == 0 and "[adapt:Moscow] saved" in err
    for png in ("Moscow_temperature.png", "Moscow_all_variables.png"):
        assert os.path.getsize(tmp_path / "validation" / png) > 0, png


def test_cli_adapt_and_pipeline_leave_jax_unimported(base_ckpt):
    code = (
        "import sys\n"
        "from weatherforecast_stgcn_maml_tpu_torch import cli\n"
        f"args = {base_ckpt!r}\n"
        "assert cli.main(['adapt', '--region', 'Moscow', '--device', 'cpu', *args]) == 0\n"
        "assert cli.main(['pipeline', '--regions', 'Moscow;NewYork', '--no-plots',"
        " '--device', 'cpu', *args]) == 0\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'weatherforecast_stgcn_maml_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code],
                          env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
