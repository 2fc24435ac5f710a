"""The port's meta-training engine and `cli meta-train`, on the CPU.

`run_meta_training(device="cpu")` against the JAX package's engine on the
same synthetic regions and initial parameters (float32, dropout 0): the
same task indices every epoch and meta losses within rtol 1e-4 (float32
summation order over three epochs of inner loops), epoch by epoch and in
chunks of `meta.epochs_per_dispatch` = 2 and 3 (the same checkpoints
written, their parameters within rtol 1e-4, atol 2e-4). Then port-only
checks:
a resumed run equals a straight one (dropout on), the CLI trains, writes its
checkpoints and logs, serves a forecast from `ckpt_best`, leaves jax
unimported, and refuses what it does not run.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from weatherforecast_stgcn_maml_tpu import config as jcfg
from weatherforecast_stgcn_maml_tpu.data.synthetic import synthetic_region_for_box as jax_box
from weatherforecast_stgcn_maml_tpu.engines.meta_train import (
    run_meta_training as jax_run_meta_training,
)
from weatherforecast_stgcn_maml_tpu.train.maml import init_meta_state as jax_init_meta_state
from weatherforecast_stgcn_maml_tpu.utils import checkpoint as jax_ckpt
from weatherforecast_stgcn_maml_tpu_torch import cli
from weatherforecast_stgcn_maml_tpu_torch import config as tcfg
from weatherforecast_stgcn_maml_tpu_torch.data.synthetic import synthetic_region_for_box
from weatherforecast_stgcn_maml_tpu_torch.engines import meta_train
from weatherforecast_stgcn_maml_tpu_torch.train import maml
from weatherforecast_stgcn_maml_tpu_torch.utils.checkpoint import load_checkpoint
from weatherforecast_stgcn_maml_tpu_torch.utils.convert import state_dict_from_params

torch.set_num_threads(1)  # small tensors; more threads oversubscribe side-by-side workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(hidden_channels=16, gcn_layers=2, lstm_hidden=8, lstm_layers=2, window=6,
             horizon=3, koppen_dim=4)
SMALL_OVERRIDES = [f"model.{k}={v}" for k, v in SMALL.items()] + [
    "meta.inner_epochs=1", "meta.inner_batches=2", "data.synthetic_timesteps=40",
]


def _cfg(pkg, out_dir, **meta):
    overrides = SMALL_OVERRIDES + [f"out_dir={out_dir}"] + [
        f"meta.{k}={v}" for k, v in meta.items()]
    return pkg.apply_overrides(pkg.ExperimentConfig(), overrides)


def _boxes():
    return [(10.0 + 2 * i, 11.0 + 2 * i, 20.0, 21.0) for i in range(3)]


def _log(out_dir):
    with open(os.path.join(out_dir, "meta", "meta_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _run_both(tmp_path, monkeypatch, **meta):
    """The JAX engine and the port's on the same regions and initial
    parameters, dropout 0: (the port's log, JAX's log, the port's lines)."""
    drop = ["model.gcn_dropout=0", "model.lstm_dropout=0"]
    jax_cfg = jcfg.apply_overrides(_cfg(jcfg, tmp_path / "jax", **meta), drop)
    port_cfg = tcfg.apply_overrides(_cfg(tcfg, tmp_path / "port", **meta), drop)
    jax_run_meta_training(
        jax_cfg, [jax_box(b, num_timesteps=40, seed=i) for i, b in enumerate(_boxes())],
        log_cb=lambda *a: None,
    )
    # The port starts from the JAX package's initial parameters.
    init = jax_init_meta_state(jax.random.key(jax_cfg.meta.seed), jax_cfg.model, jax_cfg.meta)
    state_dict = state_dict_from_params(jax.tree.map(np.asarray, init.params))
    make_state = meta_train.init_meta_state

    def from_jax(generator, model_cfg, meta_cfg, *, device):
        state = make_state(generator, model_cfg, meta_cfg, device=device)
        state.params.load_state_dict(state_dict)
        return state

    monkeypatch.setattr(meta_train, "init_meta_state", from_jax)
    lines = []
    meta_train.run_meta_training(
        port_cfg, [synthetic_region_for_box(b, num_timesteps=40, seed=i)
                   for i, b in enumerate(_boxes())],
        device="cpu", log_cb=lines.append,
    )
    return _log(tmp_path / "port"), _log(tmp_path / "jax"), lines


def test_engine_matches_jax(tmp_path, monkeypatch):
    got, ref, _ = _run_both(tmp_path, monkeypatch, num_epochs=3, meta_batch=2, grad_accum=2)
    assert [r["task_indices"] for r in got] == [r["task_indices"] for r in ref]
    np.testing.assert_allclose([r["meta_loss"] for r in got], [r["meta_loss"] for r in ref],
                               rtol=1e-4)
    np.testing.assert_allclose([r["learning_rate"] for r in got],
                               [r["learning_rate"] for r in ref], rtol=1e-6)
    for name in ("ckpt_best", "ckpt_last", "ckpt_final"):
        _, side = load_checkpoint(str(tmp_path / "port" / "meta" / name))
        assert side["schema"] == "wfstgcn-meta-v1" and len(side["task_names"]) == 3


@pytest.mark.parametrize("k", [2, 3])
def test_chained_engine_matches_jax(tmp_path, monkeypatch, k):
    """Three epochs in chunks of k (k = 2: a chunk of 2, then the remainder
    one epoch at a time; k = 3: one chunk), `checkpoint_every` 2: the same
    task indices (the chunk's batches sampled before the sampler sees its
    losses), losses and chunk marks in the log, one log line a chunk, and
    the same checkpoints written (sidecar epoch, step and loss; parameters
    within rtol 1e-4, atol 2e-4: Adam's update m / (sqrt(v) + eps) is
    scale-free, so where an element's float32 gradient is near rounding
    noise the two packages' summation orders move it by a fraction of one
    step of lr 1e-3) as the JAX package's engine."""
    fetches = maml.fetch_metrics.fetches
    got, ref, lines = _run_both(tmp_path, monkeypatch, num_epochs=3, meta_batch=2,
                                grad_accum=2, epochs_per_dispatch=k, checkpoint_every=2)
    chunks = [k, 1] if k == 2 else [3]
    assert maml.fetch_metrics.fetches - fetches == len(chunks)
    assert sum(f"{k} epochs/dispatch" in line for line in lines) == 1
    assert sum("] epoch " in line for line in lines) == len(chunks)
    for key in ("task_indices", "dispatch_epochs"):
        assert [r.get(key) for r in got] == [r.get(key) for r in ref], key
    assert [r.get("dispatch_epochs") for r in got][:k] == [k] * k
    np.testing.assert_allclose([r["meta_loss"] for r in got], [r["meta_loss"] for r in ref],
                               rtol=1e-4)
    assert sorted(os.listdir(tmp_path / "port" / "meta")) == sorted(
        os.listdir(tmp_path / "jax" / "meta"))
    for name in ("ckpt_best", "ckpt_last", "ckpt_final"):
        params, side = load_checkpoint(str(tmp_path / "port" / "meta" / name))
        arrays, ref_side = jax_ckpt.load_checkpoint(str(tmp_path / "jax" / "meta" / name))
        assert (side["epoch"], side["step"]) == (ref_side["epoch"], ref_side["step"]), name
        np.testing.assert_allclose(side["meta_loss"], ref_side["meta_loss"], rtol=1e-4)
        ref_sd = state_dict_from_params(jax.tree.map(np.asarray, arrays["params"]))
        for key, v in params.items():
            np.testing.assert_allclose(v.numpy(), ref_sd[key].numpy(), rtol=1e-4, atol=2e-4,
                                       err_msg=f"{name} {key}")


def test_resume_equals_a_straight_run(tmp_path):
    """Dropout on: the per-epoch generator makes a resumed run draw what a
    straight run draws."""
    regions = [synthetic_region_for_box(b, num_timesteps=40, seed=i)
               for i, b in enumerate(_boxes())]
    kw = dict(meta_batch=2, grad_accum=2)
    meta_train.run_meta_training(_cfg(tcfg, tmp_path / "a", num_epochs=3, **kw), regions,
                                 device="cpu", log_cb=lambda *a: None)
    meta_train.run_meta_training(_cfg(tcfg, tmp_path / "b", num_epochs=2, **kw), regions,
                                 device="cpu", log_cb=lambda *a: None)
    res = meta_train.run_meta_training(_cfg(tcfg, tmp_path / "b", num_epochs=3, **kw), regions,
                                       device="cpu", resume=True, log_cb=lambda *a: None)
    assert res.epochs_run == 1
    straight, resumed = _log(tmp_path / "a"), _log(tmp_path / "b")
    for key in ("meta_loss", "task_indices", "per_task_loss"):
        assert [r[key] for r in resumed] == [r[key] for r in straight], key
    a, _ = load_checkpoint(str(tmp_path / "a" / "meta" / "ckpt_final"))
    b, _ = load_checkpoint(str(tmp_path / "b" / "meta" / "ckpt_final"))
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_cli_meta_train_then_forecast(tmp_path, capsys):
    args = [a for o in SMALL_OVERRIDES for a in ("-o", o)] + [
        "-o", f"out_dir={tmp_path}", "-o", "meta.num_epochs=2"]
    assert cli.main(["meta-train", "--device", "cpu", *args]) == 0
    assert "best_loss=" in capsys.readouterr().out
    meta_dir = tmp_path / "meta"
    assert {"ckpt_best", "ckpt_last", "ckpt_final", "meta_log.csv", "meta_log.jsonl"} <= set(
        os.listdir(meta_dir))
    assert len(open(meta_dir / "meta_log.csv").read().splitlines()) == 3
    assert cli.main(["forecast", "--region", "Moscow", "--device", "cpu", *args]) == 0
    with open(tmp_path / "forecasts" / "Moscow.json") as f:
        forecast = json.load(f)
    assert forecast["model_kind"] == "base"
    assert np.isfinite(forecast["mean_forecast"]).all()


def test_cli_meta_train_leaves_jax_unimported(tmp_path):
    code = (
        "import sys\n"
        "from weatherforecast_stgcn_maml_tpu_torch import cli\n"
        f"args = {[a for o in SMALL_OVERRIDES for a in ('-o', o)]!r}\n"
        f"rc = cli.main(['meta-train', '--mesh', '--device', 'cpu', '-o', 'out_dir={tmp_path}',"
        " '-o', 'meta.num_epochs=1', *args])\n"
        "assert rc == 0\n"
        "pkg = 'weatherforecast_stgcn_maml_tpu_torch.'\n"
        "for m in ('parallel.distributed', 'parallel.meta_sp', 'ops.fused_gcn_shard'):\n"
        "    assert pkg + m in sys.modules, m\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'jaxlib', "
        "'weatherforecast_stgcn_maml_tpu.')) for m in sys.modules), 'jax imported'\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_cli_meta_train_needs_a_card_or_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["meta-train", "-o", f"out_dir={tmp_path}"])


@pytest.mark.parametrize("override", ["mesh.num_devices=2", "mesh.spatial_devices=2"])
def test_meta_train_refuses_a_mesh(tmp_path, override):
    """`meta-train --mesh` in one process forms a process group of one
    rank: a mesh of two devices, or an sp axis of two, does not fit it (the
    JAX package's make_mesh refusals), and the group is gone afterwards."""
    import torch.distributed as dist

    args = [a for o in SMALL_OVERRIDES + [override, f"out_dir={tmp_path}"] for a in ("-o", o)]
    with pytest.raises(ValueError, match="devices"):
        cli.main(["meta-train", "--mesh", "--device", "cpu", *args])
    assert not dist.is_initialized()
