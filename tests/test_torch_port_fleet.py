"""The region fleet (`pipeline --mesh-fleet`) in the port, against the JAX
package and the port's serial engine, on the CPU.

The model and regions are JAX's `tests/test_fleet_mesh.py`'s (India,
Moscow, NewYork; 2 epochs, batch 4, 40 samples). In float64 at dropout 0
every region's epoch losses and validation MSE equal JAX's
`run_fleet_adaptation` (threefry keys, as its test pins) and the port's
serial `run_adaptation` at 1e-8; with dropout on the fleet equals the serial
engine (the same masks: each lane draws from its region's generator), also
with the Koppen table frozen (`model.train_koppen_embedding=false`).

Across OS processes joined by gloo (this file's `__main__` block is a rank,
OMP_NUM_THREADS=1): 3 regions of one zone on 2 ranks fill 4 lanes, and the
padding lane leaves no result, checkpoint or log.
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from weatherforecast_stgcn_maml_tpu_torch import cli  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch import config as tcfg  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.engines import adapt  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.engines.fleet_adapt import (  # noqa: E402
    run_fleet_adaptation,
)
from weatherforecast_stgcn_maml_tpu_torch.models import hybrid  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm_stack  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.parallel import distributed  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.parallel.fleet_mesh import (  # noqa: E402
    lane_block,
    pad_fleet,
)
from weatherforecast_stgcn_maml_tpu_torch.train import supervised  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_checkpoint,
    save_checkpoint,
)

torch.set_num_threads(1)  # small tensors; more threads oversubscribe side-by-side workers

MODEL = dict(hidden_channels=8, gcn_layers=2, lstm_hidden=8, lstm_layers=1, window=6,
             horizon=2, koppen_dim=4)
REGIONS = [
    ((10.0, 10.75, 20.0, 20.75), "India"),
    ((30.0, 30.75, 40.0, 40.75), "Moscow"),  # cold
    ((50.0, 50.75, 60.0, 60.75), "NewYork"),
]
# Three regions of one zone (temperate), for the padded lanes on two ranks.
TEMPERATE = [REGIONS[0], (REGIONS[1][0], "Paris"), REGIONS[2]]
TOL = dict(rtol=1e-8, atol=1e-8)


def _cfg(out_dir, dropout=0.0, **model_kw):
    model = tcfg.ModelConfig(**MODEL, gcn_dropout=dropout, lstm_dropout=dropout,
                             compute_dtype="float64", **model_kw)
    return tcfg.ExperimentConfig(
        model=model, adapt=tcfg.AdaptConfig(epochs=2, batch_size=4, max_samples=40),
        out_dir=str(out_dir))


def _seed_meta_ckpt(out_dir, state_dict=None):
    if state_dict is None:
        from weatherforecast_stgcn_maml_tpu_torch.models.registry import init_model

        state_dict = init_model(torch.Generator().manual_seed(0),
                                tcfg.ModelConfig(**MODEL)).state_dict()
    save_checkpoint(os.path.join(str(out_dir), "meta", "ckpt_best"), state_dict,
                    {"epoch": 1, "config": {"model": {"family": "hybrid"}}})


def _serial(cfg, regions):
    return [adapt.run_adaptation(cfg, box, name, device="cpu", log_cb=lambda *a: None)
            for box, name in regions]


def _close(fleet, serial, **tol):
    for f, s in zip(fleet, serial):
        assert f.region_name == s.region_name
        np.testing.assert_allclose(f.epoch_losses, s.epoch_losses, err_msg=f.region_name, **tol)
        np.testing.assert_allclose(f.val_mse, s.val_mse, err_msg=f.region_name, **tol)


# ---------------------------------------------------------------------------
# Ranks (subprocesses)
# ---------------------------------------------------------------------------


def _worker(rank, world, port, out_dir):
    import torch.distributed as dist

    from weatherforecast_stgcn_maml_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    try:
        cfg = _cfg(out_dir, dropout=0.2)
        mesh = make_mesh(cfg.mesh, torch.device("cpu"))
        res = run_fleet_adaptation(cfg, TEMPERATE, mesh=mesh, log_cb=lambda *a: None)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump([dataclasses.asdict(r) for r in res], f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the 2 ranks; the JAX reference runs meanwhile. Returns (each
    rank's results, the ranks' out_dir, JAX's results)."""
    out_dir = str(tmp_path_factory.mktemp("ranks"))
    _seed_meta_ckpt(out_dir)
    port = distributed.free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), "2",
                               str(port), out_dir], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    ref = _jax_fleet(str(tmp_path_factory.mktemp("jax")))
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-4000:]
    results = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results, out_dir, ref


def _jax_fleet(out_dir):
    """JAX's fleet in float64 at dropout 0 (threefry keys), from the port's
    meta parameters; (the port's meta state_dict, results)."""
    import jax

    from weatherforecast_stgcn_maml_tpu import config as jcfg
    from tests._host_route import restore_host_routes, use_same_host_route
    from weatherforecast_stgcn_maml_tpu.engines import fleet_adapt as jax_fleet
    from weatherforecast_stgcn_maml_tpu.models.registry import init_model as jax_init
    from weatherforecast_stgcn_maml_tpu_torch.utils.convert import state_dict_from_params

    params = jax.tree.map(np.asarray, jax_init(jax.random.key(3), jcfg.ModelConfig(**MODEL)))
    f64 = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    cfg = jcfg.ExperimentConfig(
        model=jcfg.ModelConfig(**MODEL, gcn_dropout=0.0, lstm_dropout=0.0,
                               compute_dtype="float64"),
        adapt=jcfg.AdaptConfig(epochs=2, batch_size=4, max_samples=40,
                               rng_impl="threefry2x32"),
        mesh=jcfg.MeshConfig(num_devices=1), out_dir=out_dir)
    # JAX restores the checkpoint into its template's dtypes; hand it the
    # same (float32-exact) values as float64, as the port holds them.
    # Its checkpoints are not read here (and Orbax takes seconds to import).
    saved = jax_fleet.load_checkpoint, jax_fleet.load_meta, jax_fleet.save_checkpoint
    jax_fleet.load_checkpoint = lambda path, like=None: ({"params": f64}, {"epoch": 0})
    jax_fleet.load_meta = lambda path: {}
    jax_fleet.save_checkpoint = lambda *a, **k: None
    use_same_host_route()
    try:
        with jax.enable_x64(True):
            res = jax_fleet.run_fleet_adaptation(cfg, REGIONS, log_cb=lambda *a: None)
    finally:
        jax_fleet.load_checkpoint, jax_fleet.load_meta, jax_fleet.save_checkpoint = saved
        restore_host_routes()
    return state_dict_from_params(params), res


def test_fleet_matches_jax_and_serial_float64(ranks, tmp_path):
    state_dict, ref = ranks[2]
    cfg = _cfg(tmp_path / "fleet")
    _seed_meta_ckpt(cfg.out_dir, state_dict)
    fleet = run_fleet_adaptation(cfg, REGIONS, device="cpu", log_cb=lambda *a: None)
    assert [r.region_name for r in fleet] == [n for _, n in REGIONS]
    _close(fleet, ref, **TOL)
    serial_cfg = _cfg(tmp_path / "serial")
    _seed_meta_ckpt(serial_cfg.out_dir, state_dict)
    _close(fleet, _serial(serial_cfg, REGIONS), **TOL)
    for res, (box, name) in zip(fleet, REGIONS):
        sd, side = load_checkpoint(res.ckpt_path)
        assert res.ckpt_path == adapt.adapted_ckpt_path(cfg.out_dir, name, box)
        assert side["fleet_mesh"] is True and side["schema"] == "wfstgcn-adapted-v1"
        assert side["val_mse"] == res.val_mse and side["epoch_losses"] == res.epoch_losses
        assert all(v.dtype == torch.float64 for v in sd.values())
        with open(os.path.join(cfg.out_dir, "adapt", f"{name}.jsonl")) as f:
            assert [json.loads(line)["loss"] for line in f] == res.epoch_losses


def test_fleet_equals_serial_with_dropout(tmp_path):
    """Dropout on (0.2): each lane draws its region's masks, as the serial
    engine does, and the two agree to the last bits."""
    fleet_cfg, serial_cfg = _cfg(tmp_path / "fleet", 0.2), _cfg(tmp_path / "serial", 0.2)
    for c in (fleet_cfg, serial_cfg):
        _seed_meta_ckpt(c.out_dir)
    fleet = run_fleet_adaptation(fleet_cfg, REGIONS, device="cpu", log_cb=lambda *a: None)
    _close(fleet, _serial(serial_cfg, REGIONS), rtol=1e-12, atol=1e-12)


def test_fleet_keeps_the_koppen_table_frozen(tmp_path):
    """`model.train_koppen_embedding=false`, float64, dropout on: the fleet
    equals the serial engine (1e-12), both leave the Koppen table bitwise as
    the meta checkpoint holds it, and the rest of the model trains. (The
    JAX package's fleet trains the table here, and its serial engine does
    not; the port keeps the serial semantics.)"""
    fleet_cfg, serial_cfg = (_cfg(tmp_path / name, 0.2, train_koppen_embedding=False)
                             for name in ("fleet", "serial"))
    for c in (fleet_cfg, serial_cfg):
        _seed_meta_ckpt(c.out_dir)
    start, _ = load_checkpoint(os.path.join(fleet_cfg.out_dir, "meta", "ckpt_best"))
    fleet = run_fleet_adaptation(fleet_cfg, REGIONS, device="cpu", log_cb=lambda *a: None)
    serial = _serial(serial_cfg, REGIONS)
    _close(fleet, serial, rtol=1e-12, atol=1e-12)
    for res in (*fleet, *serial):
        sd, _ = load_checkpoint(res.ckpt_path)
        torch.testing.assert_close(sd["koppen"], start["koppen"].double(), rtol=0, atol=0)
        assert not torch.equal(sd["head.w"], start["head.w"].double()), res.region_name


@pytest.fixture()
def counted_tasks(monkeypatch):
    calls = []
    real = hybrid.apply_hybrid_tasks

    def counted(params, a_hat, x, *args, **kwargs):
        calls.append(tuple(x.shape[:2]))
        return real(params, a_hat, x, *args, **kwargs)

    monkeypatch.setattr(supervised, "apply_hybrid_tasks", counted)
    return calls


@pytest.mark.parametrize("planned", [True, False], ids=["region-batched", "fallback"])
def test_vbatch_route_equals_default(tmp_path, monkeypatch, counted_tasks, planned):
    """Under `_VBATCH` (dropout on, two LSTM layers) the regions of a zone
    run as one task-batched forward a step (`lstm_kernel="xla"`: the plain
    version of rows 16-17; B windows a task) and match the default route;
    where no cluster plan holds the regions' rows (`stack_planned` False,
    `lstm_kernel="auto"`), they run in turn and each step is counted."""
    kernel = "xla" if planned else "auto"
    runs = {}
    for vbatch in (False, True):
        cfg = _cfg(tmp_path / str(vbatch), 0.2, lstm_kernel=kernel)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, lstm_layers=2))
        _seed_meta_ckpt(cfg.out_dir, _two_layer_state())
        monkeypatch.setattr(fused_lstm_stack, "_VBATCH", vbatch)
        monkeypatch.setattr(fused_lstm_stack, "stack_planned", lambda *a, **k: planned)
        before = supervised.make_region_train_step.serial_fallbacks
        runs[vbatch] = run_fleet_adaptation(cfg, REGIONS, device="cpu", log_cb=lambda *a: None)
        fallbacks = supervised.make_region_train_step.serial_fallbacks - before
    steps = 2 * 8  # 2 epochs of 8 batches, a zone group each
    if planned:
        assert counted_tasks == [(2, 4)] * steps + [(1, 4)] * steps and fallbacks == 0
    else:
        assert counted_tasks == [] and fallbacks == 2 * steps
    _close(runs[True], runs[False], rtol=1e-12, atol=1e-12)


def _two_layer_state():
    from weatherforecast_stgcn_maml_tpu_torch.models.registry import init_model

    return init_model(torch.Generator().manual_seed(1),
                      tcfg.ModelConfig(**dict(MODEL, lstm_layers=2))).state_dict()


def test_two_ranks_pad_lanes_and_drop_the_pad(ranks, tmp_path):
    """3 regions on 2 ranks: 4 lanes, rank 1 holding NewYork and a copy of
    India; both ranks return the 3 real results, equal to the serial
    engine's, and the padding lane writes nothing."""
    results, out_dir, _ = ranks
    assert pad_fleet(3, _FakeMesh(2, 0)) == 4
    assert [list(lane_block(4, _FakeMesh(2, r))) for r in range(2)] == [[0, 1], [2, 3]]
    assert results[0] == results[1]
    assert [r["region_name"] for r in results[0]] == [n for _, n in TEMPERATE]
    serial_cfg = _cfg(tmp_path, dropout=0.2)
    _seed_meta_ckpt(serial_cfg.out_dir)
    serial = _serial(serial_cfg, TEMPERATE)
    for got, want in zip(results[0], serial):
        np.testing.assert_allclose(got["epoch_losses"], want.epoch_losses, rtol=1e-12)
        np.testing.assert_allclose(got["val_mse"], want.val_mse, rtol=1e-12)
    assert sorted(os.listdir(os.path.join(out_dir, "adapted"))) == sorted(
        os.path.basename(r["ckpt_path"]) for r in results[0])
    assert sorted(os.listdir(os.path.join(out_dir, "adapt"))) == sorted(
        f"{n}.jsonl" for _, n in TEMPERATE)
    for _, name in TEMPERATE:
        with open(os.path.join(out_dir, "adapt", f"{name}.jsonl")) as f:
            assert len(f.readlines()) == 2, name  # written once: 2 epochs


@dataclasses.dataclass
class _FakeMesh:
    dp: int
    dp_index: int

    @property
    def size(self):
        return self.dp


def test_fleet_refuses_streaming(tmp_path):
    cfg = _cfg(tmp_path)
    cfg = dataclasses.replace(cfg, adapt=dataclasses.replace(cfg.adapt, max_device_timesteps=32))
    _seed_meta_ckpt(cfg.out_dir)
    with pytest.raises(ValueError, match="streaming"):
        run_fleet_adaptation(cfg, REGIONS[:1], device="cpu", log_cb=lambda *a: None)


def test_pipeline_mesh_fleet_end_to_end(tmp_path):
    """`pipeline --mesh-fleet --device cpu` fleet-adapts the pending regions
    (Moscow already adapted: reused), then validates each one."""
    overrides = [a for k, v in MODEL.items() for a in ("-o", f"model.{k}={v}")] + [
        "-o", "adapt.epochs=1", "-o", "adapt.max_samples=20", "-o", f"out_dir={tmp_path}",
        "-o", "data.synthetic_timesteps=48"]
    _seed_meta_ckpt(tmp_path)
    moscow = dict((n, b) for b, n in tcfg.ADAPTATION_REGIONS)["Moscow"]
    assert cli.main(["adapt", "--region", "Moscow", "--device", "cpu", *overrides]) == 0
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["pipeline", "--regions", "Moscow;NewYork;Thailand", "--mesh-fleet",
                       "--no-plots", "--device", "cpu", *overrides])
    lines = err.getvalue()
    assert rc == 0, lines[-3000:]
    assert "[pipeline] fleet-adapted 2 regions" in lines and "fleet adaptation failed" not in lines
    assert "using existing adapted model for Moscow" in lines
    for name in ("NewYork", "Thailand"):
        box = dict((n, b) for b, n in tcfg.ADAPTATION_REGIONS)[name]
        _, side = load_checkpoint(adapt.adapted_ckpt_path(str(tmp_path), name, box))
        assert side["fleet_mesh"] is True and np.isfinite(side["val_mse"])
    _, side = load_checkpoint(adapt.adapted_ckpt_path(str(tmp_path), "Moscow", moscow))
    assert "fleet_mesh" not in side
    with open(tmp_path / "pipeline.jsonl") as f:
        assert [json.loads(line)["status"] for line in f] == ["ok"] * 3


def test_pipeline_falls_back_to_serial_when_the_fleet_fails(tmp_path):
    """A fleet refusal (streaming) is logged and the regions adapt serially."""
    overrides = [a for k, v in MODEL.items() for a in ("-o", f"model.{k}={v}")] + [
        "-o", "adapt.epochs=1", "-o", "adapt.max_samples=20", "-o", f"out_dir={tmp_path}",
        "-o", "data.synthetic_timesteps=48", "-o", "adapt.max_device_timesteps=40"]
    _seed_meta_ckpt(tmp_path)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["pipeline", "--regions", "NewYork", "--mesh-fleet", "--no-plots",
                       "--device", "cpu", *overrides])
    assert rc == 0
    assert "fleet adaptation failed (ValueError: " in err.getvalue()
    assert "[adapt:NewYork] saved" in err.getvalue()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
