"""Checkpoint interop, `data-report`, `python -m` and the profiling helpers in
the port, against the JAX package, on the CPU.

A reference-schema `.pt` (the reference's key layout, with a real
`torch.nn.LSTM` state dict: split biases, nonzero `bias_hh`) imports to the
same parameters, config, stats and meta in both packages; export writes the
same tensors; the CLI's `import-checkpoint` then `forecast` gives JAX's
forecast; `data-report` prints JAX's lines.

Tolerances: parameters and exported tensors bitwise; the imported model's
float32 forecast 1e-5; the report's text equal.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from argparse import Namespace

import numpy as np
import pytest
import torch

from weatherforecast_stgcn_maml_tpu import cli as jax_cli
from weatherforecast_stgcn_maml_tpu import config as jcfg
from tests._host_route import restore_host_routes, use_same_host_route
from weatherforecast_stgcn_maml_tpu.data import region as jax_region
from weatherforecast_stgcn_maml_tpu.engines import data_source as jax_data_source
from weatherforecast_stgcn_maml_tpu.utils import profiling as jax_profiling
from weatherforecast_stgcn_maml_tpu.utils import torch_export as jax_export
from weatherforecast_stgcn_maml_tpu.utils import torch_import as jax_import
from weatherforecast_stgcn_maml_tpu_torch import cli
from weatherforecast_stgcn_maml_tpu_torch import config as tcfg
from weatherforecast_stgcn_maml_tpu_torch.data import region as port_region
from weatherforecast_stgcn_maml_tpu_torch.data.synthetic import synthetic_region_for_box
from weatherforecast_stgcn_maml_tpu_torch.engines import data_source as port_data_source
from weatherforecast_stgcn_maml_tpu_torch.engines import meta_train
from weatherforecast_stgcn_maml_tpu_torch.utils import profiling, torch_export, torch_import
from weatherforecast_stgcn_maml_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(1)  # small tensors; more threads oversubscribe side-by-side workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(hidden_channels=16, gcn_layers=2, lstm_hidden=8, lstm_layers=2, window=6,
             horizon=3, koppen_dim=4)
OVERRIDES = [a for k, v in SMALL.items() for a in ("-o", f"model.{k}={v}")]
BOX = (10.0, 11.0, 20.0, 21.0)  # 25 nodes, padded to 128
STATS = {"mean": np.linspace(-1.0, 290.0, 12), "std": np.linspace(0.5, 9.0, 12)}


def _reference_ckpt(cfg, seed=0, adapted=False):
    """A checkpoint in the reference's schema: GCNConv-style linear weights,
    a real torch.nn.LSTM state dict (split biases), the output head, the
    Koppen embedding; adapted: with the region's stats."""
    torch.manual_seed(seed)
    hybrid, d_in = {}, cfg.in_channels
    for i in range(1, cfg.gcn_layers + 1):
        hybrid[f"base_stgcn.conv{i}.lin.weight"] = torch.randn(cfg.hidden_channels, d_in)
        hybrid[f"base_stgcn.conv{i}.bias"] = torch.randn(cfg.hidden_channels)
        d_in = cfg.hidden_channels
    hybrid["base_stgcn.output_layer.weight"] = torch.randn(12 * cfg.horizon, cfg.hidden_channels)
    hybrid["base_stgcn.output_layer.bias"] = torch.randn(12 * cfg.horizon)
    lstm = torch.nn.LSTM(cfg.hidden_channels, cfg.lstm_hidden, num_layers=cfg.lstm_layers,
                         batch_first=True)
    for k, v in lstm.state_dict().items():
        hybrid[f"lstm.{k}"] = v
    assert float(hybrid["lstm.bias_hh_l0"].abs().max()) > 0
    hybrid["output_layer.weight"] = torch.randn(12 * cfg.horizon, cfg.lstm_hidden)
    hybrid["output_layer.bias"] = torch.randn(12 * cfg.horizon)
    ckpt = {
        "hybrid_model_state_dict": hybrid,
        "koppen_embed_state_dict": {
            "embedding.weight": torch.randn(cfg.koppen_classes, cfg.koppen_dim)},
        "config": {"input_channels": cfg.in_channels, "hidden_channels": cfg.hidden_channels,
                   "output_channels": 12, "window_size": cfg.window,
                   "forecast_horizon": cfg.horizon},
        "hybrid_config": {"lstm_hidden_size": cfg.lstm_hidden,
                          "lstm_num_layers": cfg.lstm_layers, "lstm_dropout": 0.2},
        "model_version": "5.0",
        "epoch": 17,
    }
    if adapted:
        ckpt.update(stats=dict(STATS), region_name="tiny", val_loss=0.25)
    return ckpt


def _flat(tree, prefix=""):
    """The JAX parameter tree's leaves under the port's state_dict names."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}."))
    return out


def _save(tmp_path, ckpt, name="ref.pt"):
    path = str(tmp_path / name)
    torch.save(ckpt, path)
    return path


@pytest.mark.parametrize("arch, adapted", [
    (SMALL, False), (SMALL, True), (dict(SMALL, gcn_layers=3, lstm_layers=3), False),
], ids=["meta", "adapted", "gcn3-lstm3"])
def test_import_matches_jax(tmp_path, arch, adapted):
    """Parameters leaf for leaf (split biases kept), ModelConfig (the layer
    counts inferred from the tensors), NormStats and meta."""
    path = _save(tmp_path, _reference_ckpt(jcfg.ModelConfig(**arch), adapted=adapted))
    params, cfg, stats, meta = torch_import.import_torch_checkpoint(path)
    ref_params, ref_cfg, ref_stats, ref_meta = jax_import.import_torch_checkpoint(path)
    ref = _flat(ref_params)
    assert sorted(params) == sorted(ref)
    assert "lstm.layers.1.b_hh" in params and "lstm.layers.1.b" not in params
    for k, v in params.items():
        assert v.dtype == torch.float32 and v.is_contiguous(), k
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)
    assert tcfg.to_dict(cfg) == jcfg.to_dict(ref_cfg)
    assert (cfg.gcn_layers, cfg.lstm_layers) == (arch["gcn_layers"], arch["lstm_layers"])
    assert meta == ref_meta
    if adapted:
        np.testing.assert_array_equal(stats.mean, ref_stats.mean)
        np.testing.assert_array_equal(stats.std, ref_stats.std)
    else:
        assert stats is None and ref_stats is None


def test_safe_load_refuses_pickled_objects(tmp_path):
    """A checkpoint holding an arbitrary object: the weights-only load
    refuses it, in both packages; --allow-unsafe-pickle imports it."""
    ckpt = _reference_ckpt(jcfg.ModelConfig(**SMALL))
    ckpt["args"] = Namespace(lr=1e-3)
    path = _save(tmp_path, ckpt)
    for mod in (torch_import, jax_import):
        with pytest.raises(RuntimeError, match="allow_unsafe_pickle"):
            mod.import_torch_checkpoint(path)
    out = str(tmp_path / "imported")
    with pytest.raises(RuntimeError, match="weights_only"):
        _cli("import-checkpoint", path, "--out", out)
    rc, text, _ = _cli("import-checkpoint", path, "--out", out, "--allow-unsafe-pickle")
    assert rc == 0 and f"-> {out}" in text
    sd, side = load_checkpoint(out)
    assert side["schema"] == "wfstgcn-meta-v1" and side["epoch"] == 17 and "lstm.layers.0.b_ih" in sd


def test_safe_load_takes_stats_pickled_by_either_numpy(tmp_path):
    """numpy 2 pickles an array's rebuild as numpy._core.multiarray, numpy 1
    as numpy.core.multiarray: an adapted checkpoint's stats load under
    either name."""
    import zipfile

    path = _save(tmp_path, _reference_ckpt(jcfg.ModelConfig(**SMALL), adapted=True))
    with zipfile.ZipFile(path) as z:
        entries = {n: z.read(n) for n in z.namelist()}
    pkl = next(n for n in entries if n.endswith("data.pkl"))
    for old, new in ((b"cnumpy._core.multiarray\n", b"cnumpy.core.multiarray\n"),
                     (b"cnumpy.core.multiarray\n", b"cnumpy._core.multiarray\n")):
        if old in entries[pkl]:
            entries[pkl] = entries[pkl].replace(old, new)
            break
    else:
        raise AssertionError("no numpy global in the pickle")
    other = str(tmp_path / "other_numpy.pt")
    with zipfile.ZipFile(other, "w", zipfile.ZIP_STORED) as z:
        for n, data in entries.items():
            z.writestr(n, data)
    _, _, stats, meta = torch_import.import_torch_checkpoint(other)
    np.testing.assert_array_equal(stats.mean, STATS["mean"].astype(np.float32))
    assert meta["region_name"] == "tiny"


def _cli(*argv, main=None):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = (main or cli.main)(list(argv))
    return rc, out.getvalue(), err.getvalue()


def test_export_matches_jax(tmp_path):
    """From the same imported parameters both packages write the same state
    dicts (every tensor bitwise) and the same fields, `exported_by` aside."""
    path = _save(tmp_path, _reference_ckpt(jcfg.ModelConfig(**SMALL), adapted=True))
    params, cfg, stats, _ = torch_import.import_torch_checkpoint(path)
    ref_params, ref_cfg, ref_stats, _ = jax_import.import_torch_checkpoint(path)
    kw = dict(region=(40, 45, 285, 290), region_name="NewYork", extra_meta={"val_mse": 0.5})
    got = torch.load(torch_export.export_torch_checkpoint(
        str(tmp_path / "port.pt"), params, cfg, stats=stats, **kw), weights_only=False)
    want = torch.load(jax_export.export_torch_checkpoint(
        str(tmp_path / "jax.pt"), ref_params, ref_cfg, stats=ref_stats, **kw), weights_only=False)
    assert got.keys() == want.keys()
    for sd in ("hybrid_model_state_dict", "koppen_embed_state_dict"):
        assert list(got[sd]) == list(want[sd])
        for k, v in got[sd].items():
            assert v.dtype == want[sd][k].dtype and torch.equal(v, want[sd][k]), k
    for k in got:
        if k == "stats":
            for s in ("mean", "std"):
                np.testing.assert_array_equal(got[k][s], want[k][s])
                assert got[k][s].dtype == want[k][s].dtype
        elif k == "exported_by":
            assert got[k] == torch_export.EXPORTED_BY != want[k]
        elif "state_dict" not in k:
            assert got[k] == want[k], k


def test_export_import_roundtrip_and_fused_bias(tmp_path):
    """export -> import is the identity on split biases; a fused bias b
    exports as bias_ih = b, bias_hh = 0."""
    path = _save(tmp_path, _reference_ckpt(jcfg.ModelConfig(**SMALL)))
    params, cfg, _, _ = torch_import.import_torch_checkpoint(path)
    out = torch_export.export_torch_checkpoint(str(tmp_path / "again.pt"), params, cfg)
    again, cfg2, _, _ = torch_import.import_torch_checkpoint(out)
    assert cfg2 == cfg and sorted(again) == sorted(params)
    for k in params:
        assert torch.equal(again[k], params[k]), k
    fused = {k: v for k, v in params.items() if not k.endswith(("b_ih", "b_hh"))}
    for l in range(cfg.lstm_layers):
        fused[f"lstm.layers.{l}.b"] = params[f"lstm.layers.{l}.b_ih"] + params[f"lstm.layers.{l}.b_hh"]
    hybrid, _ = torch_export.state_dicts_from_params(fused, cfg)
    for l in range(cfg.lstm_layers):
        assert torch.equal(hybrid[f"lstm.bias_ih_l{l}"], fused[f"lstm.layers.{l}.b"])
        assert not hybrid[f"lstm.bias_hh_l{l}"].any()
    assert not hybrid["base_stgcn.output_layer.weight"].any()


@pytest.fixture()
def same_host_route():
    use_same_host_route()
    yield
    restore_host_routes()


@pytest.mark.parametrize("adapted", [False, True], ids=["meta", "adapted"])
def test_cli_import_then_forecast_matches_jax(tmp_path, same_host_route, adapted):
    """`import-checkpoint` then `forecast --device cpu`, against the JAX
    CLI's, float32; the adapted form imports under the region's name with
    its stats. Then `export-checkpoint` of what was imported gives back the
    reference tensors."""
    ckpt = _reference_ckpt(jcfg.ModelConfig(**SMALL), seed=3, adapted=adapted)
    path = _save(tmp_path, ckpt)
    region = ["--box", *map(str, BOX), "--name", "tiny"]
    where = region if adapted else []
    runs = {}
    for pkg, main, extra in (("jax", jax_cli.main, []), ("port", cli.main, ["--device", "cpu"])):
        out_dir = str(tmp_path / pkg)
        rc, text, _ = _cli("import-checkpoint", path, *where, "-o", f"out_dir={out_dir}",
                           main=main)
        assert rc == 0 and text.startswith(f"imported {path} -> "), text
        rc, _, _ = _cli("forecast", *region, *extra, "-o", f"out_dir={out_dir}", *OVERRIDES,
                        main=main)
        assert rc == 0
        with open(os.path.join(out_dir, "forecasts", "tiny.json")) as f:
            runs[pkg] = json.load(f)
    assert runs["port"]["model_kind"] == runs["jax"]["model_kind"] == (
        "adapted" if adapted else "base")
    np.testing.assert_allclose(np.asarray(runs["port"]["mean_forecast"]),
                               np.asarray(runs["jax"]["mean_forecast"]), rtol=1e-5, atol=1e-5)
    out_pt = str(tmp_path / "exported.pt")
    rc, text, _ = _cli("export-checkpoint", *where, "--out", out_pt,
                       "-o", f"out_dir={tmp_path / 'port'}")
    assert rc == 0 and text.strip().endswith(f"-> {out_pt}")
    back = torch.load(out_pt, weights_only=False)
    for k, v in ckpt["hybrid_model_state_dict"].items():
        if not k.startswith("base_stgcn.output_layer"):
            assert torch.equal(back["hybrid_model_state_dict"][k], v), k
    assert back["exported_by"] == torch_export.EXPORTED_BY
    if adapted:
        assert back["region_name"] == "tiny" and list(back["region"]) == list(BOX)
        np.testing.assert_array_equal(back["stats"]["mean"], STATS["mean"].astype(np.float32))


def test_export_refuses_stgcn(tmp_path):
    from weatherforecast_stgcn_maml_tpu_torch.models.registry import init_model
    from weatherforecast_stgcn_maml_tpu_torch.utils.checkpoint import save_checkpoint

    mc = tcfg.ModelConfig(**SMALL, family="stgcn")
    save_checkpoint(str(tmp_path / "meta" / "ckpt_best"),
                    init_model(torch.Generator().manual_seed(0), mc).state_dict(),
                    {"config": tcfg.to_dict(tcfg.ExperimentConfig(model=mc))})
    with pytest.raises(SystemExit, match="hybrid-only, checkpoint family is 'stgcn'"):
        cli.main(["export-checkpoint", "--out", str(tmp_path / "x.pt"),
                  "-o", f"out_dir={tmp_path}"])


def _report_region(pkg, tag):
    """A synthetic region whose NaNs give the report's flags: variable 0 at
    10% (`!`), 1 at 20% (`!!`), 5 at 2%; the data differ by the years
    asked for."""
    r = synthetic_region_for_box(BOX, num_timesteps=40, seed=len(tag), name="tiny")
    w = r.weather.copy()
    flat = w.reshape(-1, 12)
    rng = np.random.default_rng(7)
    for var, frac in ((0, 0.10), (1, 0.20), (5, 0.02)):
        flat[rng.random(flat.shape[0]) < frac, var] = np.nan
    return pkg.RegionData(weather=w, times=r.times, lats=r.lats, lons=r.lons,
                          koppen_code=r.koppen_code, name=r.name)


@pytest.mark.parametrize("years", ["train", "adapt", "validate"])
def test_data_report_prints_jax_lines(monkeypatch, years):
    """The report's stdout, line for line, with its NaN flags."""
    monkeypatch.setattr(jax_data_source, "get_region_data",
                        lambda box, ys, cfg, tag, name: _report_region(jax_region, tag))
    monkeypatch.setattr(port_data_source, "get_region_data",
                        lambda box, ys, cfg, tag, name: _report_region(port_region, tag))
    argv = ["data-report", "--box", *map(str, BOX), "--name", "tiny", "--years", years]
    _, want, _ = _cli(*argv, main=jax_cli.main)
    rc, got, _ = _cli(*argv)
    assert rc == 0
    assert got.splitlines() == want.splitlines()
    assert len(got.splitlines()) == 3 + 12 and "!!" in got and " !" in got


def test_data_report_moscow_matches_jax(same_host_route):
    """The unpatched synthetic backend, a named region."""
    argv = ["data-report", "--region", "Moscow", "-o", "data.synthetic_timesteps=64"]
    _, want, _ = _cli(*argv, main=jax_cli.main)
    assert _cli(*argv)[1].splitlines() == want.splitlines()


def test_timer_accumulates_like_jax(monkeypatch):
    ticks = iter([0.0, 1.5, 2.0, 2.25, 3.0, 7.0])
    clock = lambda: next(ticks)  # noqa: E731
    timers = []
    for mod in (profiling, jax_profiling):
        monkeypatch.setattr(mod.time, "perf_counter", clock)
        t = mod.Timer()
        for name in ("a", "b", "a"):
            with t.span(name):
                pass
        timers.append(t.summary())
        ticks = iter([0.0, 1.5, 2.0, 2.25, 3.0, 7.0])
    assert timers[0] == timers[1] == {"a": 5.5, "b": 0.25}


def test_trace_span_and_block_until_ready(tmp_path):
    """trace_span writes a Chrome trace of the block's ops; None is a no-op."""
    with profiling.trace_span(None):
        pass
    assert not os.path.exists(tmp_path / "trace")
    x = torch.ones(4, 4)
    with profiling.trace_span(str(tmp_path / "trace")):
        y = x @ x
    assert profiling.block_until_ready({"y": [y]})["y"][0] is y
    with open(tmp_path / "trace" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names


def test_meta_train_done_line_has_spans(tmp_path):
    """The engine's last line carries the task-building span, as JAX's."""
    cfg = tcfg.apply_overrides(tcfg.ExperimentConfig(), [
        *(f"model.{k}={v}" for k, v in SMALL.items()), "meta.num_epochs=1",
        "meta.inner_epochs=1", "meta.inner_batches=1", "meta.meta_batch=2",
        "meta.grad_accum=1", f"out_dir={tmp_path}"])
    regions = [synthetic_region_for_box((10.0 + 2 * i, 10.5 + 2 * i, 20.0, 20.5),
                                        num_timesteps=40, seed=i) for i in range(2)]
    lines = []
    meta_train.run_meta_training(cfg, regions, device="cpu", log_cb=lines.append)
    done = lines[-1]
    assert done.startswith("[meta-train] done: best ") and "; spans {'task_build': " in done


def test_python_m_info_and_new_modules_leave_jax_unimported(tmp_path):
    """`python -m weatherforecast_stgcn_maml_tpu_torch info` runs; importing
    every module this slice added, and the CLI's import / export /
    data-report, never import jax."""
    proc = subprocess.run([sys.executable, "-m", "weatherforecast_stgcn_maml_tpu_torch", "info"],
                          env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "cuda devices:" in proc.stdout and "regions:" in proc.stdout
    path = _save(tmp_path, _reference_ckpt(jcfg.ModelConfig(**SMALL)))
    code = (
        "import sys\n"
        "import weatherforecast_stgcn_maml_tpu_torch.data.koppen\n"
        "import weatherforecast_stgcn_maml_tpu_torch.utils.profiling\n"
        "import weatherforecast_stgcn_maml_tpu_torch.utils.torch_import\n"
        "import weatherforecast_stgcn_maml_tpu_torch.utils.torch_export\n"
        "import weatherforecast_stgcn_maml_tpu_torch.parallel.fleet_mesh\n"
        "import weatherforecast_stgcn_maml_tpu_torch.engines.fleet_adapt\n"
        "from weatherforecast_stgcn_maml_tpu_torch import cli\n"
        f"out = {str(tmp_path / 'o')!r}\n"
        f"assert cli.main(['import-checkpoint', {path!r}, '-o', 'out_dir=' + out]) == 0\n"
        "assert cli.main(['export-checkpoint', '--out', out + '/x.pt', '-o', 'out_dir=' + out]) == 0\n"
        "assert cli.main(['data-report', '--region', 'Moscow', '-o',"
        " 'data.synthetic_timesteps=48']) == 0\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'weatherforecast_stgcn_maml_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code],
                          env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
