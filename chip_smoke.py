#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving path on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (the first failure raises and exits non-zero):
  1. require a CUDA card of compute capability 9.x; print its name and
     power limit;
  2. build the CUDA kernels from ops/csrc/*.cu;
  3. hold each kernel against its plain PyTorch version on the card at the
     reference width (ModelConfig() defaults, the Moscow graph: 441 nodes
     padded to 512), float32 and bfloat16;
  4. write a seeded base checkpoint and drive the CLI: `forecast` for three
     regions and `validate --no-plots` for Moscow, at float32 and bfloat16;
     both kernels must have launched, every output must be finite, and the
     Moscow forecast must match the same request on the plain route
     (`--device cpu`);
  5. time each kernel and its plain version, one `predict` call and one
     whole forecast request (median of REPEATS runs).

The last three lines of stdout are the kernels JSON, the card line as
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints it,
and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

TOL = {"float32": 1e-5, "bfloat16": 5e-2}  # rtol = atol, as bench.py's gate
REPEATS = 10
REGIONS = ("Moscow", "NewYork", "Thailand")
TPU_KERNELS = {
    "fused_gcn_stack": "weatherforecast_stgcn_maml_tpu/ops/fused_gcn.py:148",
    "lstm_stack_last_all": "weatherforecast_stgcn_maml_tpu/ops/fused_lstm_stack.py:940",
}
SOURCES = {
    "fused_gcn_stack": "weatherforecast_stgcn_maml_tpu_torch/ops/csrc/fused_gcn.cu",
    "lstm_stack_last_all": "weatherforecast_stgcn_maml_tpu_torch/ops/csrc/fused_lstm_stack.cu",
}


def log(*args):
    print(*args, flush=True)


def cuda_ms(torch, fn, repeats=REPEATS):
    """Median device time of fn() in ms over `repeats` runs (CUDA events)."""
    fn()
    fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(torch, fn, repeats=REPEATS):
    """Median wall time of fn() in ms, each run ending in a synchronize."""
    fn()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from weatherforecast_stgcn_maml_tpu_torch import cli
    from weatherforecast_stgcn_maml_tpu_torch.config import (
        ADAPTATION_REGIONS,
        ExperimentConfig,
        ModelConfig,
        to_dict,
    )
    from weatherforecast_stgcn_maml_tpu_torch.data.synthetic import synthetic_region_for_box
    from weatherforecast_stgcn_maml_tpu_torch.graph import build_region_graph
    from weatherforecast_stgcn_maml_tpu_torch.models.registry import init_model
    from weatherforecast_stgcn_maml_tpu_torch.ops import cuda_build
    from weatherforecast_stgcn_maml_tpu_torch.ops.fused_gcn import (
        fused_gcn_stack,
        gcn_stack_plain,
    )
    from weatherforecast_stgcn_maml_tpu_torch.ops.fused_lstm_stack import (
        lstm_stack_last_all,
        lstm_stack_plain,
    )
    from weatherforecast_stgcn_maml_tpu_torch.train.supervised import make_predict
    from weatherforecast_stgcn_maml_tpu_torch.utils.checkpoint import save_checkpoint

    # 1. The card.
    major, minor = torch.cuda.get_device_capability(0)
    if major != 9:
        raise RuntimeError(f"the kernels target sm_90a; this card is sm_{major}{minor}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are on: the float32 plain route would not be float32")
    dev = torch.device("cuda", 0)

    # 2. Build.
    t0 = time.perf_counter()
    cuda_build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {cuda_build.build_seconds} s)")
    for line in cuda_build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # 3. Kernel vs plain at the reference width.
    cfg = ModelConfig()
    boxes = dict((name, box) for box, name in ADAPTATION_REGIONS)
    moscow = synthetic_region_for_box(boxes["Moscow"], num_timesteps=2, seed=0)
    graph = build_region_graph(moscow.lats, moscow.lons, k_neighbors=4)
    n = graph.padded_nodes
    model = init_model(torch.Generator().manual_seed(0), cfg, device=dev)
    model.requires_grad_(False)
    a_hat = torch.from_numpy(graph.a_hat).to(dev)
    rng = np.random.default_rng(0)
    x_gcn = torch.from_numpy(
        rng.standard_normal((3 * cfg.window, n, cfg.in_channels)).astype(np.float32)
    ).to(dev)
    x_lstm = torch.from_numpy(
        rng.standard_normal((3 * n, cfg.window, cfg.hidden_channels)).astype(np.float32)
    ).to(dev)
    enc, lstm = model.encoder.layers, model.lstm.layers
    runs = {
        "fused_gcn_stack": (
            lambda dt: fused_gcn_stack(enc, a_hat, x_gcn, compute_dtype=dt),
            lambda dt: gcn_stack_plain(enc, a_hat, x_gcn, dt),
        ),
        "lstm_stack_last_all": (
            lambda dt: lstm_stack_last_all(lstm, x_lstm, compute_dtype=dt),
            lambda dt: lstm_stack_plain(lstm, x_lstm, dt),
        ),
    }
    measured: dict = {}
    with torch.inference_mode():
        for name, (kernel, plain) in runs.items():
            for dt_name, tol in TOL.items():
                dt = getattr(torch, dt_name)
                got, ref = kernel(dt), plain(dt)
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                torch.testing.assert_close(got, ref, rtol=tol, atol=tol)
                ms = cuda_ms(torch, lambda: kernel(dt))
                plain_ms = cuda_ms(torch, lambda: plain(dt))
                measured[(name, dt_name)] = (err, ms, plain_ms)
                log(
                    f"{name} {dt_name} shape {list(x_gcn.shape if 'gcn' in name else x_lstm.shape)}: "
                    f"max_abs_err {err:.3e} (tol {tol}); kernel {ms:.4f} ms, "
                    f"plain {plain_ms:.4f} ms  [{card}]"
                )

    # 4. The serving path through the CLI.
    with tempfile.TemporaryDirectory() as out:
        save_checkpoint(
            os.path.join(out, "meta", "ckpt_best"),
            model.state_dict(),
            {"schema": "wfstgcn-meta-v1", "config": to_dict(ExperimentConfig(model=cfg))},
        )

        def forecast(region, dt_name, device="cuda"):
            argv = ["forecast", "--region", region, "--device", device,
                    "-o", f"out_dir={out}", "-o", f"model.compute_dtype={dt_name}"]
            with contextlib.redirect_stdout(io.StringIO()):
                if cli.main(argv) != 0:
                    raise RuntimeError(f"forecast {argv} failed")
            with open(os.path.join(out, "forecasts", f"{region}.json")) as f:
                mean = np.asarray(json.load(f)["mean_forecast"])
            if mean.shape != (cfg.horizon, cfg.num_weather_vars) or not np.isfinite(mean).all():
                raise RuntimeError(f"forecast {region} {dt_name}: bad output {mean.shape}")
            return mean

        def validate(dt_name):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["validate", "--region", "Moscow", "--no-plots",
                               "-o", f"out_dir={out}", "-o", f"model.compute_dtype={dt_name}"])
            results = json.loads(buf.getvalue())
            values = [v for k, d in results.items() if isinstance(d, dict) for v in d.values()]
            if rc != 0 or not np.isfinite(values + [results["average_mse"]]).all():
                raise RuntimeError(f"validate {dt_name}: {results}")
            return results

        fused_gcn_stack.launches = 0
        lstm_stack_last_all.launches = 0
        served = {}
        for dt_name in TOL:
            for region in REGIONS:
                served[(region, dt_name)] = forecast(region, dt_name)
            validate(dt_name)
        launches = {
            "fused_gcn_stack": fused_gcn_stack.launches,
            "lstm_stack_last_all": lstm_stack_last_all.launches,
        }
        log(f"launches on the serving path: {launches}")
        for name, count in launches.items():
            if count == 0:
                raise RuntimeError(f"{name} never launched on the serving path")

        for dt_name, tol in TOL.items():
            ref = forecast("Moscow", dt_name, device="cpu")
            got = served[("Moscow", dt_name)]
            np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
            log(
                f"forecast Moscow {dt_name}: card vs plain route max_abs_err "
                f"{float(np.abs(got - ref).max()):.3e} (tol {tol})"
            )

        # 5. predict and a whole forecast request.
        with torch.inference_mode():
            for dt_name in TOL:
                predict = make_predict(ModelConfig(compute_dtype=dt_name))
                for b in (1, 3):
                    x = torch.from_numpy(
                        rng.standard_normal(
                            (b, cfg.window, n, cfg.feature_channels)
                        ).astype(np.float32)
                    ).to(dev)
                    ms = host_ms(torch, lambda: predict(model, x, a_hat, 2))
                    log(f"predict {dt_name} batch {b}: {ms:.3f} ms  [{card}]")
        for dt_name in TOL:
            ms = host_ms(torch, lambda: forecast("Moscow", dt_name))
            log(f"forecast request Moscow {dt_name}: {ms:.3f} ms  [{card}]")

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": TPU_KERNELS[name],
            "launches": launches[name],
            "max_abs_err": measured[(name, "float32")][0],
            "ms": measured[(name, "float32")][1],
            "plain_ms": measured[(name, "float32")][2],
        }
        for name in runs
    ]
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
