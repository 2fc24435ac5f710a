#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: the serving path and
first-order MAML meta-training.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (the first failure raises and exits non-zero; each prints its wall
time):
  1. require a CUDA card of compute capability 9.x; print its name and
     power limit;
  2. build the CUDA kernels from ops/csrc/*.cu;
  3. hold the serving kernels (rows 1-2) against their plain PyTorch
     versions at the reference width (ModelConfig() defaults, the Moscow
     graph: 441 nodes padded to 512), float32 and bfloat16;
  4. write a seeded base checkpoint and drive the serving CLI: `forecast`
     for three regions and `validate --no-plots` for Moscow, at float32 and
     bfloat16; both kernels must have launched, every output must be
     finite, and the Moscow forecast must match the same request on the
     plain route (`--device cpu`);
  5. time the serving kernels, their plain versions and cuDNN / cuBLAS
     yardsticks, one `predict` call and one whole forecast request;
  6. hold the training kernels (rows 4-7) against their plain versions at
     the inner step's shapes (one window: 24 slices x 512 nodes, 512 LSTM
     rows), forward and every gradient, float32 and bfloat16, with the same
     dropout masks (rate 0.2) on both sides; time each direction;
  7. the FO meta-gradient of one micro-batch (2 tasks, 15 inner steps each,
     dropout on), kernel route against plain route, same generator seed;
  8. drive `cli meta-train` (the full default meta step: 4 tasks x 90 inner
     steps, grad-accum 2): 2 epochs float32, 1 epoch bfloat16, then
     `--resume` to epoch 3, then `forecast` from the meta-trained
     `ckpt_best`; rows 4-7 must have launched, every loss must be finite;
  9. time one inner step (with a torch.profiler breakdown of its device
     time by kernel) and one meta step, with the meta step's peak device
     memory.

The last three lines of stdout are the kernels JSON, the card line as
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints it,
and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

TOL = {"float32": 1e-5, "bfloat16": 5e-2}  # rtol = atol; gradients: max|diff| / max|ref|
REPEATS = 10
REGIONS = ("Moscow", "NewYork", "Thailand")
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
TPU_KERNELS = {
    "fused_gcn_stack": "weatherforecast_stgcn_maml_tpu/ops/fused_gcn.py:148",
    "lstm_stack_last_all": "weatherforecast_stgcn_maml_tpu/ops/fused_lstm_stack.py:940",
    "lstm_stack_train": "weatherforecast_stgcn_maml_tpu/ops/fused_lstm_stack.py:618",
    "lstm_stack_train.backward": "weatherforecast_stgcn_maml_tpu/ops/fused_lstm_stack.py:725",
    "gcn_stack_train": "weatherforecast_stgcn_maml_tpu/ops/fused_gcn_train.py:79",
    "gcn_stack_train.backward": "weatherforecast_stgcn_maml_tpu/ops/fused_gcn_train.py:123",
}
CSRC = "weatherforecast_stgcn_maml_tpu_torch/ops/csrc/"
SOURCES = {
    "fused_gcn_stack": CSRC + "gemm.cu",
    "lstm_stack_last_all": CSRC + "fused_lstm_stack.cu",
    "lstm_stack_train": CSRC + "fused_lstm_stack.cu",
    "lstm_stack_train.backward": CSRC + "fused_lstm_stack_train.cu",
    "gcn_stack_train": CSRC + "fused_gcn_train.cu",
    "gcn_stack_train.backward": CSRC + "fused_gcn_train.cu",
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


def bound_ms(n_bytes, flops):
    """The least time the card could take: bytes over the memory rate or
    float32 operations over the float32 rate, whichever is larger."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"== phase: {self.name}")

    def __exit__(self, *exc):
        log(f"== phase {self.name}: {time.perf_counter() - self.t0:.1f} s")


def profile_inner_steps(torch, inner_step, card, steps=5):
    """Device time by kernel over `steps` inner steps (torch.profiler), and
    the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    inner_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            inner_step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []  # device-side events only: an op's row repeats its kernels' time
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if str(ev.device_type).endswith("CUDA") and dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    busy = sum(r[0] for r in rows)
    if not rows:
        log("profile: the profiler reported no device time")
        return
    log(f"profile of {steps} float32 inner steps: wall {wall_us / steps / 1e3:.3f} ms a step, "
        f"device busy {busy / steps / 1e3:.3f} ms a step ({100 * busy / wall_us:.1f}%)  [{card}]")
    for dev_us, count, key in sorted(rows, reverse=True)[:12]:
        log(f"  {dev_us / steps / 1e3:8.4f} ms a step  {count // steps:4d} launches  "
            f"{100 * dev_us / busy:5.1f}%  {key[:90]}")


def rel_err(got, ref):
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max())


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
        META_TRAIN_REGIONS,
        DataConfig,
        ExperimentConfig,
        MetaConfig,
        ModelConfig,
        to_dict,
    )
    from weatherforecast_stgcn_maml_tpu_torch.data.synthetic import synthetic_region_for_box
    from weatherforecast_stgcn_maml_tpu_torch.engines.data_source import get_region_data
    from weatherforecast_stgcn_maml_tpu_torch.graph import build_region_graph
    from weatherforecast_stgcn_maml_tpu_torch.models.common import draw_mask
    from weatherforecast_stgcn_maml_tpu_torch.models.losses import masked_mse
    from weatherforecast_stgcn_maml_tpu_torch.models.registry import apply_model, init_model
    from weatherforecast_stgcn_maml_tpu_torch.ops import cuda_build
    from weatherforecast_stgcn_maml_tpu_torch.ops.fused_gcn import (
        fused_gcn_stack,
        gcn_stack_plain,
    )
    from weatherforecast_stgcn_maml_tpu_torch.ops.fused_gcn_train import (
        gcn_stack_train,
        gcn_stack_train_plain,
    )
    from weatherforecast_stgcn_maml_tpu_torch.ops.fused_lstm_stack import (
        lstm_stack_last_all,
        lstm_stack_plain,
        lstm_stack_train,
    )
    from weatherforecast_stgcn_maml_tpu_torch.train.maml import (
        init_meta_state,
        make_meta_step,
        task_batch_grad,
    )
    from weatherforecast_stgcn_maml_tpu_torch.train.optimizers import clip_global_norm_tree
    from weatherforecast_stgcn_maml_tpu_torch.train.supervised import make_predict
    from weatherforecast_stgcn_maml_tpu_torch.train.tasks import (
        build_meta_tasks,
        stage_tasks,
        task_at,
    )
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
    torch.backends.cudnn.allow_tf32 = False  # the cuDNN LSTM yardstick in float32
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 2. Build.
    with Phase("build"):
        cuda_build.load()
        if cuda_build.build_seconds is None:
            log("kernels loaded from an earlier build of the same sources")
        else:
            log(f"nvcc (one process per source, in parallel) {cuda_build.build_seconds:.1f} s")
        for line in cuda_build.build_log.splitlines():
            if "registers" in line or ("spill" in line and " 0 bytes spill" not in line):
                log(f"  ptxas: {line.strip()}")

    cfg = ModelConfig()
    boxes = dict((name, box) for box, name in ADAPTATION_REGIONS)
    moscow = synthetic_region_for_box(boxes["Moscow"], num_timesteps=2, seed=0)
    graph = build_region_graph(moscow.lats, moscow.lons, k_neighbors=4)
    n = graph.padded_nodes
    model = init_model(torch.Generator().manual_seed(0), cfg, device=dev)
    a_hat = torch.from_numpy(graph.a_hat).to(dev)
    rng = np.random.default_rng(0)
    enc, lstm = model.encoder.layers, model.lstm.layers
    measured: dict = {}  # name -> dict(max_abs_err, ms, plain_ms, library_ms, bytes, flops)

    def gcn_flops(slices, widths):
        return sum(2 * slices * n * (c * h + n * h) for c, h in widths)

    def lstm_flops(rows, t_len, c_in, hidden, layers):
        return sum(2 * t_len * rows * ((c_in if l == 0 else hidden) + hidden) * 4 * hidden
                   for l in range(layers))

    gcn_widths = [(layer.w.shape[0], layer.w.shape[1]) for layer in enc]
    gcn_w_bytes = 4 * sum(c * h + h for c, h in gcn_widths)
    lstm_w_bytes = 4 * sum(p.numel() for layer in lstm for p in (layer.wx, layer.wh, layer.b))

    # 3. Serving kernels vs plain at the reference width.
    x_gcn = torch.from_numpy(
        rng.standard_normal((3 * cfg.window, n, cfg.in_channels)).astype(np.float32)
    ).to(dev)
    x_lstm = torch.from_numpy(
        rng.standard_normal((3 * n, cfg.window, cfg.hidden_channels)).astype(np.float32)
    ).to(dev)
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
    with Phase("serving kernels vs plain"), torch.inference_mode():
        for name, (kernel, plain) in runs.items():
            for dt_name, tol in TOL.items():
                dt = getattr(torch, dt_name)
                got, ref = kernel(dt), plain(dt)
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                torch.testing.assert_close(got, ref, rtol=tol, atol=tol)
                log(f"{name} {dt_name}: max_abs_err {err:.3e} (tol {tol})")
                if dt_name == "float32":
                    measured[name] = {"max_abs_err": err}

    # 4. The serving path through the CLI.
    out_root = tempfile.mkdtemp(prefix="chip_smoke_")
    serve_dir = os.path.join(out_root, "serve")
    with Phase("serving CLI"):
        save_checkpoint(
            os.path.join(serve_dir, "meta", "ckpt_best"),
            model.state_dict(),
            {"schema": "wfstgcn-meta-v1", "config": to_dict(ExperimentConfig(model=cfg))},
        )

        def forecast(region, dt_name, out, device="cuda"):
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
                               "-o", f"out_dir={serve_dir}",
                               "-o", f"model.compute_dtype={dt_name}"])
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
                served[(region, dt_name)] = forecast(region, dt_name, serve_dir)
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
            ref = forecast("Moscow", dt_name, serve_dir, device="cpu")
            got = served[("Moscow", dt_name)]
            np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
            log(
                f"forecast Moscow {dt_name}: card vs plain route max_abs_err "
                f"{float(np.abs(got - ref).max()):.3e} (tol {tol})"
            )

    # 5. Serving times.
    with Phase("serving times"):
        cudnn = torch.nn.LSTM(cfg.hidden_channels, cfg.lstm_hidden, cfg.lstm_layers,
                              batch_first=True).to(dev)
        with torch.no_grad():
            for l, layer in enumerate(lstm):
                getattr(cudnn, f"weight_ih_l{l}").copy_(layer.wx.t())
                getattr(cudnn, f"weight_hh_l{l}").copy_(layer.wh.t())
                getattr(cudnn, f"bias_ih_l{l}").copy_(layer.b)
                getattr(cudnn, f"bias_hh_l{l}").zero_()
        with torch.inference_mode():
            for name, (kernel, plain) in runs.items():
                for dt_name in TOL:
                    dt = getattr(torch, dt_name)
                    ms = cuda_ms(torch, lambda: kernel(dt))
                    plain_ms = cuda_ms(torch, lambda: plain(dt))
                    log(f"{name} {dt_name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms  [{card}]")
                    if dt_name == "float32":
                        measured[name].update(ms=ms, plain_ms=plain_ms)
            # Yardsticks: the plain GEMM route (cuBLAS float32) for the GCN
            # stack, cuDNN's LSTM for the LSTM stack.
            measured["fused_gcn_stack"]["library_ms"] = measured["fused_gcn_stack"]["plain_ms"]
            lib_ms = cuda_ms(torch, lambda: cudnn(x_lstm))
            measured["lstm_stack_last_all"]["library_ms"] = lib_ms
            log(f"torch.nn.LSTM (cuDNN) float32 forward [1536, 24, 256]: {lib_ms:.4f} ms  [{card}]")
            measured["fused_gcn_stack"].update(
                flops=gcn_flops(3 * cfg.window, gcn_widths),
                bytes=4 * (x_gcn.numel() + n * n + 3 * cfg.window * n * cfg.hidden_channels)
                + gcn_w_bytes,
            )
            measured["lstm_stack_last_all"].update(
                flops=lstm_flops(3 * n, cfg.window, cfg.hidden_channels, cfg.lstm_hidden,
                                 cfg.lstm_layers),
                bytes=4 * (x_lstm.numel() + 3 * n * cfg.lstm_hidden) + lstm_w_bytes,
            )
            for dt_name in TOL:
                predict = make_predict(ModelConfig(compute_dtype=dt_name))
                for b in (1, 3):
                    x = torch.from_numpy(
                        rng.standard_normal((b, cfg.window, n, cfg.feature_channels)).astype(np.float32)
                    ).to(dev)
                    ms = host_ms(torch, lambda: predict(model, x, a_hat, 2))
                    log(f"predict {dt_name} batch {b}: {ms:.3f} ms  [{card}]")
        for dt_name in TOL:
            ms = host_ms(torch, lambda: forecast("Moscow", dt_name, serve_dir))
            log(f"forecast request Moscow {dt_name}: {ms:.3f} ms  [{card}]")

    # 6. Training kernels (rows 4-7) vs plain at the inner step's shapes.
    w_len, hid, lh, n_l = cfg.window, cfg.hidden_channels, cfg.lstm_hidden, cfg.lstm_layers
    x_enc = torch.from_numpy(
        rng.standard_normal((w_len, n, cfg.in_channels)).astype(np.float32)).to(dev)
    x_rec = torch.from_numpy(
        rng.standard_normal((n, w_len, hid)).astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    gcn_masks = draw_mask(gen, (cfg.gcn_layers - 1, w_len, n, hid), 0.2, dev)
    lstm_masks = draw_mask(gen, (n_l - 1, w_len, n, lh), 0.2, dev)
    enc_params = [p for layer in enc for p in (layer.w, layer.b)]
    lstm_params = [p for layer in lstm for p in (layer.wx, layer.wh, layer.b)]
    train_runs = {
        "gcn_stack_train": (
            lambda x, dt: gcn_stack_train(enc, a_hat, x, masks=gcn_masks, keep=0.8,
                                          compute_dtype=dt),
            lambda x, dt: gcn_stack_train_plain(enc, a_hat, x, gcn_masks, 0.8, dt),
            x_enc, enc_params,
        ),
        "lstm_stack_train": (
            lambda x, dt: lstm_stack_train(lstm, x, masks=lstm_masks, keep=0.8,
                                           compute_dtype=dt),
            lambda x, dt: lstm_stack_plain(lstm, x, dt, lstm_masks, 0.8),
            x_rec, lstm_params,
        ),
    }

    def graph_of(fn, x, dt, params):
        """Forward with autograd on; returns (out, leaves, cotangent)."""
        leaf = x.detach().clone().requires_grad_(True)
        out = fn(leaf, dt)
        ct = torch.from_numpy(
            np.random.default_rng(1).standard_normal(out.shape).astype(np.float32)
        ).to(dev, out.dtype)
        return out, [leaf, *params], ct

    with Phase("training kernels vs plain"):
        for name, (kernel, plain, x, params) in train_runs.items():
            for dt_name, tol in TOL.items():
                dt = getattr(torch, dt_name)
                outs = {}
                for route, fn in (("kernel", kernel), ("plain", plain)):
                    out, leaves, ct = graph_of(fn, x, dt, params)
                    outs[route] = (out.detach(), torch.autograd.grad(out, leaves, ct))
                torch.cuda.synchronize()
                (got, got_g), (ref, ref_g) = outs["kernel"], outs["plain"]
                fwd_err = float((got.float() - ref.float()).abs().max())
                torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)
                rels = [rel_err(g, r) for g, r in zip(got_g, ref_g)]
                bwd_err = max(float((g - r).abs().max()) for g, r in zip(got_g, ref_g))
                log(f"{name} {dt_name} x {list(x.shape)}: forward max_abs_err {fwd_err:.3e} "
                    f"(tol {tol}); gradients max|diff|/max|ref| {max(rels):.3e} (tol {tol}), "
                    f"per input {[f'{r:.1e}' for r in rels]}")
                if max(rels) > tol:
                    raise RuntimeError(f"{name} {dt_name}: gradient error {max(rels):.3e} > {tol}")
                times = {}
                for route, fn in (("kernel", kernel), ("plain", plain)):
                    with torch.no_grad():
                        fwd = cuda_ms(torch, lambda: fn(x, dt))
                    out, leaves, ct = graph_of(fn, x, dt, params)
                    bwd = cuda_ms(torch, lambda: torch.autograd.grad(
                        out, leaves, ct, retain_graph=True))
                    times[route] = (fwd, bwd)
                log(f"{name} {dt_name}: kernel forward {times['kernel'][0]:.4f} ms, backward "
                    f"{times['kernel'][1]:.4f} ms; plain forward {times['plain'][0]:.4f} ms, "
                    f"backward {times['plain'][1]:.4f} ms  [{card}]")
                if dt_name == "float32":
                    measured[name] = {"max_abs_err": fwd_err, "ms": times["kernel"][0],
                                      "plain_ms": times["plain"][0]}
                    measured[name + ".backward"] = {
                        "max_abs_err": bwd_err, "ms": times["kernel"][1],
                        "plain_ms": times["plain"][1]}
        # Yardsticks: cuBLAS float32 (the plain GEMM route) for the GCN
        # stack; cuDNN's LSTM, weights copied in, dropout 0, for the LSTM.
        measured["gcn_stack_train"]["library_ms"] = measured["gcn_stack_train"]["plain_ms"]
        measured["gcn_stack_train.backward"]["library_ms"] = (
            measured["gcn_stack_train.backward"]["plain_ms"])
        xr = x_rec.detach().clone().requires_grad_(True)
        with torch.no_grad():
            measured["lstm_stack_train"]["library_ms"] = cuda_ms(torch, lambda: cudnn(xr))
        out = cudnn(xr)[0][:, -1]
        ct = torch.ones_like(out)
        measured["lstm_stack_train.backward"]["library_ms"] = cuda_ms(
            torch, lambda: torch.autograd.grad(out, [xr, *cudnn.parameters()], ct,
                                               retain_graph=True))
        log(f"torch.nn.LSTM (cuDNN) float32 [512, 24, 256]: forward "
            f"{measured['lstm_stack_train']['library_ms']:.4f} ms, backward "
            f"{measured['lstm_stack_train.backward']['library_ms']:.4f} ms  [{card}]")
        del out, ct, xr
        e = 4  # float32 residuals
        gcn_io = 4 * (x_enc.numel() + n * n) + gcn_w_bytes + gcn_masks.numel()
        act = cfg.gcn_layers * w_len * n * hid * e
        measured["gcn_stack_train"].update(flops=gcn_flops(w_len, gcn_widths),
                                           bytes=gcn_io + act)
        measured["gcn_stack_train.backward"].update(
            flops=sum(2 * w_len * n * (n * h + 2 * c * h) for c, h in gcn_widths),
            bytes=gcn_io + act + w_len * n * hid * e + 4 * x_enc.numel() + gcn_w_bytes)
        lstm_io = 4 * x_rec.numel() + lstm_w_bytes + lstm_masks.numel()
        res = 2 * n_l * w_len * n * lh * e
        fl = lstm_flops(n, w_len, hid, lh, n_l)
        measured["lstm_stack_train"].update(flops=fl, bytes=lstm_io + res + 4 * n * lh)
        measured["lstm_stack_train.backward"].update(
            flops=2 * fl, bytes=lstm_io + res + 4 * n * lh + 4 * x_rec.numel() + lstm_w_bytes)

    # Meta-training tasks at the reference width: 4 meta-training regions.
    meta_cfg = MetaConfig(fused_inner_update=False)
    data_cfg = DataConfig()
    regions = [get_region_data(box, data_cfg.train_years, data_cfg, tag="train",
                               name=f"region{i}")
               for i, box in enumerate(META_TRAIN_REGIONS[:4])]
    tasks = stage_tasks([b.task for b in build_meta_tasks(regions, cfg, meta_cfg, data_cfg)], dev)

    # 7. The FO meta-gradient, kernel route vs plain route.
    with Phase("meta-gradient kernel vs plain"):
        one_epoch = dataclasses.replace(meta_cfg, inner_epochs=1)
        micro = type(tasks)(*(f[:2] for f in tasks))
        for dt_name, tol in TOL.items():
            routes = {
                "kernel": ModelConfig(compute_dtype=dt_name),
                "plain": ModelConfig(compute_dtype=dt_name, use_pallas_gcn=False,
                                     lstm_kernel="xla"),
            }
            res = {}
            for route, mc in routes.items():
                g = torch.Generator(device=dev).manual_seed(11)
                t0 = time.perf_counter()
                res[route] = task_batch_grad(model, micro, g, mc, one_epoch)
                torch.cuda.synchronize()
                log(f"  {route} route {dt_name}: {time.perf_counter() - t0:.2f} s")
            (loss_k, grad_k), (loss_p, grad_p) = res["kernel"], res["plain"]
            loss_err = float((loss_k - loss_p).abs().max())
            rels = {k: rel_err(grad_k[k], grad_p[k]) for k in grad_k}
            worst = max(rels, key=rels.get)
            log(f"meta-gradient {dt_name}: per-task query losses {loss_k.tolist()} vs "
                f"{loss_p.tolist()} (max diff {loss_err:.3e}); gradient max|diff|/max|ref| "
                f"{rels[worst]:.3e} at {worst} (tol {tol})")
            torch.testing.assert_close(loss_k, loss_p, rtol=tol, atol=tol)
            if rels[worst] > tol:
                raise RuntimeError(f"meta-gradient {dt_name}: {worst} off by {rels[worst]:.3e}")

    # 8. Meta-training through the CLI: the training path's main run.
    meta_dir = os.path.join(out_root, "meta_train")
    with Phase("meta-train CLI"):
        def meta_train(dt_name, epochs, *extra):
            argv = ["meta-train", *extra, "-o", f"out_dir={meta_dir}/{dt_name}",
                    "-o", f"model.compute_dtype={dt_name}",
                    "-o", "meta.fused_inner_update=false", "-o", f"meta.num_epochs={epochs}"]
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                if cli.main(argv) != 0:
                    raise RuntimeError(f"meta-train {argv} failed")
            log(f"meta-train {dt_name} {epochs} epochs {' '.join(extra)}: "
                f"{time.perf_counter() - t0:.1f} s; {buf.getvalue().strip()}")
            with open(os.path.join(meta_dir, dt_name, "meta", "meta_log.jsonl")) as f:
                return [json.loads(line) for line in f]

        counters = (gcn_stack_train, lstm_stack_train)
        for fn in counters:
            fn.launches = fn.backward_launches = 0
        logs = {"float32": meta_train("float32", 2), "bfloat16": meta_train("bfloat16", 1)}
        train_launches = {}
        for fn in counters:
            train_launches[fn.__name__] = fn.launches
            train_launches[fn.__name__ + ".backward"] = fn.backward_launches
        log(f"launches on the meta-training path: {train_launches}")
        for name, count in train_launches.items():
            if count == 0:
                raise RuntimeError(f"{name} never launched on the meta-training path")
        logs["float32"] = meta_train("float32", 3, "--resume")
        for dt_name, records in logs.items():
            want = [1, 2, 3] if dt_name == "float32" else [1]
            if [r["epoch"] for r in records] != want:
                raise RuntimeError(f"meta-train {dt_name}: epochs {[r['epoch'] for r in records]}")
            for r in records:
                losses = [r["meta_loss"], *r["per_task_loss"]]
                if not np.isfinite(losses).all():
                    raise RuntimeError(f"meta-train {dt_name}: non-finite loss {r}")
                log(f"  {dt_name} epoch {r['epoch']}: meta_loss {r['meta_loss']:.6f}, tasks "
                    f"{r['task_indices']}, {r['epoch_seconds']:.2f} s  [{card}]")
            for ckpt in ("ckpt_best", "ckpt_last", "ckpt_final"):
                if not os.path.isdir(os.path.join(meta_dir, dt_name, "meta", ckpt)):
                    raise RuntimeError(f"meta-train {dt_name}: no {ckpt}")
        mean = forecast("Moscow", "float32", os.path.join(meta_dir, "float32"))
        log(f"forecast Moscow from the meta-trained ckpt_best: t2m {mean[:, 2].round(2).tolist()}")

    # 9. Inner step, meta step, peak memory.
    with Phase("meta-step times"):
        for dt_name in TOL:
            mc = ModelConfig(compute_dtype=dt_name)
            state = init_meta_state(torch.Generator().manual_seed(1), mc, meta_cfg, device=dev)
            task = task_at(tasks, 0)
            named = list(state.params.named_parameters())
            g = torch.Generator(device=dev).manual_seed(2)

            def inner_step():
                loss = masked_mse(apply_model(state.params, task.a_hat, task.support_x[0],
                                              task.koppen, mc, train=True, generator=g),
                                  task.support_y[0], task.node_mask)
                grads = torch.autograd.grad(loss, [p for _, p in named])
                grads, _ = clip_global_norm_tree(
                    dict(zip((k for k, _ in named), grads)), meta_cfg.clip_norm)
                with torch.no_grad():
                    for k, p in named:
                        p.sub_(meta_cfg.inner_lr * grads[k])

            ms = host_ms(torch, inner_step)
            log(f"inner step {dt_name} (forward + backward + clip + SGD, one window): "
                f"{ms:.3f} ms  [{card}]")
            if dt_name == "float32":
                profile_inner_steps(torch, inner_step, card)
            step = make_meta_step(mc, meta_cfg)
            torch.cuda.reset_peak_memory_stats(dev)

            def meta_step():
                nonlocal state
                state, _ = step(state, tasks, g)

            ms = host_ms(torch, meta_step, repeats=2)
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
            log(f"meta step {dt_name} (4 tasks x 90 inner steps + query, grad-accum 2): "
                f"{ms:.1f} ms, peak device memory {peak:.2f} GiB  [{card}]")
    log(f"total {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for name in TPU_KERNELS:
        m = measured[name]
        bound, bound_by = bound_ms(m["bytes"], m["flops"])
        count = launches[name] if name in launches else train_launches[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": TPU_KERNELS[name],
            "launches": count,
            "max_abs_err": m["max_abs_err"],
            "ms": m["ms"],
            "plain_ms": m["plain_ms"],
            "bound_ms": bound,
            "bound_by": bound_by,
            "library_ms": m["library_ms"],
        })
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
