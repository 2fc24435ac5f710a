#!/usr/bin/env python3
"""Times of the GCN kernel rows 6, 7, 12 and 13 in one checkout, beside
their cuBLAS routes, for comparing two checkouts on one card.

  python3 tools/gcn_rows.py [CHECKOUT] [--cpu]

imports the port from CHECKOUT (default: this one) and prints one JSON line.
Float32 at the reference width: rows 6-7 (the training GCN stack, x [24,
512, 24] -> 4 x 256, masks at rate 0.2: the forward, and the backward alone
from the forward's residuals), rows 12-13 (the node-sharded sandwich layer,
hw_full [512, 24, 256], a next layer, a mask, NL = 512, 256 and 128: the
forward, and the backward alone from both cotangents and from g2 alone, as
the encoder's layers below the top send it). For each: the call by CUDA
events (median of 20), its device time by CUDA graph replay (the call
captured once, its replays timed by events) and the host's time to enqueue
it (the card idle before it; median of 20); the kernels one call launches
(torch.profiler) and its `gemm_nn` and `gemm_tn` launches. The
cuBLAS routes are the plain versions (torch.matmul products): row 6
`gcn_stack_train_plain`, row 7 the backward written out below, rows 12-13
`shard_layer_plain` and `shard_bwd_plain`. Run it on two checkouts in
turns (A, B, B, A) in one call on one card. `--cpu` is a dry run (the
plain versions only, no times).
"""

import argparse
import json
import os
import statistics
import sys
import time

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("checkout", nargs="?",
                    default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
parser.add_argument("--cpu", action="store_true", help="dry run on the CPU, no times")
args = parser.parse_args()
sys.path.insert(0, os.path.abspath(args.checkout))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from weatherforecast_stgcn_maml_tpu_torch.config import ModelConfig  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.models.registry import init_model  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_gcn_shard as fgs  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_gcn_train as fgt  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.ops.gemm import gemm_nn, gemm_tn  # noqa: E402

if not args.cpu and not torch.cuda.is_available():
    sys.exit("gcn_rows: no CUDA card (--cpu is a dry run)")
dev = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
REPEATS = 20


def events_ms(fn):
    """Median time of fn() in ms by CUDA events (the host's launch work
    included where the device waits for it)."""
    fn()
    fn()
    times = []
    for _ in range(REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn):
    """fn()'s device time in ms: captured once in a CUDA graph, its replays
    timed by CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    ms = events_ms(graph.replay)
    del graph
    return ms


def enqueue_ms(fn):
    """Median host time of one call of fn() in ms, from its start to its
    return, the card idle before it."""
    fn()
    times = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def kernels_per_call(fn):
    """The device operations (kernels, copies, memsets) one call of fn()
    runs, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if str(e.device_type).endswith("CUDA"))


def measure(name, kernel, library):
    if args.cpu:
        library()
        res[name] = None
        return
    n0, t0 = gemm_nn.launches, gemm_tn.launches
    kernel()
    torch.cuda.synchronize()
    launches = {"gemm_nn_a_call": gemm_nn.launches - n0, "gemm_tn_a_call": gemm_tn.launches - t0}
    res[name] = {
        "ms": events_ms(kernel), "device_ms": graph_ms(kernel), "enqueue_ms": enqueue_ms(kernel),
        "kernels_a_call": kernels_per_call(kernel), **launches,
        "library_ms": events_ms(library), "library_device_ms": graph_ms(library),
    }
    print(f"{name}: {res[name]}", file=sys.stderr, flush=True)


def cublas_row7(g, x, a_hat, weights, masks, h_all, keep):
    """Row 7's function in float32 on torch.matmul: the relu / dropout
    gradient, A_hat^T dz per slice, dW = h_in^T dhw, db, dh = dhw W^T."""
    dh, out = g, []
    for l in reversed(range(len(weights))):
        dz = dh * (h_all[l] > 0)
        if masks is not None and l < masks.shape[0]:
            dz = dz * (masks[l] * (1.0 / keep))
        dhw = torch.matmul(a_hat.t(), dz)
        inp = x if l == 0 else h_all[l - 1]
        out.append(inp.reshape(-1, inp.shape[-1]).t() @ dhw.reshape(-1, dhw.shape[-1]))
        out.append(dz.sum(dim=(0, 1)))
        dh = torch.matmul(dhw, weights[l].t())
    return dh, out


def row13(*args):
    """Row 13 alone: `backward_schedule` on the card's pieces, or in a
    checkout from before it, `_bwd_cuda`."""
    if hasattr(fgs, "backward_schedule"):
        return fgs.backward_schedule(*args, fgt.CARD_PIECES)
    return fgs._bwd_cuda(*args)


cfg = ModelConfig()
model = init_model(torch.Generator().manual_seed(0), cfg, device=dev)
layers = model.encoder.layers
draw = np.random.default_rng(0)
n, w_len, hid, keep = 512, cfg.window, cfg.hidden_channels, 0.8


def card(shape, scale=1.0):
    return torch.from_numpy((draw.standard_normal(shape) * scale).astype(np.float32)).to(dev)


def mask(shape):
    return torch.from_numpy((draw.uniform(size=shape) >= 0.2).astype(np.int8)).to(dev)


res = {"checkout": args.checkout, "device": "cpu" if args.cpu else torch.cuda.get_device_name(0)}
t_start = time.perf_counter()
a_hat = card((n, n), n ** -0.5).abs()
x = card((w_len, n, cfg.in_channels))
masks = mask((cfg.gcn_layers - 1, w_len, n, hid))
weights = [layer.w.detach() for layer in layers]
biases = [layer.b.detach() for layer in layers]
dt = torch.float32
with torch.no_grad():
    if args.cpu:
        h_all = [fgt.gcn_stack_train_plain(layers[:l + 1], a_hat, x, masks, keep, dt)
                 for l in range(len(layers))]
    else:
        h_all = fgt._forward(x, a_hat, weights, biases, masks, 1.0 / keep, dt)
    g = card(h_all[-1].shape)
    measure("row 6", lambda: fgt.gcn_stack_train(layers, a_hat, x, masks=masks, keep=keep),
            lambda: fgt.gcn_stack_train_plain(layers, a_hat, x, masks, keep, dt))
    measure("row 7", lambda: fgt._backward(g, x, a_hat, weights, masks, h_all, 1.0 / keep, dt),
            lambda: cublas_row7(g, x, a_hat, weights, masks, h_all, keep))
    hw_full = card((n, w_len, hid))
    w_next, b = weights[1], biases[0]
    for nl in (n, n // 2, n // 4):
        a_rows = a_hat[:nl].contiguous()
        m = mask((nl, w_len, hid))
        measure(f"row 12 NL={nl}",
                lambda: fgs.gcn_shard_layer(hw_full, a_rows, b, w_next, m, keep, dt),
                lambda: fgs.shard_layer_plain(hw_full, a_rows, b, w_next, m, keep, dt))
        h_post, _ = fgs.shard_layer_plain(hw_full, a_rows, b, w_next, m, keep, dt)
        g1, g2 = card((nl, w_len, hid)), card((nl, w_len, hid))
        for cts, c1 in (("", g1), (" from g2", None)):
            measure(f"row 13{cts} NL={nl}",
                    lambda: row13(c1, g2, h_post, a_rows, w_next, m, 1.0 / keep, dt, dt),
                    lambda: fgs.shard_bwd_plain(c1, g2, h_post, a_rows, w_next, m, keep, dt, dt))
res["seconds"] = time.perf_counter() - t_start
print(json.dumps(res), flush=True)
