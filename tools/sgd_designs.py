#!/usr/bin/env python3
"""The whole-tree clip + SGD update (kernel rows 8 and 9) in three designs on
one card, for choosing and recording the port's.

  python3 tools/sgd_designs.py [CHECKOUT]

imports the port from CHECKOUT (default: this one), builds
tools/sgd_designs.cu with nvcc into .cuda_build/sgd_designs/, and prints
one JSON line. On the reference model's 23 leaves (ModelConfig()), one task
(row 8) and a task axis of 4 (row 9), gradients scaled to a global norm of
30 a task (clip_norm 1.0: clipping on), it holds each design against the
port's plain version (max|diff| / max|ref| within 1e-5, two calls bitwise
equal) and times it:
  kernel  the checkout's `clip_sgd_update` (its own CUDA kernel and
          wrapper);
  coop    one cooperative launch holding g and p in registers across one
          grid barrier;
  pdl4    row 8's two kernels chained by programmatic dependent launch, also
          at V = 4;
and, as the bytes' floor, `stream`: p - lr * g in one pass (no norm: not
the update, only its traffic; not held against plain).
Times: device time (torch.profiler, the sum of the kernels' durations, a
mean over 200 calls; where two kernels overlap, as under pdl, the sum
counts the overlap twice), graph time (20 calls captured in one CUDA graph,
its replays timed by CUDA events, a call's share; the device's wall time
with no host work between calls). Exits 1 where a check fails.
(`tools/step_times.py --sgd-only` compares two checkouts' kernels, in
turns.)
"""

import argparse
import ctypes
import json
import os
import statistics
import struct
import subprocess
import sys

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("checkout", nargs="?",
                    default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
args = parser.parse_args()
sys.path.insert(0, os.path.abspath(args.checkout))

import torch  # noqa: E402

from weatherforecast_stgcn_maml_tpu_torch.config import MetaConfig, ModelConfig  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.models.registry import init_model  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.ops.fused_sgd import (  # noqa: E402
    clip_sgd_update,
    clip_sgd_update_plain,
)

if not torch.cuda.is_available():
    sys.exit("sgd_designs: no CUDA card")
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def build() -> ctypes.CDLL:
    from torch.utils.cpp_extension import CUDA_HOME

    out = os.path.join(ROOT, ".cuda_build", "sgd_designs")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libsgd_designs.so")
    subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
                    "-shared", "-o", lib, os.path.join(HERE, "sgd_designs.cu")], check=True)
    dll = ctypes.CDLL(lib)
    for name in ("design_coop", "design_pdl4", "design_stream"):
        getattr(dll, name).argtypes = [ctypes.c_char_p]
    dll.design_partials.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
    dll.design_partials.restype = ctypes.c_longlong
    return dll


def device_ms(fn, calls=200):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA"))
    if not total:
        raise RuntimeError("the profiler reported no device time")
    return total / calls / 1e3


def graph_ms(fn, calls=20, repeats=10):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def main() -> int:
    dll = build()
    dev = torch.device("cuda", 0)
    meta = MetaConfig()
    lr, max_norm = meta.inner_lr, meta.clip_norm
    model = init_model(torch.Generator().manual_seed(3), ModelConfig(), device=dev)
    leaves = [p.detach() for p in model.parameters()]
    draw = torch.Generator(device=dev).manual_seed(4)
    res = {"checkout": args.checkout, "device": torch.cuda.get_device_name(0)}
    failed = []
    for tasks, row in ((1, "row 8"), (4, "row 9")):
        batched = tasks > 1
        params = leaves if tasks == 1 else [
            torch.stack([p * (1 + 0.1 * v) for v in range(tasks)]) for p in leaves]
        grads = [torch.randn(p.shape, generator=draw, device=dev) for p in params]
        norm = float(torch.sqrt(sum(torch.sum(g * g) for g in grads))) / tasks ** 0.5
        grads = [g * (30.0 / norm) for g in grads]
        n = len(params)
        sizes = [p.numel() // tasks for p in params]
        partials = torch.empty(dll.design_partials(n, (ctypes.c_longlong * n)(*sizes), tasks),
                               device=dev)
        launch = struct.Struct(f"<qqddqq{3 * n}q")

        def design(name):
            def run(ps):
                err = getattr(dll, f"design_{name}")(launch.pack(
                    n, tasks, lr, max_norm, partials.data_ptr(),
                    torch.cuda.current_stream().cuda_stream, *(p.data_ptr() for p in ps),
                    *(g.data_ptr() for g in grads), *sizes))
                if err:
                    raise RuntimeError(f"design {name} failed: CUDA error {err}")
            return run

        designs = {"kernel": lambda ps: clip_sgd_update(ps, grads, lr, max_norm, batched=batched),
                   "coop": design("coop"), "pdl4": design("pdl4")}
        ref = [p.clone() for p in params]
        clip_sgd_update_plain(ref, grads, lr, max_norm, batched=batched)
        for name, run in designs.items():
            outs = []
            for _ in range(2):
                outs.append([p.clone() for p in params])
                run(outs[-1])
            torch.cuda.synchronize()
            rel = max(float((a - r).abs().max() / r.abs().max()) for a, r in zip(outs[0], ref))
            same = all(torch.equal(a, b) for a, b in zip(*outs))
            res[f"{row} {name} max rel err"] = rel
            if rel > 1e-5 or not same:
                failed.append(f"{row} {name}: error {rel:.3e}, bitwise {same}")
            work = [p.clone() for p in params]
            res[f"{row} {name} device ms"] = device_ms(lambda: run(work))
            try:
                res[f"{row} {name} graph ms"] = graph_ms(lambda: run(work))
            except RuntimeError as err:  # a design a CUDA graph does not take
                res[f"{row} {name} graph ms"] = f"capture refused: {str(err).splitlines()[0]}"
        floor = design("stream")  # the traffic alone: p - lr * g, no norm
        res[f"{row} stream device ms"] = device_ms(lambda: floor(work))
        res[f"{row} stream graph ms"] = graph_ms(lambda: floor(work))
    res["failed"] = failed
    print(json.dumps(res), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
