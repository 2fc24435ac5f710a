#!/usr/bin/env python3
"""Step times of the PyTorch port in one checkout, for comparing two
checkouts on one card.

  python3 tools/step_times.py [CHECKOUT] [--cpu]

imports the port from CHECKOUT (default: this one) and prints one JSON line:
the float32 FO inner step (one window, forward + backward + fused clip +
SGD) and the same with `model.lstm_kernel=pallas`, each by the host clock
(median of 20, ending in a synchronize) and by the device's busy time
(torch.profiler, mean of 5), the FO meta step at `MetaConfig()` defaults
(4 tasks x 90 inner steps; the median of 3 after one warm-up step) and the
node-sharded meta step on a 1 x 1 mesh (a NCCL group of one; its own
warm-up, the median of 3), and one
call of the serving GCN stack (kernel row 1, [72, 512, 24] -> 4 x 256) in
float32 and bfloat16. Run it on two checkouts in turns (A, B, B, A) in one call on one
card: the card's host varies between calls. `--cpu` is a dry run of the
same code on the CPU (the plain versions, one inner step a task, gloo; no
times).
"""

import argparse
import dataclasses
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

import torch  # noqa: E402

from weatherforecast_stgcn_maml_tpu_torch.config import (  # noqa: E402
    META_TRAIN_REGIONS,
    DataConfig,
    MetaConfig,
    ModelConfig,
)
from weatherforecast_stgcn_maml_tpu_torch.engines.data_source import get_region_data  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.graph import build_region_graph  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.models.losses import masked_mse  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.models.registry import apply_model, init_model  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.ops.fused_gcn import fused_gcn_stack  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.ops.fused_sgd import clip_sgd_update  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.parallel import distributed  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.parallel.mesh import make_mesh_2d  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.parallel.meta_sp import (  # noqa: E402
    make_shardmap_meta_step_2d,
)
from weatherforecast_stgcn_maml_tpu_torch.train.maml import (  # noqa: E402
    init_meta_state,
    make_meta_step,
)
from weatherforecast_stgcn_maml_tpu_torch.train.optimizers import leaf_order  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.train.tasks import (  # noqa: E402
    build_meta_tasks,
    stage_tasks,
    task_at,
)

if not args.cpu and not torch.cuda.is_available():
    sys.exit("step_times: no CUDA card (--cpu is a dry run)")
dev = torch.device("cpu") if args.cpu else torch.device("cuda", 0)


def sync():
    if not args.cpu:
        torch.cuda.synchronize()


def host_ms(fn, repeats=20):
    """Median wall time of fn() in ms, each run ending in a synchronize."""
    fn()
    if args.cpu:
        return None
    fn()
    times = []
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def busy_ms(fn, steps=5):
    """The device's busy time of fn() in ms: its kernels' times
    (torch.profiler), a mean over `steps` calls."""
    if args.cpu:
        return None
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        sync()
    return sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")) / steps / 1e3


meta_cfg, data_cfg = MetaConfig(), DataConfig()
if args.cpu:
    meta_cfg = dataclasses.replace(meta_cfg, inner_epochs=1, inner_batches=1)
res = {"checkout": args.checkout, "device": "cpu" if args.cpu else torch.cuda.get_device_name(0)}
t_start = time.perf_counter()
regions = [get_region_data(box, data_cfg.train_years, data_cfg, tag="train", name=f"region{i}")
           for i, box in enumerate(META_TRAIN_REGIONS[:4])]
for route, mc in (("default", ModelConfig()), ("pallas", ModelConfig(lstm_kernel="pallas"))):
    tasks = stage_tasks([b.task for b in build_meta_tasks(regions, mc, meta_cfg, data_cfg)], dev)
    state = init_meta_state(torch.Generator().manual_seed(1), mc, meta_cfg, device=dev)
    task = task_at(tasks, 0)
    params = [p for _, p in sorted(state.params.named_parameters(),
                                   key=lambda kv: leaf_order(kv[0]))]
    g = torch.Generator(device=dev).manual_seed(2)

    def inner_step():
        loss = masked_mse(apply_model(state.params, task.a_hat, task.support_x[0], task.koppen,
                                      mc, train=True, generator=g),
                          task.support_y[0], task.node_mask)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            clip_sgd_update(params, grads, meta_cfg.inner_lr, meta_cfg.clip_norm)

    res[f"{route} inner step ms"] = host_ms(inner_step)
    res[f"{route} inner step device busy ms"] = busy_ms(inner_step)
    if route == "default":
        distributed.ensure_process_group("gloo" if args.cpu else "nccl")
        sharded = make_shardmap_meta_step_2d(mc, meta_cfg, make_mesh_2d(1, 1, dev))
        for name, step, key in (("meta step ms", make_meta_step(mc, meta_cfg), g),
                                ("sharded meta step ms", sharded, (7, 1))):
            step(state, tasks, key)
            times = []
            for _ in range(1 if args.cpu else 3):
                sync()
                t0 = time.perf_counter()
                step(state, tasks, key)
                sync()
                times.append((time.perf_counter() - t0) * 1e3)
            res[name] = None if args.cpu else statistics.median(times)

cfg = ModelConfig()
model = init_model(torch.Generator().manual_seed(0), cfg, device=dev)
a_hat = torch.from_numpy(
    build_region_graph(regions[0].lats, regions[0].lons, k_neighbors=4).a_hat).to(dev)
x = torch.randn((3 * cfg.window, a_hat.shape[0], cfg.in_channels),
                generator=torch.Generator().manual_seed(3)).to(dev)
with torch.inference_mode():
    for dt in (torch.float32, torch.bfloat16):
        res[f"row 1 {str(dt)[6:]} call ms"] = host_ms(
            lambda: fused_gcn_stack(model.encoder.layers, a_hat, x, compute_dtype=dt))
res["seconds"] = time.perf_counter() - t_start
torch.distributed.destroy_process_group()
print(json.dumps(res), flush=True)
