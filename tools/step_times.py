#!/usr/bin/env python3
"""Step times of the PyTorch port in one checkout, for comparing two
checkouts on one card.

  python3 tools/step_times.py [CHECKOUT] [--cpu] [--eval-only] [--sgd-only]
                               [--vbatch-only]

imports the port from CHECKOUT (default: this one) and prints one JSON
line: the eval LSTM stack's two entries alone (rows 2 and 20 at validate's
[1536, 24, 256] and the forecast's [512, 24, 256], 4 layers of 128, float32
and bfloat16) by CUDA events, by CUDA graph replay and by the host's time
to enqueue a call, cuDNN's LSTM forward beside them by events and graph
replay (`--sgd-only` instead times only the whole-tree clip + SGD update,
rows 8 and 9 on the reference model's 23 leaves, one task and 4: device
time by torch.profiler, by CUDA events and by graph replay, the host's
time to enqueue a call with the card idle, and the float32 FO inner step
by the host clock and the device's busy time; after holding each row
against its plain version, two calls bitwise equal and a graph replay of
one call equal to an eager call; it exits 1 where one of these fails;
`--vbatch-only` instead times only the task-batched paths: row 17 alone,
from row 16's residuals in its dtype (masks 0.2, 4 layers of 128), at V = 2
x 512 rows and at the fleet's V = 3 x 1024 rows (three regions of two
windows), float32 and bfloat16, by CUDA events and by graph replay; then,
under `_VBATCH`, the lockstep FO meta step at `MetaConfig()` defaults on
one device, on a dp mesh of one rank and on a 1 x 1 dp x sp mesh (a NCCL
group of one), each the median of 3 after one warm-up step, and one fleet
epoch of three cold regions (40 steps of batch 2: rows 16-17 at V = 3 x
1024, the heads, Adam), the median of 3 after one warm-up epoch, all by
the host clock), and
row 20's train-mode call (forward and backward through
autograd, [1024, 24, 256]: the adaptation step's rows) by events; where the
checkout has the 32-row forward plan (`FWD_WIDE_TILE`), rows 2 and 20 at
1536 rows also under the 16-row plan (three waves) and the forward
recurrence alone (24 steps) at 512, 1024 and 1536 rows under each plan by
graph replay (`--eval-only` stops there); the float32 FO inner step (one
window, forward + backward + fused clip + SGD), the same with `model.lstm_kernel=pallas` and the float32 SO
inner step (the kernel route's inner gradient and its fhvp Hessian-vector
product, one window) and the FO inner step with `_MERGED_GATES = False`
(rows 14-15), each by the host clock (median of 20, ending in a
synchronize) and by the device's busy time (torch.profiler, mean of 5), the
SO meta step (fhvp, median of 2 after one warm-up step), the FO meta step
at `MetaConfig()` defaults (4 tasks x 90 inner steps), the same with the
micro-batch's tasks in lockstep (`_VBATCH`: kernel rows 16-17 and 9) and
the node-sharded meta step on a 1 x 1 mesh (a NCCL group of one), each the
median of 3 after one warm-up step with its peak device memory (GiB, the
most of the 3); one lockstep inner step (2 tasks, one window each: rows
6-7, 16-17 and 9) by the host clock and the device's busy time; the
task-batched LSTM stack's forward alone (row 16 at V = 2: x [2 x 512, 24,
256], 4 layers of 128, masks at rate 0.2; float32 and bfloat16) by CUDA
events (median of 20), by CUDA graph replay and by the host's time to
enqueue a call, and its backward (row 17, from row 16's float32 residuals)
by events and by graph replay; the
merged stack's training forward alone (row 4: x [512, 24, 256] as the
model's [T, B, C] view, 4 layers of 128, masks at rate 0.2) and the
unmerged-gates forward alone (row 14, the same weights as separate Wx and
Wh arrays) the same ways, with the host's time to enqueue a call (median of
20) and cuDNN's LSTM forward beside them by events and by CUDA graph
replay; the tangent of the merged stack's forward alone (row 10 at x [24,
512, 256], 4 layers of 128, masks at rate 0.2, from row 4 at the same
point) and of its backward (row 11, from rows 4, 10 and 5) by events, by
CUDA graph replay and by the host's time to enqueue a call; one layer's
recurrence alone (row 18, the `lstm_kernel=pallas` route's forward: xp
[24, 512, 512], its gates kept) and its backward (row 19, from row 18's
residuals) the same ways; the merged stack's training backward alone
(row 5, from row 4's residuals) and the unmerged one (row 15, from row 14's)
the same ways and by part (CUDA events around each piece of their
schedules: recurrences, gate and input products, the weight gradients);
and one call of the serving
GCN stack (kernel row 1, [72, 512, 24] -> 4 x 256) in float32 and
bfloat16. Run it on two checkouts in
turns (A, B, B, A) in one call on one card: the card's host varies between
calls. `--cpu` is a dry run of the same code on the CPU (the plain
versions, one inner step a task, gloo; no times).
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
parser.add_argument("--eval-only", action="store_true", help="rows 2 and 20 alone, then stop")
parser.add_argument("--sgd-only", action="store_true", help="rows 8 and 9 alone, then stop")
parser.add_argument("--vbatch-only", action="store_true",
                    help="the task-batched (_VBATCH) paths alone, then stop")
args = parser.parse_args()
sys.path.insert(0, os.path.abspath(args.checkout))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from weatherforecast_stgcn_maml_tpu_torch.config import (  # noqa: E402
    META_TRAIN_REGIONS,
    DataConfig,
    MetaConfig,
    ModelConfig,
)
from weatherforecast_stgcn_maml_tpu_torch.engines.data_source import get_region_data  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.graph import build_region_graph  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.models.common import draw_mask  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.models.hybrid import apply_hybrid_tasks  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.models.losses import masked_mse  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.models.lstm import init_lstm  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.models.registry import (  # noqa: E402
    apply_model,
    draw_masks,
    init_model,
)
from weatherforecast_stgcn_maml_tpu_torch.ops import (  # noqa: E402
    fused_lstm_hvp,
    fused_lstm_stack,
    lstm_scan,
)
from weatherforecast_stgcn_maml_tpu_torch.ops.fused_gcn import fused_gcn_stack  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.ops.fused_lstm import (  # noqa: E402
    fused_lstm_last_hidden,
)
from weatherforecast_stgcn_maml_tpu_torch.ops.fused_sgd import (  # noqa: E402
    clip_sgd_update,
    clip_sgd_update_plain,
)
from weatherforecast_stgcn_maml_tpu_torch.parallel import distributed  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.parallel.mesh import make_mesh_2d  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.parallel.meta_sp import (  # noqa: E402
    make_shardmap_meta_step_2d,
)
from weatherforecast_stgcn_maml_tpu_torch.train.maml import (  # noqa: E402
    init_meta_state,
    inner_sgd_update_tasks,
    make_meta_step,
)
from weatherforecast_stgcn_maml_tpu_torch.train.optimizers import leaf_order  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.train.so_fused import (  # noqa: E402
    make_grad_loss_fused,
    plain_route,
    support_loss,
)
from weatherforecast_stgcn_maml_tpu_torch.train.so_grad import make_so_grad  # noqa: E402
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


def enqueue_ms(fn, repeats=20):
    """Median host time of one call of fn() in ms, from its start to its
    return, the card idle before it."""
    fn()
    times = []
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    sync()
    return statistics.median(times)


def events_ms(fn, repeats=20):
    """Median time of fn() in ms by CUDA events."""
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


def parts_ms(run, card, repeats=20):
    """A layer-by-layer LSTM backward's time by part: run(pieces) on
    `card`'s pieces (a `fused_lstm_stack.SplitPieces`), each piece between
    two CUDA events, medians of `repeats` runs. The weight gradients are
    every piece that forms them, of either checkout's schedule: the TN
    products and their partial sums, or one piece after the layer loop."""
    marks = []
    labels = {"recurrence": "recurrences", "weight_grads": "weight gradients",
              "product_tn": "weight gradients", "sum_splits": "weight gradients"}

    def timed(fn, name):
        def call(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            marks.append((labels.get(name) or ("gate products" if kw.get("epilogue") == "gates"
                                               else "input products"), start, end))
            return out
        return call

    pieces = dataclasses.replace(card, **{f.name: timed(getattr(card, f.name), f.name)
                                          for f in dataclasses.fields(card)})
    runs = []
    for i in range(repeats + 2):
        marks.clear()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run(pieces)
        end.record()
        torch.cuda.synchronize()
        if i >= 2:  # after two warm-up runs
            part = {"total": start.elapsed_time(end)}
            for name, s, e in marks:
                part[name] = part.get(name, 0.0) + s.elapsed_time(e)
            runs.append(part)
    return {k: statistics.median(r[k] for r in runs) for k in runs[0]}


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


def eval_rows():
    """Rows 2 and 20 alone (the module docstring), into `res`."""
    cfg = ModelConfig()
    hid, lh, n_l, t_len = cfg.hidden_channels, cfg.lstm_hidden, cfg.lstm_layers, cfg.window
    fls = fused_lstm_stack
    lstm = init_lstm(torch.Generator().manual_seed(7), hid, lh, n_l).to(dev)
    draw = torch.Generator(device=dev).manual_seed(8)
    cudnn = torch.nn.LSTM(hid, lh, n_l, batch_first=True).to(dev)
    torch.backends.cudnn.allow_tf32 = False
    wide = hasattr(fls, "FWD_WIDE_TILE")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def plan16(hidden, rows, itemsize, sms, tasks=1):  # today's tiles of at most 16 rows
        args = (hidden, rows, sms, tasks,
                lambda hcp, rb: fls.scan_fwd_smem(hidden, hcp, rb, itemsize),
                "forward recurrence holds Wh")
        try:  # a checkout whose plans carry k_res, the resident K-rows
            return fls._cluster_plan(*args, k_rows=hidden)
        except TypeError:
            return fls._cluster_plan(*args)

    plans = {"": None, " plan16": plan16} if wide else {"": None}
    for rows in (1536, 512):
        x = torch.randn((rows, t_len, hid), generator=draw, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            d = str(dt)[6:]
            for tag, plan in plans.items():
                if plan and (rows, dt) != (1536, torch.float32):
                    continue
                saved = fls.forward_plan
                fls.forward_plan = plan or saved
                try:
                    with torch.no_grad():
                        for row, fn in (
                                ("row 2", lambda: fls.lstm_stack_last_all(lstm.layers, x,
                                                                          compute_dtype=dt)),
                                ("row 20", lambda: fused_lstm_last_hidden(lstm.layers, x,
                                                                          compute_dtype=dt))):
                            name = f"{row} {d} [{rows}]{tag}"
                            res[f"{name} ms"] = events_ms(fn)
                            res[f"{name} device ms"] = graph_ms(fn)
                            res[f"{name} enqueue ms"] = enqueue_ms(fn)
                finally:
                    fls.forward_plan = saved
            lib = cudnn.to(dt)
            with torch.no_grad():
                res[f"cuDNN forward {d} [{rows}] ms"] = events_ms(lambda: lib(x.to(dt)))
                res[f"cuDNN forward {d} [{rows}] device ms"] = graph_ms(lambda: lib(x.to(dt)))
    cudnn.float()
    # Row 20 in train mode, the adaptation step's rows (2 windows).
    x = torch.randn((1024, t_len, hid), generator=draw, device=dev, requires_grad=True)
    params = [p for layer in lstm.layers for p in (layer.wx, layer.wh, layer.b)]

    def row20_train():
        out = fused_lstm_last_hidden(lstm.layers, x)
        torch.autograd.grad(out.sum(), [x, *params])

    res["row 20 train float32 [1024] ms"] = events_ms(row20_train)
    if wide:  # the forward recurrence alone, 24 steps: a step's time by rows a cluster
        wh = lstm.layers[0].wh.detach()
        bias = lstm.layers[0].b.detach()
        for rows in (512, 1024, 1536):
            xp = torch.randn((t_len, rows, 4 * lh), generator=draw, device=dev)
            h_out = torch.empty((t_len, rows, lh), device=dev)
            for tag, plan in plans.items():
                cs, hcp, rb = (plan or fls.forward_plan)(lh, rows, 4, sms)[:3]
                if plan and (cs, hcp, rb) == fls.forward_plan(lh, rows, 4, sms)[:3]:
                    continue
                saved = fls.forward_plan
                fls.forward_plan = plan or saved
                try:
                    ms = graph_ms(lambda: fls._forward_recurrence_card(  # in place on xp
                        xp, wh, bias, torch.float32, h_out, h_out))
                finally:
                    fls.forward_plan = saved
                res[f"recurrence float32 [{rows}] plan {(cs, hcp, rb)} device ms"] = ms


def sgd_rows():
    """Rows 8 and 9 alone and the FO inner step (the module docstring), into
    `res`; the names of the checks that failed."""
    lr, max_norm = meta_cfg.inner_lr, meta_cfg.clip_norm
    model = init_model(torch.Generator().manual_seed(3), ModelConfig(), device=dev)
    leaves = [p.detach() for p in model.parameters()]
    draw = torch.Generator(device=dev).manual_seed(4)
    failed = []

    def inputs(shapes, tasks, scale):
        params = [torch.randn((tasks, *s) if tasks > 1 else s, generator=draw, device=dev)
                  for s in shapes]
        grads = [torch.randn(p.shape, generator=draw, device=dev) for p in params]
        norm = float(torch.sqrt(sum(torch.sum(g * g) for g in grads))) / tasks ** 0.5
        return params, [g * (scale / norm) for g in grads]

    def hold(name, params, grads, tasks):
        """Kernel vs plain (1e-5 relative), two calls bitwise equal, one call
        replayed from a CUDA graph equal to an eager call."""
        batched = tasks > 1
        runs = []
        for _ in range(2):
            runs.append([p.clone() for p in params])
            clip_sgd_update(runs[-1], grads, lr, max_norm, batched=batched)
        ref = [p.clone() for p in params]
        clip_sgd_update_plain(ref, grads, lr, max_norm, batched=batched)
        rel = max(float((a - r).abs().max() / r.abs().max()) for a, r in zip(runs[0], ref))
        res[f"{name} max rel err"] = rel
        if rel > 1e-5:
            failed.append(f"{name}: error {rel:.3e}")
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            failed.append(f"{name}: two calls differ")
        replayed = [p.clone() for p in params]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side, capture_error_mode="relaxed"):
            clip_sgd_update(replayed, grads, lr, max_norm, batched=batched)
        graph.replay()
        sync()
        if not all(torch.equal(a, b) for a, b in zip(replayed, runs[0])):
            failed.append(f"{name}: a graph replay differs from an eager call")

    with torch.no_grad():
        for tasks, row in ((1, "row 8"), (4, "row 9")):
            params, grads = inputs([p.shape for p in leaves], tasks, 30.0)
            for scale in (0.5, 30.0):
                hold(f"{row} grad norm {scale}", params, [g * (scale / 30.0) for g in grads],
                     tasks)

            def fn():
                clip_sgd_update(params, grads, lr, max_norm, batched=tasks > 1)

            res[f"{row} device ms"] = busy_ms(fn, steps=50)
            res[f"{row} ms"] = events_ms(fn)
            res[f"{row} graph ms"] = graph_ms(fn)
            res[f"{row} enqueue ms"] = enqueue_ms(fn, repeats=200)
    regions = [get_region_data(box, data_cfg.train_years, data_cfg, tag="train",
                               name=f"region{i}") for i, box in enumerate(META_TRAIN_REGIONS[:4])]
    mc = ModelConfig()
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

    res["default inner step ms"] = host_ms(inner_step)
    res["default inner step device busy ms"] = busy_ms(inner_step)
    return failed


def vbatch_rows():
    """Row 17 and the task-batched steps alone (the module docstring), into
    `res`."""
    from weatherforecast_stgcn_maml_tpu_torch.config import ADAPTATION_REGIONS
    from weatherforecast_stgcn_maml_tpu_torch.data.preprocess import pad_nodes, prepare_features
    from weatherforecast_stgcn_maml_tpu_torch.data.windows import WindowSpec
    from weatherforecast_stgcn_maml_tpu_torch.parallel.fleet_mesh import (
        make_fleet_epoch_runner,
        stack_fleet,
    )
    from weatherforecast_stgcn_maml_tpu_torch.parallel.meta_dp import make_parallel_meta_step
    from weatherforecast_stgcn_maml_tpu_torch.train.optimizers import adaptation_optimizer

    fls = fused_lstm_stack
    cfg = ModelConfig()
    hid, lh, n_l, w_len = cfg.hidden_channels, cfg.lstm_hidden, cfg.lstm_layers, cfg.window
    if not args.cpu:  # row 17 alone: one task's split plan against V tasks' in the parent
        draw = torch.Generator(device=dev).manual_seed(9)
        bound = lh ** -0.5
        for nv, rows in ((2, 512), (3, 1024)):
            x_v = torch.randn((nv, w_len, rows, hid), generator=draw, device=dev)
            w0, wr, b2d = (torch.empty(shape, device=dev).uniform_(-bound, bound, generator=draw)
                           for shape in ((nv, hid + lh, 4 * lh), (nv, n_l - 1, 2 * lh, 4 * lh),
                                         (nv, n_l, 4 * lh)))
            m = draw_mask(draw, (nv, n_l - 1, w_len, rows, lh), 0.2, dev)
            g_v = torch.randn((nv, rows, lh), generator=draw, device=dev)
            with torch.no_grad():
                for dt in (torch.float32, torch.bfloat16):
                    fwd = fls.tasks_forward(x_v, m, 0.8, dt, w0, wr, b2d)

                    def row17():
                        fls.tasks_backward(g_v, x_v, *fwd[1:], w0, wr, m, 0.8, dt)

                    name = f"row 17 {str(dt)[6:]} V {nv} x {rows}"
                    res[f"{name} ms"] = events_ms(row17)
                    res[f"{name} device ms"] = graph_ms(row17)
                    del fwd
            del x_v, m, g_v, w0, wr, b2d
    regions = [get_region_data(box, data_cfg.train_years, data_cfg, tag="train",
                               name=f"region{i}") for i, box in enumerate(META_TRAIN_REGIONS[:4])]
    tasks = stage_tasks([b.task for b in build_meta_tasks(regions, cfg, meta_cfg, data_cfg)], dev)
    state = init_meta_state(torch.Generator().manual_seed(1), cfg, meta_cfg, device=dev)
    distributed.ensure_process_group("gloo" if args.cpu else "nccl")
    g = torch.Generator(device=dev).manual_seed(2)
    steps = (("lockstep meta step", make_meta_step(cfg, meta_cfg), g),
             ("dp lockstep meta step",
              make_parallel_meta_step(cfg, meta_cfg, make_mesh_2d(1, 1, dev, axis_names=("dp",))),
              (7, 1)),
             ("dp x sp lockstep meta step",
              make_shardmap_meta_step_2d(cfg, meta_cfg, make_mesh_2d(1, 1, dev)), (7, 1)))
    # One fleet epoch of three cold regions, from one seeded template.
    boxes = dict((name, box) for box, name in ADAPTATION_REGIONS)
    cold = ("Moscow", "NorthSiberia", "Afghanistan")
    datas = [get_region_data(boxes[r], data_cfg.adapt_years, data_cfg, tag="adapt", name=r)
             for r in cold]
    graph = build_region_graph(datas[0].lats, datas[0].lons, k_neighbors=4)
    n = graph.a_hat.shape[0]
    feats = torch.from_numpy(np.stack([pad_nodes(prepare_features(d)[0], n)
                                       for d in datas])).to(dev)
    template = init_model(torch.Generator().manual_seed(0), cfg, device=dev)
    tx, lr0 = adaptation_optimizer("Moscow")
    spec = WindowSpec(cfg.window, cfg.horizon)
    nb = 1 if args.cpu else 40
    anchors = (spec.window + np.arange(2 * nb)).reshape(nb, 2)
    a_hat3 = torch.from_numpy(graph.a_hat).to(dev).expand(3, n, n).contiguous()
    mask3 = torch.from_numpy(graph.node_mask).to(dev).expand(3, n).contiguous()
    kop3 = [max(d.koppen_code, 0) for d in datas]
    run_fleet = make_fleet_epoch_runner(cfg, tx, spec, template)
    params3, _ = stack_fleet([dict(template.named_parameters())] * 3, None, dev)
    states3 = [tx.init({k: p[v] for k, p in params3.items()}) for v in range(3)]
    gens = [torch.Generator(device=dev).manual_seed(v) for v in range(3)]

    def fleet_epoch(state, tasks, key):
        run_fleet(params3, states3, feats, np.stack([anchors] * 3), a_hat3, mask3, kop3,
                  [lr0] * 3, gens)

    fls._VBATCH = True
    try:
        for name, step, key in (*steps, ("fleet epoch", fleet_epoch, None)):
            step(state, tasks, key)
            times = []
            for _ in range(1 if args.cpu else 3):
                sync()
                t0 = time.perf_counter()
                step(state, tasks, key)
                sync()
                times.append((time.perf_counter() - t0) * 1e3)
            res[f"{name} ms"] = None if args.cpu else statistics.median(times)
    finally:
        fls._VBATCH = False


if args.vbatch_only:
    vbatch_rows()
    res["seconds"] = time.perf_counter() - t_start
    torch.distributed.destroy_process_group()
    print(json.dumps(res), flush=True)
    sys.exit(0)
if args.sgd_only:
    failed = [] if args.cpu else sgd_rows()
    res["failed"] = failed
    res["seconds"] = time.perf_counter() - t_start
    print(json.dumps(res), flush=True)
    sys.exit(1 if failed else 0)
if not args.cpu:
    eval_rows()
if args.eval_only:
    res["seconds"] = time.perf_counter() - t_start
    print(json.dumps(res), flush=True)
    sys.exit(0)
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
        serial = make_meta_step(mc, meta_cfg)

        def lockstep(state, tasks, key):
            fused_lstm_stack._VBATCH = True
            try:
                serial(state, tasks, key)
            finally:
                fused_lstm_stack._VBATCH = False

        for name, step, key in (("meta step", serial, g), ("lockstep meta step", lockstep, g),
                                ("sharded meta step", sharded, (7, 1))):
            step(state, tasks, key)
            times, peaks = [], []
            for _ in range(1 if args.cpu else 3):
                sync()
                if not args.cpu:
                    torch.cuda.reset_peak_memory_stats(dev)
                t0 = time.perf_counter()
                step(state, tasks, key)
                sync()
                times.append((time.perf_counter() - t0) * 1e3)
                peaks.append(None if args.cpu else torch.cuda.max_memory_allocated(dev) / 2**30)
            res[f"{name} ms"] = None if args.cpu else statistics.median(times)
            res[f"{name} peak GiB"] = None if args.cpu else max(peaks)
        res["lockstep / serial"] = (None if args.cpu
                                    else res["lockstep meta step ms"] / res["meta step ms"])
        # One lockstep inner step: 2 tasks, one window each, forward +
        # backward + batched clip + SGD (rows 6-7, 16-17 and 9).
        micro = type(tasks)(*(f[:2] for f in tasks))
        named = sorted(state.params.named_parameters(), key=lambda kv: leaf_order(kv[0]))
        fast = [p.detach().unsqueeze(0).repeat(2, *[1] * p.dim()).requires_grad_(True)
                for _, p in named]

        def lockstep_inner_step():
            x = micro.support_x[:, 0]
            preds = apply_hybrid_tasks(dict(zip((k for k, _ in named), fast)), micro.a_hat, x,
                                       micro.koppen, mc, masks=draw_masks(mc, g, x))
            loss = sum(masked_mse(preds[v], micro.support_y[v, 0], micro.node_mask[v])
                       for v in range(2))
            inner_sgd_update_tasks(fast, list(torch.autograd.grad(loss, fast)), meta_cfg)

        res["lockstep inner step ms"] = host_ms(lockstep_inner_step)
        res["lockstep inner step device busy ms"] = busy_ms(lockstep_inner_step)
        del micro, fast
        # The SO inner step: the inner gradient on the kernel route and its
        # Hessian-vector product (fhvp: rows 4-7 and 10-11), one window.
        so_cfg = dataclasses.replace(meta_cfg, second_order=True)
        so_state = init_meta_state(torch.Generator().manual_seed(1), mc, so_cfg, device=dev)
        inner_grad = make_so_grad(support_loss(so_state.params, mc),
                                  support_loss(so_state.params, plain_route(mc)), "fhvp",
                                  make_grad_loss_fused(so_state.params, mc))
        so_p = {k: v.detach().clone().requires_grad_(True)
                for k, v in so_state.params.named_parameters()}
        draw = torch.Generator().manual_seed(40)
        so_ct = [torch.randn(v.shape, generator=draw).to(dev) for v in so_p.values()]
        aux = (task.support_x[0], task.support_y[0], task.a_hat, task.koppen, task.node_mask)

        def so_inner_step():
            grads = inner_grad(so_p, aux, draw_masks(mc, g, aux[0]))
            torch.autograd.grad(list(grads.values()), list(so_p.values()), so_ct)

        res["SO inner step ms"] = host_ms(so_inner_step)
        res["SO inner step device busy ms"] = busy_ms(so_inner_step)
        so_step = make_meta_step(mc, so_cfg)
        so_step(so_state, tasks, g)
        times = []
        for _ in range(1 if args.cpu else 2):
            sync()
            t0 = time.perf_counter()
            so_step(so_state, tasks, g)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        res["SO meta step ms"] = None if args.cpu else statistics.median(times)
        del so_state, so_p, so_ct, so_step
        # The unmerged-gates inner step (`_MERGED_GATES = False`: rows 14-15).
        fused_lstm_stack._MERGED_GATES = False
        try:
            res["unmerged inner step ms"] = host_ms(inner_step)
            res["unmerged inner step device busy ms"] = busy_ms(inner_step)
        finally:
            fused_lstm_stack._MERGED_GATES = True

cfg = ModelConfig()
if not args.cpu:  # rows 16 and 17 alone at V = 2 (row 17 from row 16's residuals; masks 0.2)
    nv, n, lh, n_l = 2, 512, cfg.lstm_hidden, cfg.lstm_layers
    draw = torch.Generator(device=dev).manual_seed(5)
    x_v = torch.randn((nv, cfg.window, n, cfg.hidden_channels), generator=draw, device=dev)
    bound = lh ** -0.5
    w0, wr, b2d = (torch.empty(shape, device=dev).uniform_(-bound, bound, generator=draw)
                   for shape in ((nv, cfg.hidden_channels + lh, 4 * lh),
                                 (nv, n_l - 1, 2 * lh, 4 * lh), (nv, n_l, 4 * lh)))
    m = draw_mask(draw, (nv, n_l - 1, cfg.window, n, lh), 0.2, dev)
    g_v = torch.randn((nv, n, lh), generator=draw, device=dev)
    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):

            def row16():
                fused_lstm_stack.tasks_forward(x_v, m, 0.8, dt, w0, wr, b2d)

            res[f"row 16 {str(dt)[6:]} ms"] = events_ms(row16)
            res[f"row 16 {str(dt)[6:]} device ms"] = graph_ms(row16)
            res[f"row 16 {str(dt)[6:]} enqueue ms"] = enqueue_ms(row16)
        fwd = fused_lstm_stack.tasks_forward(x_v, m, 0.8, torch.float32, w0, wr, b2d)

        def row17():
            fused_lstm_stack.tasks_backward(g_v, x_v, *fwd[1:], w0, wr, m, 0.8, torch.float32)

        res["row 17 ms"] = events_ms(row17)
        res["row 17 device ms"] = graph_ms(row17)
    del fwd, x_v
model = init_model(torch.Generator().manual_seed(0), cfg, device=dev)
a_hat = torch.from_numpy(
    build_region_graph(regions[0].lats, regions[0].lons, k_neighbors=4).a_hat).to(dev)
x = torch.randn((3 * cfg.window, a_hat.shape[0], cfg.in_channels),
                generator=torch.Generator().manual_seed(3)).to(dev)
with torch.inference_mode():
    for dt in (torch.float32, torch.bfloat16):
        res[f"row 1 {str(dt)[6:]} call ms"] = host_ms(
            lambda: fused_gcn_stack(model.encoder.layers, a_hat, x, compute_dtype=dt))
if not args.cpu:  # rows 4 and 14 alone, beside cuDNN's forward; rows 10, 11 and 18 alone
    n, lh, n_l, hid = 512, cfg.lstm_hidden, cfg.lstm_layers, cfg.hidden_channels
    draw = torch.Generator(device=dev).manual_seed(6)
    x4 = torch.randn((n, cfg.window, hid), generator=draw, device=dev)
    bound = lh ** -0.5
    ks = [(hid if l == 0 else lh) + lh for l in range(n_l)]
    wcat, twcat = ([torch.empty((k, 4 * lh), device=dev).uniform_(-bound, bound, generator=draw)
                    for k in ks] for _ in range(2))
    b2d, tb2d = (torch.empty((n_l, 4 * lh), device=dev).uniform_(-bound, bound, generator=draw)
                 for _ in range(2))
    # Row 14's weights: the same as separate Wx and Wh arrays.
    split_w = (wcat[0][:hid], torch.stack([w[:lh] for w in wcat[1:]]),
               torch.stack([w[lh:] if l else w[hid:] for l, w in enumerate(wcat)]), b2d)
    m = draw_mask(draw, (n_l - 1, cfg.window, n, lh), 0.2, dev)
    x_tbc = x4.transpose(0, 1)
    tx, g_r, tg_r = (torch.randn(shape, generator=draw, device=dev)
                     for shape in ((cfg.window, n, hid), (n, lh), (n, lh)))
    xp18 = torch.randn((cfg.window, n, 4 * lh), generator=draw, device=dev)
    wh18 = wcat[1][lh:]
    g19 = torch.randn((cfg.window, n, lh), generator=draw, device=dev)
    cudnn = torch.nn.LSTM(hid, lh, n_l, batch_first=True).to(dev)
    torch.backends.cudnn.allow_tf32 = False
    fh = fused_lstm_hvp
    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):

            def row4():
                fused_lstm_stack.train_forward(x_tbc, m, 0.8, dt, b2d, wcat)

            def row14():
                fused_lstm_stack.split_forward(x_tbc, *split_w, m, 0.8, dt)

            x_c = x_tbc.contiguous()
            _, h_all, c_all, gates = fh.stack_fwd(x_c, wcat, b2d, m, 0.8, dt)
            _, th_all, tc_all, tgates = fh.hvp_stack_fwd(x_c, tx, wcat, twcat, b2d, tb2d, m, 0.8,
                                                         dt, res=(h_all, c_all, gates))
            bwd_res = fh.stack_bwd(g_r, x_c, h_all, c_all, gates, wcat, m, 0.8, dt)[3:]

            def row10():
                fh.hvp_stack_fwd(x_c, tx, wcat, twcat, b2d, tb2d, m, 0.8, dt,
                                 res=(h_all, c_all, gates))

            def row11():
                fh.hvp_stack_bwd(g_r, tg_r, x_c, tx, h_all, th_all, c_all, tc_all, gates, tgates,
                                 wcat, twcat, m, 0.8, dt, res=bwd_res)

            def row18():
                lstm_scan.scan_forward(xp18, wh18, dt, True)

            res18 = lstm_scan.scan_forward(xp18, wh18, dt, True)

            def row19():
                lstm_scan.scan_backward(g19, *res18, wh18, dt)

            def row5(pieces=None):
                if pieces is None:
                    fused_lstm_stack.train_backward(g_r, x_c, h_all, c_all, gates, wcat, m, 0.8,
                                                    dt)
                else:
                    fused_lstm_stack.merged_backward_schedule(g_r, x_c, h_all, c_all, gates, wcat,
                                                              m, 0.8, dt, pieces)

            res14 = fused_lstm_stack.split_forward(x_c, *split_w, m, 0.8, dt)[1:]

            def row15(pieces=None):
                if pieces is None:
                    fused_lstm_stack.split_backward(g_r, x_c, *res14, *split_w, m, 0.8, dt)
                else:
                    fused_lstm_stack.split_backward_schedule(g_r, x_c, *res14, *split_w, m, 0.8,
                                                             dt, pieces)

            for row, fn in (("row 4", row4), ("row 14", row14), ("row 10", row10),
                            ("row 11", row11), ("row 18", row18), ("row 19", row19),
                            ("row 5", row5), ("row 15", row15)):
                name = f"{row} {str(dt)[6:]}"
                res[f"{name} ms"] = events_ms(fn)
                res[f"{name} device ms"] = graph_ms(fn)
                res[f"{name} enqueue ms"] = enqueue_ms(fn)
            for row, fn in (("row 5", row5), ("row 15", row15)):
                res[f"{row} {str(dt)[6:]} parts ms"] = parts_ms(fn, fused_lstm_stack.CARD_PIECES)
            del h_all, c_all, gates, th_all, tc_all, tgates, bwd_res, res18, res14
            lib = cudnn.to(dt)
            res[f"cuDNN forward {str(dt)[6:]} ms"] = events_ms(lambda: lib(x4.to(dt)))
            res[f"cuDNN forward {str(dt)[6:]} device ms"] = graph_ms(lambda: lib(x4.to(dt)))
    del x4, wcat, twcat, cudnn, xp18
res["seconds"] = time.perf_counter() - t_start
torch.distributed.destroy_process_group()
print(json.dumps(res), flush=True)
