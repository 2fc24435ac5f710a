"""Traffic driver `meta`: first-order MAML meta-training, one meta step a
call, as the port's engine (`engines/meta_train.py`) drives it.

Set-up: the boxes' fields from the seed (`portbench/inputs.py`), each
turned into a task by the port (`train/tasks.build_task`: graph, features,
windows) and staged on the card once (`stage_tasks`); the port's meta state
(`train/maml.init_meta_state`) holding the benchmark's weights; the chained
meta step (`make_chained_meta_step(make_meta_step(...))`), one epoch a
call, its dropout generator seeded from the run's seed; the port's
difficulty sampler (`train/sampling.DifficultySampler`). The first
`checked_steps` calls run in set-up through the window's own call (they also
warm up every shape); the window takes over that same state.

`readings` gives `portbench/control.py` the numbers the limits are set
from: a sound program's, the control's (the reference in TF32 in the
program's place), the program's in bfloat16 and each fault's.

A call: sample the batch, run the step on it, bring its losses to the host
(`fetch_metrics`, inside the benchmark's span `fetch`), feed the sampler.
`train_windows_per_s` counts the windows of whole meta steps (every
support and query window is one forward and one backward) over the time
from the window's start to the end of its last step.

The check: the plain reference (`portbench/reference/meta.py`) follows the
first `checked_steps` steps from the same inputs on the same card, with
TF32 off. Compared: each step's meta loss, the first step's gradient as
AdamW's first moment holds it after that step, and the parameters' change
over the checked steps, both by the worst leaf.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from portbench import inputs
from portbench.harness import Outcome, float32_matmuls
from portbench.reference import compare, meta as rmeta, pipeline
from portbench.trace import Annotations, capture, family_table, host_span
from weatherforecast_stgcn_maml_tpu_torch.config import DataConfig, MetaConfig, ModelConfig
from weatherforecast_stgcn_maml_tpu_torch.data.region import RegionData
from weatherforecast_stgcn_maml_tpu_torch.train.maml import (
    fetch_metrics,
    init_meta_state,
    make_chained_meta_step,
    make_meta_step,
)
from weatherforecast_stgcn_maml_tpu_torch.train.sampling import DifficultySampler
from weatherforecast_stgcn_maml_tpu_torch.train.tasks import (
    build_task,
    common_padded_nodes,
    stage_tasks,
)

KIND = "train"
FAULTS = ("state_unchanged", "half_batch")
# Every number the check reads; a cell's limits file names those it compares.
READINGS = ("loss_gap", "loss1_gap", "grad_gap", "grad_median_gap", "change_gap",
            "change_median_gap")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The port's meta-training set up for one run, and its call."""

    def __init__(self, cell, fields, weights):
        device = cell.device
        self.cell, self.device = cell, device
        self.model_cfg = ModelConfig(**cell.model)
        self.meta_cfg = MetaConfig(**cell.traffic["meta"])
        regions = [RegionData(weather=f.weather, times=f.times, lats=f.lats, lons=f.lons,
                              koppen_code=f.koppen_code, name=f"box{i}")
                   for i, f in enumerate(fields)]
        data_cfg = DataConfig(k_neighbors=cell.data["k_neighbors"])
        pad = common_padded_nodes(regions)
        built = [build_task(r, self.model_cfg, self.meta_cfg, data_cfg, pad_to=pad).task
                 for r in regions]
        self.staged = stage_tasks(built, device)
        self.state = init_meta_state(torch.Generator().manual_seed(0), self.model_cfg,
                                     self.meta_cfg, device=device)
        if next(self.state.params.parameters()).dtype == torch.float64:
            self.staged = type(self.staged)(
                *(f.double() if f.is_floating_point() else f for f in self.staged))
        with torch.no_grad():
            for name, p in self.state.params.named_parameters():
                p.copy_(weights[name])
        seed = cell.seed
        self.chained = make_chained_meta_step(
            make_meta_step(self.model_cfg, self.meta_cfg),
            lambda e: torch.Generator(device=device).manual_seed(inputs.dropout_seed(seed, e)))
        self.sampler = DifficultySampler(len(built), self.meta_cfg.meta_batch,
                                         ema=self.meta_cfg.difficulty_ema,
                                         seed=inputs.sampler_seed(seed))
        m = self.meta_cfg
        self.windows_per_step = m.meta_batch * (m.inner_epochs * m.inner_batches
                                                + max(1, m.query_batches))
        self.epoch, self.spans = 0, {}

    def call(self):
        """One meta step: (task indices, meta loss)."""
        idx = self.sampler.sample()
        fault = self.cell.fault
        if fault == "half_batch":  # half the tasks, the mean over the rest
            idx = idx[::2]
        if fault == "state_unchanged":
            params = {k: v.detach().clone() for k, v in self.state.params.named_parameters()}
            before = self.state
        state, metrics = self.chained(self.state, self.staged, idx[None], [self.epoch])
        with host_span(self.spans, "fetch"):
            loss, per_task, _ = fetch_metrics(metrics)
        if fault == "state_unchanged":
            with torch.no_grad():
                for k, v in state.params.named_parameters():
                    v.copy_(params[k])
            state = before
        self.state = state
        self.sampler.update(idx, per_task[0])
        self.epoch += 1
        return idx, float(loss[0])


def reference_tasks(cell, fields, device, dtype) -> list:
    meta, model = cell.traffic["meta"], cell.model
    tasks = []
    for f in fields:
        a_hat = pipeline.adjacency(f.lats, f.lons, cell.data["k_neighbors"])
        feats = pipeline.features(f)
        s_anchors, q_anchors = pipeline.task_anchors(
            feats.shape[0], model["window"], model["horizon"], meta)
        sx, sy = pipeline.windows(feats, s_anchors, model["window"], model["horizon"])
        qx, qy = pipeline.windows(feats, q_anchors, model["window"], model["horizon"])
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)  # noqa: E731
        tasks.append(rmeta.Task(t(sx), t(sy), t(qx), t(qy), t(a_hat), int(f.koppen_code),
                                pipeline.padded_nodes(a_hat.shape[0])))
    return tasks


def reference_steps(cell, fields, weights, steps: int, *, tf32: bool = False):
    """The reference's first `steps` meta steps: (task indices, meta losses,
    first moment after step 1, parameters after the last)."""
    model, meta = cell.model, cell.traffic["meta"]
    dtype = torch.float64 if model["compute_dtype"] == "float64" else torch.float32
    with float32_matmuls(tf32):
        tasks = reference_tasks(cell, fields, cell.device, dtype)
        state = rmeta.init_state({k: v.to(dtype) for k, v in weights.items()})
        sampler = rmeta.Sampler(len(tasks), meta["meta_batch"], meta["difficulty_ema"],
                                inputs.sampler_seed(cell.seed))
        idxs, losses, mu1 = [], [], None
        for e in range(steps):
            idx = sampler.sample()
            gen = torch.Generator(device=cell.device).manual_seed(
                inputs.dropout_seed(cell.seed, e))
            state, per = rmeta.meta_step(model, meta, state, tasks, idx, gen)
            sampler.update(idx, per)
            idxs.append(idx)
            losses.append(float(per.mean()))
            if e == 0:
                mu1 = state.mu
    return idxs, losses, mu1, state.params


def checks(cell, weights, prog: dict, ref: tuple) -> dict:
    """READINGS of program snapshots `prog` against a reference run `ref`
    (reference_steps)."""
    idxs, losses, mu1, params = ref
    w = {k: v.to(params[k].dtype) for k, v in weights.items()}
    moving = compare.moving_leaves(mu1)
    cell.note(f"task indices program {[list(map(int, i)) for i in prog['idx']]} "
              f"reference {[list(map(int, i)) for i in idxs]}")
    cell.note(f"meta losses program {prog['losses']} reference {losses}")
    cell.note(f"leaves left out of the change (reference gradient under 1e-3 of the median "
              f"leaf's): {sorted(set(mu1) - moving)}")
    grad = compare.leaf_gaps({k: v.to(mu1[k].dtype) for k, v in prog["mu1"].items()}, mu1)
    change = compare.leaf_gaps({k: prog["params"][k].to(w[k].dtype) - w[k] for k in w},
                               {k: params[k] - w[k] for k in w}, keep=moving)
    worst = lambda g: max(g.values())  # noqa: E731
    out = {
        "loss_gap": compare.rel_gap(prog["losses"], losses),
        "loss1_gap": compare.rel_gap(prog["losses"][:1], losses[:1]),
        "grad_gap": worst(grad), "grad_median_gap": float(np.median(list(grad.values()))),
        "change_gap": worst(change),
        "change_median_gap": float(np.median(list(change.values()))),
    }
    cell.note(f"worst leaves: gradient {max(grad, key=grad.get)}, change "
              f"{max(change, key=change.get)}; readings {out}")
    return out


def first_steps(program: Program, steps: int) -> dict:
    """Run the first `steps` calls and keep what the check reads."""
    snap = {"idx": [], "losses": []}
    for e in range(steps):
        idx, loss = program.call()
        snap["idx"].append(idx)
        snap["losses"].append(loss)
        if e == 0:
            snap["mu1"] = {k: v.detach().clone() for k, v in program.state.opt_state.mu.items()}
    snap["params"] = {k: v.detach().clone()
                      for k, v in program.state.params.named_parameters()}
    return snap


def run(cell) -> Outcome:
    t = [time.perf_counter()]
    fields = inputs.fields(cell.traffic["boxes"], cell.data, cell.seed)
    weights = inputs.weights(cell.model, cell.seed, cell.device)
    t.append(time.perf_counter())
    program = Program(cell, fields, weights)
    t.append(time.perf_counter())
    steps = int(cell.traffic["checked_steps"])
    snap = first_steps(program, steps)
    _sync(cell.device)
    t.append(time.perf_counter())
    cell.note("set-up seconds: inputs {!r}, tasks and state {!r}, first {} steps {!r}".format(
        t[1] - t[0], t[2] - t[1], steps, t[3] - t[2]))

    t0 = cell.window_start = time.perf_counter()
    done = failed = 0
    ends = []
    while time.perf_counter() - t0 < cell.seconds:
        _, loss = program.call()
        ends.append(time.perf_counter())
        done += 1
        failed += not np.isfinite(loss)
    t1 = time.perf_counter()
    cell.note(f"step seconds {np.diff([t0] + ends).round(4).tolist()}")
    untraced = {"seconds": t1 - t0, "windows": done * program.windows_per_step,
                "wait_s": program.spans.get("fetch", 0.0)}
    trace = None
    if cell.trace:
        n = int(cell.traffic["trace_steps"])
        trace = capture(lambda: [program.call() for _ in range(n)],
                        Annotations(family_table()))
        done += 2 * n  # capture runs two stretches
        cell.note(trace.summary())
    rate = done and untraced["windows"] / untraced["seconds"]
    cell.note(f"meta steps {done} in the window ({untraced['seconds']!r} s untraced), "
              f"{program.windows_per_step} windows a step, fetch wait {untraced['wait_s']!r} s")
    peak = torch.cuda.max_memory_allocated(cell.device) if cell.device.type == "cuda" else 0
    per_step = program.windows_per_step
    del program
    t_ref = time.perf_counter()
    ref = reference_steps(cell, fields, weights, steps)
    cell.note(f"reference {time.perf_counter() - t_ref!r} s for {steps} steps")
    layer = {"kind": KIND, "model": cell.model, "nodes": fields[0].lats.size * fields[0].lons.size,
             "k": cell.data["k_neighbors"], "untraced": untraced, "trace": trace,
             "stretch": {"windows": int(cell.traffic["trace_steps"]) * per_step}}
    return Outcome(attempted=done, failed=failed, end_to_end={"train_windows_per_s": rate},
                   checks=checks(cell, weights, snap, ref), memory_peak_bytes=peak,
                   layer=layer)


def readings(cell, controls: bool, count: int):
    """(what, {reading: value}, notes) of the checked steps alone, no
    window: a sound program, and with `controls` the control (the reference
    in TF32), the program in bfloat16 and the half batch (a state left
    unchanged reads 1 and needs no run). `count` is for drivers that read
    many answers; a meta cell reads its checked steps."""
    steps = int(cell.traffic["checked_steps"])
    fields = inputs.fields(cell.traffic["boxes"], cell.data, cell.seed)
    weights = inputs.weights(cell.model, cell.seed, cell.device)
    ref = reference_steps(cell, fields, weights, steps)

    def program(fault=None, dtype=None):
        sub = dataclasses.replace(cell, fault=fault, notes=[])
        if dtype:
            sub.config = dict(cell.config, model=dict(cell.model, compute_dtype=dtype))
        snap = first_steps(Program(sub, fields, weights), steps)
        return checks(sub, weights, snap, ref), sub.notes

    yield "sound", *program()
    if controls:
        idxs, losses, mu1, params = reference_steps(cell, fields, weights, steps, tf32=True)
        snap = {"idx": idxs, "losses": losses, "mu1": mu1, "params": params}
        sub = dataclasses.replace(cell, notes=[])
        yield "control_tf32", checks(sub, weights, snap, ref), sub.notes
        yield "bfloat16", *program(dtype="bfloat16")
        yield "half_batch", *program(fault="half_batch")
