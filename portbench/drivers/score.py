"""Traffic driver `score`: batched scoring in eval mode, a closed loop of
one client, as a long-running scorer of `validate`'s kind runs it.

Set-up: every box's fields from the seed, turned into features and a graph
by the port (`graph.build_region_graph`, `data/preprocess.prepare_features`,
`pad_nodes`) and staged on the card once with its Koppen code, as a scorer
caches them; the port's model (`models/registry.init_model`) holding the
benchmark's weights; `train/supervised.make_predict`; `warmup_requests`
requests.

A request, timed on the host from its start until its predictions are a
numpy array on the host: gather its `windows_per_request` windows on the
card (`data/windows.gather_batch`), `predict`, copy to the host. Requests
cycle over the boxes in a seeded order; each takes distinct anchors drawn
from the seed. Every `check_stride`-th request, from a seeded offset, is
kept and compared, once the window has closed, with the plain reference's
eval forward of the same windows, worked out from the same fields. A
request that raises ends the run: no answer is skipped.

`readings` gives `portbench/control.py` the numbers the limits are set
from, at the kept positions of the stream: a sound program's, the
control's (the reference in TF32 in the program's place), the program's in
bfloat16 and each fault's.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from portbench import inputs
from portbench.harness import Outcome, float32_matmuls
from portbench.reference import compare, models, pipeline
from portbench.trace import Annotations, capture, family_table
from weatherforecast_stgcn_maml_tpu_torch.config import ModelConfig
from weatherforecast_stgcn_maml_tpu_torch.data.preprocess import pad_nodes, prepare_features
from weatherforecast_stgcn_maml_tpu_torch.data.region import RegionData
from weatherforecast_stgcn_maml_tpu_torch.data.windows import WindowSpec, gather_batch
from weatherforecast_stgcn_maml_tpu_torch.graph import build_region_graph
from weatherforecast_stgcn_maml_tpu_torch.models.registry import init_model
from weatherforecast_stgcn_maml_tpu_torch.train.supervised import make_predict

KIND = "predict"
FAULTS = ("answer_altered", "half_batch")
READINGS = ("answer_gap",)


class Requests:
    """The seeded request stream: request i's box and anchors."""

    def __init__(self, seed: int, boxes: int, timesteps: int, window: int, horizon: int,
                 per_request: int):
        self.rng = np.random.default_rng(inputs.subseed(seed, 6))
        self.order = self.rng.permutation(boxes)
        self.lo, self.hi, self.per = window, timesteps - horizon, per_request
        self.anchors: list = []

    def __getitem__(self, i: int):
        while len(self.anchors) <= i:
            self.anchors.append(np.sort(self.rng.choice(
                np.arange(self.lo, self.hi), size=self.per, replace=False)))
        return int(self.order[i % len(self.order)]), self.anchors[i]


def check_offset(seed: int, stride: int) -> int:
    """The first kept request: every `stride`-th from here is compared."""
    return int(np.random.default_rng(inputs.subseed(seed, 7)).integers(stride))


class Program:
    """The port's scorer set up for one run, and its request."""

    def __init__(self, cell, fields, weights):
        device = self.device = cell.device
        self.cell = cell
        self.model_cfg = ModelConfig(**cell.model)
        self.spec = WindowSpec(self.model_cfg.window, self.model_cfg.horizon)
        self.feats, self.a_hat, self.koppen = [], [], []
        for i, f in enumerate(fields):
            region = RegionData(weather=f.weather, times=f.times, lats=f.lats, lons=f.lons,
                                koppen_code=f.koppen_code, name=f"box{i}")
            graph = build_region_graph(f.lats, f.lons, k_neighbors=cell.data["k_neighbors"])
            feats, _ = prepare_features(region)
            self.feats.append(torch.from_numpy(pad_nodes(feats, graph.padded_nodes)).to(device))
            self.a_hat.append(torch.from_numpy(graph.a_hat).to(device))
            self.koppen.append(max(f.koppen_code, 0))
        self.model = init_model(torch.Generator().manual_seed(0), self.model_cfg)
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(weights[name])
        self.model.requires_grad_(False)
        self.model.to(device)
        self.predict = make_predict(self.model_cfg)

    def request(self, box: int, anchors) -> np.ndarray:
        x, _ = gather_batch(self.feats[box], anchors, self.spec)
        out = self.predict(self.model, x, self.a_hat[box], self.koppen[box]).cpu().numpy()
        fault = self.cell.fault
        if fault == "answer_altered":  # one value of the answer changed by 1% of its range
            out[0, 0, 0, 0] += 0.01 * np.abs(out).max()
        elif fault == "half_batch":  # the second half answered with the first half's last
            half = -(-out.shape[0] // 2)
            out[half:] = out[half - 1]
        return out


def reference_answers(cell, fields, kept, *, tf32: bool = False) -> list:
    """The reference's eval forward of each kept request (box, anchors),
    on the real nodes."""
    model = cell.model
    dtype = torch.float64 if model["compute_dtype"] == "float64" else torch.float32
    weights = inputs.weights(model, cell.seed, cell.device)
    p = {k: v.to(dtype) for k, v in weights.items()}
    per_box, out = {}, []
    with float32_matmuls(tf32), torch.no_grad():
        for box, anchors in kept:
            if box not in per_box:
                f = fields[box]
                a_hat = pipeline.adjacency(f.lats, f.lons, cell.data["k_neighbors"])
                per_box[box] = (pipeline.features(f),
                                torch.from_numpy(a_hat).to(cell.device, dtype))
            feats, a_hat = per_box[box]
            x, _ = pipeline.windows(feats, anchors, model["window"], model["horizon"])
            x = torch.from_numpy(x).to(cell.device, dtype)
            out.append(models.forward(model, p, a_hat, x, fields[box].koppen_code)
                       .float().cpu().numpy())
    return out


def run(cell) -> Outcome:
    tr = cell.traffic
    data = dict(cell.data, timesteps=tr["timesteps"])
    t = [time.perf_counter()]
    fields = inputs.fields(tr["boxes"], data, cell.seed)
    t.append(time.perf_counter())
    program = Program(cell, fields, inputs.weights(cell.model, cell.seed, cell.device))
    t.append(time.perf_counter())
    reqs = Requests(cell.seed, len(fields), tr["timesteps"], cell.model["window"],
                    cell.model["horizon"], tr["windows_per_request"])
    stride = int(tr["check_stride"])
    offset = check_offset(cell.seed, stride)
    for i in range(int(tr["warmup_requests"])):
        program.request(*reqs[i])
    if cell.device.type == "cuda":
        torch.cuda.synchronize(cell.device)
    t.append(time.perf_counter())
    cell.note("set-up seconds: inputs {!r}, features, graphs and model {!r}, {} warm-up "
              "requests {!r}".format(t[1] - t[0], t[2] - t[1], tr["warmup_requests"],
                                     t[3] - t[2]))

    base = int(tr["warmup_requests"])
    lat, kept = [], []
    t0 = cell.window_start = time.perf_counter()
    while time.perf_counter() - t0 < cell.seconds:
        i = len(lat)
        box, anchors = reqs[base + i]
        t = time.perf_counter()
        out = program.request(box, anchors)
        lat.append(time.perf_counter() - t)
        if i % stride == offset:
            kept.append((box, anchors, out))
    untraced = {"seconds": time.perf_counter() - t0, "requests": len(lat)}
    trace = None
    if cell.trace:
        n = int(tr["trace_requests"])
        start = base + len(lat)
        trace = capture(lambda: [program.request(*reqs[start + j]) for j in range(n)],
                        Annotations(family_table()))
        cell.note(trace.summary())
    ms = np.asarray(lat) * 1e3
    cell.note(f"requests {len(ms)}: median {float(np.median(ms))!r} ms, p95 "
              f"{float(np.percentile(ms, 95))!r} ms, max {float(ms.max())!r} ms; "
              f"{len(kept)} checked")
    peak = torch.cuda.max_memory_allocated(cell.device) if cell.device.type == "cuda" else 0
    del program
    t_ref = time.perf_counter()
    ref = reference_answers(cell, fields, [(b, a) for b, a, _ in kept])
    cell.note(f"reference {time.perf_counter() - t_ref!r} s for {len(kept)} requests")
    nodes = fields[0].lats.size * fields[0].lons.size
    gaps = [compare.max_rel_error(o[:, :, :nodes, :], r) for (_, _, o), r in zip(kept, ref)]
    layer = {"kind": KIND, "model": cell.model, "nodes": nodes, "k": cell.data["k_neighbors"],
             "windows_per_request": tr["windows_per_request"], "untraced": untraced,
             "trace": trace, "stretch": {"requests": int(tr["trace_requests"])}}
    return Outcome(attempted=len(lat) + (2 * int(tr["trace_requests"]) if cell.trace else 0),
                   failed=0,
                   end_to_end={"predict_p95_ms": float(np.percentile(ms, 95))},
                   checks={"answer_gap": max(gaps) if gaps else float("inf")},
                   memory_peak_bytes=peak, layer=layer)


def readings(cell, controls: bool, count: int):
    """(what, {reading: value}, notes) of `count` requests at the kept
    positions of the stream, no window: a sound program, and with
    `controls` the control (the reference in TF32), the program in bfloat16
    and each fault."""
    tr = cell.traffic
    fields = inputs.fields(tr["boxes"], dict(cell.data, timesteps=tr["timesteps"]), cell.seed)
    reqs = Requests(cell.seed, len(fields), tr["timesteps"], cell.model["window"],
                    cell.model["horizon"], tr["windows_per_request"])
    stride = int(tr["check_stride"])
    offset = check_offset(cell.seed, stride)
    kept = [reqs[int(tr["warmup_requests"]) + offset + j * stride] for j in range(count)]
    ref = reference_answers(cell, fields, kept)
    nodes = fields[0].lats.size * fields[0].lons.size

    def gap(answers):
        return {"answer_gap": max(compare.max_rel_error(a[:, :, :nodes, :], r)
                                  for a, r in zip(answers, ref))}

    def program(fault=None, dtype=None):
        sub = dataclasses.replace(cell, fault=fault, notes=[])
        if dtype:
            sub.config = dict(cell.config, model=dict(cell.model, compute_dtype=dtype))
        prog = Program(sub, fields, inputs.weights(cell.model, cell.seed, cell.device))
        return gap([prog.request(b, a) for b, a in kept]), []

    yield "sound", *program()
    if controls:
        yield "control_tf32", gap(reference_answers(cell, fields, kept, tf32=True)), []
        yield "bfloat16", *program(dtype="bfloat16")
        for fault in FAULTS:
            yield fault, *program(fault=fault)
