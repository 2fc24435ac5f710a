"""The traced stretches of a run: `torch.profiler` traces of a few steps
or requests, read into device busy time, launches, each family's device
time and the host frames behind the idle gaps (`capture`).

A kernel is attributed to the family of the port's frame that was open on
the launching thread when it was launched: the innermost of the benchmark's
ranges around the port's functions (`annotate`) and of the autograd
engine's backward events of the port's Functions. `families.json` maps
modules (`ops.fused_gcn_train`) or single functions (`models.common:draw_mask`)
of the port to families; a module it does not name is transparent (the
shared GEMM core, `ops.gemm`, takes the family of its caller), and a kernel
with no family frame open goes under `other`.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import json
import os
import sys
import tempfile
import time
import types
from dataclasses import dataclass, field

import torch

PORT = "weatherforecast_stgcn_maml_tpu_torch"
PREFIX = "pb:"
WINDOW = "pb:window"
_FAMILIES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "families.json")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_BACKWARD = "autograd::engine::evaluate_function: "


def family_table() -> dict:
    with open(_FAMILIES) as f:
        return json.load(f)["families"]


class Annotations:
    """Ranges around the port's public functions and methods in the modules
    that `families.json` names, installed into every loaded module of the
    port that refers to them (the traced run only, after its untraced
    part). `labels` maps a range's name and `backward` an autograd
    Function's backward node to its family."""

    def __init__(self, table: dict):
        self.table = table
        self.labels: dict[str, str] = {}
        self.backward: dict[str, str] = {}
        self._installed = False

    def _family(self, short: str, name: str) -> str | None:
        return self.table.get(f"{short}:{name}") or self.table.get(short)

    def install(self) -> None:
        if self._installed:
            return
        self._installed = True
        mods = {n[len(PORT) + 1:]: m for n, m in list(sys.modules.items())
                if n.startswith(PORT + ".") and m is not None}
        swap: dict[int, object] = {}
        for short, mod in mods.items():
            for name, val in list(vars(mod).items()):
                if isinstance(val, type) and val.__module__ == mod.__name__:
                    if issubclass(val, torch.autograd.Function):
                        fam = self._family(short, name)
                        if fam:
                            self.backward[f"{name}Backward"] = fam
                        continue
                    for mname, fn in list(vars(val).items()):
                        fam = self._family(short, f"{name}.{mname}")
                        if fam and self._wrappable(mname, fn):
                            setattr(val, mname, self._wrap(fn, f"{short}.{name}.{mname}", fam))
                    continue
                fam = self._family(short, name)
                if fam and self._wrappable(name, val) and val.__module__ == mod.__name__:
                    swap[id(val)] = self._wrap(val, f"{short}.{name}", fam)
        for mod in mods.values():
            for name, val in list(vars(mod).items()):
                if id(val) in swap and isinstance(val, types.FunctionType):
                    setattr(mod, name, swap[id(val)])

    @staticmethod
    def _wrappable(name: str, fn) -> bool:
        return (isinstance(fn, types.FunctionType) and not name.startswith("_")
                and not inspect.isgeneratorfunction(fn))

    def _wrap(self, fn, label: str, fam: str):
        label = PREFIX + label
        self.labels[label] = fam
        record = torch.autograd.profiler.record_function

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with record(label):
                return fn(*args, **kwargs)

        return wrapper

    def family(self, ev: dict) -> str | None:
        name = ev.get("name", "")
        if ev.get("cat") == "user_annotation":
            return self.labels.get(name)
        if name.startswith(_BACKWARD):
            return self.backward.get(name[len(_BACKWARD):])
        return None


@dataclass
class Trace:
    window_s: float
    busy_s: float
    launches: int  # kernels
    family_s: dict = field(default_factory=dict)  # device seconds by family
    device_ops: list = field(default_factory=list)  # [[name, seconds]] top 10
    idle_gaps: list = field(default_factory=list)  # [[host frame, seconds]] top 10
    unmatched: int = 0  # device ops whose launch was not found
    other_pct: float = 0.0  # share of the busy time that no family claims
    categories: dict = field(default_factory=dict)  # complete events by category
    host_waits: dict = field(default_factory=dict)  # runtime calls that can block the host

    def summary(self) -> str:
        return (f"trace: {self.launches} kernels, {self.unmatched} device ops without a "
                f"launch, device seconds by family {self.family_s} ({self.other_pct!r}% of "
                f"the busy time in no family), events "
                f"{self.categories}, runtime calls that can block the host {self.host_waits}")


def _profile(fn, activities) -> tuple[list, float]:
    """fn() under the profiler inside a `pb:window` range that ends with a
    device synchronise: (the trace's events, the host seconds of the range)."""
    from torch.profiler import profile

    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        with torch.autograd.profiler.record_function(WINDOW):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"], seconds


def capture(fn, annotations: Annotations) -> Trace:
    """Two stretches, each one call of fn(). The first under CUDA activity
    alone, which leaves the host at nearly its untraced pace: busy time,
    window, launches and the top device operations. The second also under
    CPU activity, with the port's ranges installed: each family's device
    time (kernel durations, which the host's pace does not change) and the
    host frames behind the idle gaps (the profiler slows the host there)."""
    from torch.profiler import ProfilerActivity

    events, seconds = _profile(fn, [ProfilerActivity.CUDA])
    device = read(events, annotations)
    annotations.install()
    events, _ = _profile(fn, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    attributed = read(events, annotations)
    return Trace(window_s=seconds, busy_s=device.busy_s, launches=device.launches,
                 family_s=attributed.family_s,
                 device_ops=device.device_ops, idle_gaps=attributed.idle_gaps,
                 unmatched=attributed.unmatched, other_pct=attributed.other_pct,
                 categories=device.categories,
                 host_waits=device.host_waits)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(frames, queries):
    """For each (t, key) of `queries` sorted by t: the innermost of the
    nested `frames` [(start, end, payload)] sorted by start that is open
    at t, or None; {key: payload}."""
    out, stack, i = {}, [], 0
    for t, key in queries:
        while i < len(frames) and frames[i][0] <= t:
            while stack and stack[-1][1] <= frames[i][0]:
                stack.pop()
            stack.append(frames[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out[key] = stack[-1][2] if stack else None
    return out


def read(events: list, annotations: Annotations) -> Trace:
    xs = [e for e in events if e.get("ph") == "X"]
    cats: dict[str, int] = {}
    waits: dict[str, int] = {}
    for e in xs:
        cats[e.get("cat", "")] = cats.get(e.get("cat", ""), 0) + 1
        if e.get("cat") in _LAUNCH_CATS and ("Synchronize" in e["name"] or "Memcpy" in e["name"]):
            waits[e["name"]] = waits.get(e["name"], 0) + 1
    window = [e for e in xs if e.get("name") == WINDOW]
    dev_all = [e for e in xs if e.get("cat") in _DEVICE_CATS]
    if window:
        w0 = float(window[0]["ts"])
        w1 = w0 + float(window[0]["dur"])
    elif dev_all:  # CUDA activity alone: the device operations' span
        w0 = min(float(e["ts"]) for e in dev_all)
        w1 = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in dev_all)
    else:
        raise RuntimeError("the trace holds no window range and no device operation")
    device = [e for e in dev_all
              if float(e["ts"]) + float(e.get("dur", 0.0)) > w0 and float(e["ts"]) < w1]
    launch = {}
    for e in xs:
        if e.get("cat") in _LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = (e["tid"], float(e["ts"]))
    # Family frames and host frames, by thread.
    fam_frames, host_frames = {}, {}
    for e in xs:
        cat = e.get("cat")
        if cat not in ("cpu_op", "user_annotation") or e.get("name") == WINDOW:
            continue
        s, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        fam = annotations.family(e)
        if fam:
            fam_frames.setdefault(e["tid"], []).append((s, end, fam))
        name = e["name"][len(PREFIX):] if e["name"].startswith(PREFIX) else e["name"]
        host_frames.setdefault(e["tid"], []).append((s, end, name))
    for frames in (fam_frames, host_frames):
        for v in frames.values():
            v.sort(key=lambda f: (f[0], -f[1]))

    # Each device op's family, by its launch.
    queries, unmatched = {}, 0
    for i, e in enumerate(device):
        where = launch.get((e.get("args") or {}).get("correlation"))
        if where is None:
            unmatched += 1
            continue
        queries.setdefault(where[0], []).append((where[1], i))
    fam_of = {}
    for tid, qs in queries.items():
        qs.sort()
        fam_of.update(_innermost(fam_frames.get(tid, []), qs))
    by_family: dict[str, list] = {}
    ops: dict[str, float] = {}
    for i, e in enumerate(device):
        s, end = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        fam = fam_of.get(i) or "other"
        by_family.setdefault(fam, []).append((s, end))
        ops[e["name"]] = ops.get(e["name"], 0.0) + (end - s) * 1e-6
    busy = _merge([(float(max(float(e["ts"]), w0)),
                    float(min(float(e["ts"]) + float(e.get("dur", 0.0)), w1))) for e in device])
    busy_s = sum(e - s for s, e in busy) * 1e-6
    family_s = {f: sum(e - s for s, e in _merge(v)) * 1e-6 for f, v in by_family.items()}

    # Idle gaps, each by the innermost host frame open at its start on the
    # thread that launched the device op ending it.
    starts = sorted((float(e["ts"]), i) for i, e in enumerate(device))
    gap_q: dict = {}
    edges = [w0] + [e for _, e in busy]
    nexts = [s for s, _ in busy] + [w1]
    gaps = []
    for g0, g1 in zip(edges, nexts):
        if g1 - g0 <= 0:
            continue
        gaps.append((g0, g1))
    pos = 0
    for gi, (g0, g1) in enumerate(gaps):
        while pos < len(starts) and starts[pos][0] < g1:
            pos += 1
        tid = None
        if pos < len(starts):
            where = launch.get((device[starts[pos][1]].get("args") or {}).get("correlation"))
            tid = where[0] if where else None
        gap_q.setdefault(tid, []).append((g0, gi))
    gap_name = {}
    for tid, qs in gap_q.items():
        qs.sort()
        found = _innermost(host_frames.get(tid, []), qs) if tid is not None else {}
        for _, gi in qs:
            gap_name[gi] = found.get(gi) or "(no host frame)"
    idle: dict[str, float] = {}
    for gi, (g0, g1) in enumerate(gaps):
        idle[gap_name[gi]] = idle.get(gap_name[gi], 0.0) + (g1 - g0) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return Trace(
        window_s=(w1 - w0) * 1e-6, busy_s=busy_s,
        launches=sum(1 for e in device if e.get("cat") == "kernel"),
        family_s=family_s, device_ops=top(ops), idle_gaps=top(idle),
        unmatched=unmatched, categories=cats, host_waits=waits,
        other_pct=100.0 * family_s.get("other", 0.0) / busy_s if busy_s else 0.0,
    )


@contextlib.contextmanager
def host_span(acc: dict, name: str):
    """The benchmark's own span: adds the host seconds of the block to
    acc[name]."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0
