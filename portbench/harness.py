"""Everything a run shares, found by name: the cell in BENCHMARK.json, its
configuration (`configs/<config>.json`), its traffic mix
(`traffic/<traffic>.json`, whose `driver` names `drivers/<driver>.py`),
its limits (`limits/<cell>.json`) and the readers of its per-layer metrics
(`metrics/<metric>.py`). A cell, a configuration, a traffic mix or a
metric is added by adding files and entries, never by editing these.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "weatherforecast_stgcn_maml_tpu")


def _json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT, "BENCHMARK.json")


def catalog() -> dict:
    """BENCHMARK.json's entries and those of `pending.json` (cells measured
    and proven but not yet in BENCHMARK.json), list by list."""
    bench, pending = benchmark(), _json(HERE, "pending.json")
    return {k: bench[k] + pending.get(k, []) for k in
            ("configs", "workloads", "end_to_end", "per_layer")}


def for_cell(entries: list, cell: str) -> list:
    """The metrics of `entries` that `cell` reports."""
    return [m for m in entries if "workloads" not in m or cell in m["workloads"]]


@dataclass
class Cell:
    """One run of one cell: what the driver needs, and where it reports."""

    name: str
    chips: int
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    limits: dict  # limits/<cell>.json: {check name: limit}
    end_to_end: list
    per_layer: list
    seed: int
    seconds: float
    trace: bool
    device: object = None
    fault: str | None = None  # control and tests only: see the drivers
    notes: list = field(default_factory=list)  # stderr lines before the checks
    window_start: float | None = None  # perf_counter when the window opened

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def data(self) -> dict:
        return self.config["data"]

    def note(self, line: str) -> None:
        self.notes.append(line)


def load_cell(name: str, seed: int, seconds: float, trace: bool, *, device=None,
              config: dict | None = None, traffic: dict | None = None) -> Cell:
    """The cell `name` of BENCHMARK.json (or of `pending.json`); `config` /
    `traffic` replace its files' contents (the tests' small sizes)."""
    bench = catalog()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json or pending.json")
    return Cell(
        name=name, chips=entry["chips"],
        config=config or _json(HERE, "configs", entry["config"] + ".json"),
        traffic=traffic or _json(HERE, "traffic", entry["traffic"] + ".json"),
        limits=_json(HERE, "limits", name + ".json")["limits"],
        end_to_end=for_cell(bench["end_to_end"], name),
        per_layer=for_cell(bench["per_layer"], name),
        seed=int(seed), seconds=float(seconds), trace=bool(trace), device=device,
    )


def driver(cell: Cell):
    return importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")


def metric_reader(name: str):
    """The reader module of per-layer metric `name` (metrics/<name>.py)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Outcome:
    """What a driver hands back after its window and its check."""

    attempted: int
    failed: int
    end_to_end: dict  # {metric: value} of the cell's end-to-end metrics but setup_s
    checks: dict  # {reading: value}; the cell's limits file names those compared
    memory_peak_bytes: int
    layer: dict  # the per-layer readers' context (metrics/README in README.md)


def result(cell: Cell, out: Outcome, setup_s: float, device: dict) -> dict:
    """The result line's object; `checks` comes last. A run is correct
    where every request or step it attempted succeeded and every number
    compared lies within its limit."""
    checks = {k: {"value": float(out.checks.get(k, math.inf)), "limit": float(limit)}
              for k, limit in cell.limits.items()}
    correct = bool(checks) and out.failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    if cell.trace:
        trace = out.layer.get("trace")
        for m in cell.per_layer:
            value = metric_reader(m["name"]).read(out.layer)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        if trace is not None:
            device = dict(device, busy_s=trace.busy_s, window_s=trace.window_s)
    else:
        values = dict(out.end_to_end, setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    device = dict(device, memory_peak_bytes=int(out.memory_peak_bytes))
    line = {"correct": correct, "attempted": int(out.attempted), "failed": int(out.failed),
            "metrics": metrics, "device": device}
    trace = out.layer.get("trace") if cell.trace else None
    if trace is not None:
        from portbench.metrics import OTHER_MAX_PCT, attribution_sound

        line["breakdown"] = {"device_ops": trace.device_ops, "idle_gaps": trace.idle_gaps}
        line["attribution"] = {"other_pct": trace.other_pct, "other_max_pct": OTHER_MAX_PCT,
                               "unmatched": trace.unmatched,
                               "rooflines_reported": attribution_sound(trace)}
    line["checks"] = checks
    return line


def check_lines(line: dict) -> list[str]:
    return [f"check {k} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}"
            for k, c in line["checks"].items()]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package (whole names: the port's name begins with the JAX package's)."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


@contextlib.contextmanager
def float32_matmuls(tf32: bool):
    """Float32 products with TF32 off (the reference) or on (its control)."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def load_all() -> None:
    """Import everything a run of any cell loads (the import check)."""
    bench = catalog()
    for w in bench["workloads"]:
        traffic = _json(HERE, "traffic", w["traffic"] + ".json")
        importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    for m in bench["per_layer"]:
        metric_reader(m["name"])
