"""Small sizes of the benchmark's cells, for the CPU tests: the cells'
own drivers, configurations and traffic with widths, depths, boxes and
steps cut so that a run takes a second on one CPU thread."""

import json
import os

import torch

from portbench import harness


def small_cell(name: str, *, dtype: str = "float32", fault=None, seconds: float = 0.3,
               seed: int = 3_000_000_019):
    bench = harness.catalog()
    entry = next(w for w in bench["workloads"] if w["name"] == name)
    with open(os.path.join(harness.HERE, "configs", entry["config"] + ".json")) as f:
        config = json.load(f)
    with open(os.path.join(harness.HERE, "traffic", entry["traffic"] + ".json")) as f:
        traffic = json.load(f)
    config["model"].update(hidden_channels=16, gcn_layers=2, lstm_hidden=8, lstm_layers=2,
                           window=8, horizon=4, compute_dtype=dtype)
    config["data"].update(resolution=1.0, timesteps=80)
    traffic["boxes"] = traffic["boxes"][:5]
    if traffic["driver"] == "meta":
        traffic["meta"].update(inner_epochs=1, inner_batches=2)
    else:
        traffic.update(timesteps=20, warmup_requests=2, check_stride=4)
    cell = harness.load_cell(name, seed, seconds, False, device=torch.device("cpu"),
                             config=config, traffic=traffic)
    cell.fault = fault
    return cell


def run_small(cell) -> dict:
    """A run of `cell` past the look for a card: its result line."""
    out = harness.driver(cell).run(cell)
    return harness.result(cell, out, 0.0, {"platform": "cpu", "kind": "cpu", "count": 1})
