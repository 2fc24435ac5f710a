"""Timing spans and device traces.

Counterpart of `weatherforecast_stgcn_maml_tpu/utils/profiling.py`: an
accumulating named-span timer, a profiler context that writes a Chrome
trace, and a completion barrier for the devices a tree of tensors lives on.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


@dataclass
class Timer:
    """Accumulating named span timer (host wall clock)."""

    spans: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t0

    def summary(self) -> dict:
        return dict(self.spans)


@contextlib.contextmanager
def trace_span(log_dir: str | None):
    """Profile the block with `torch.profiler` (CPU activity, and CUDA where
    a card is present) and write its Chrome trace, `trace.json`, into
    `log_dir`; a no-op when `log_dir` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def block_until_ready(tree):
    """Wait until the work queued for every CUDA tensor of `tree` (tensors
    in nested dicts, lists and tuples) is done; returns `tree`."""
    for device in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(device)
    return tree
