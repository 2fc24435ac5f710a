"""Structured metrics logging (a copy of the JAX package's
`utils/metrics.py`): the meta-training CSV (`epoch,meta_loss,learning_rate`)
and a JSONL stream for structured records (per-task losses, task indices,
timings).
"""

from __future__ import annotations

import json
import math
import os
from typing import Iterable


class CsvLogger:
    def __init__(self, path: str, columns: Iterable[str]):
        self.path = path
        self.columns = list(columns)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        if not os.path.exists(path):
            with open(path, "w") as f:
                f.write(",".join(self.columns) + "\n")

    def log(self, **values) -> None:
        with open(self.path, "a") as f:
            f.write(",".join(str(values.get(c, "")) for c in self.columns) + "\n")


class JsonlLogger:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, record: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(_finite(record), default=float) + "\n")


def _finite(obj):
    """Replace non-finite floats with strings: json.dumps would otherwise
    emit bare `Infinity`/`NaN` tokens (invalid JSON — jq/pandas reject the
    whole artifact) when e.g. a short-history validation returns inf MSE."""
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    try:
        f = float(obj)
    except (TypeError, ValueError):
        return obj
    if obj is True or obj is False or isinstance(obj, str):
        return obj
    return obj if math.isfinite(f) else str(f)
