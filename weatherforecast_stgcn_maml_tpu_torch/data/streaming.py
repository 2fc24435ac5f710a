"""Chunked streaming of long feature histories to the device (a copy of the
JAX package's `data/streaming.py`).

Adaptation keeps the whole `[T, N, C]` region tensor on the device unless
`adapt.max_device_timesteps` bounds it. Then the anchor range splits into
temporal chunks whose features move to the device once per epoch;
consecutive chunks overlap by `window + horizon` timesteps so every training
window still exists exactly once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from weatherforecast_stgcn_maml_tpu_torch.data.windows import WindowSpec


@dataclass(frozen=True)
class Chunk:
    """One temporal slice [start, stop) of the feature tensor. Its anchors
    are local indices into the slice (global = start + local)."""

    start: int
    stop: int

    def local_anchors(self, global_anchors: np.ndarray, spec: WindowSpec):
        g = np.asarray(global_anchors)
        mine = g[(g - spec.window >= self.start) & (g + spec.horizon < self.stop)]
        return mine - self.start


def plan_chunks(
    num_timesteps: int, spec: WindowSpec, max_device_timesteps: int
) -> list[Chunk]:
    """Split [0, T) into chunks of <= max_device_timesteps overlapping by
    window + horizon; every chunk has the same length (the last slides
    back), and each global anchor belongs to the first chunk that covers it
    (`assign_anchors`)."""
    t = num_timesteps
    need = spec.window + spec.horizon + 1
    if max_device_timesteps <= 0 or t <= max_device_timesteps:
        return [Chunk(0, t)]
    if max_device_timesteps < need:
        raise ValueError(
            f"max_device_timesteps={max_device_timesteps} cannot hold a "
            f"single window+horizon ({need})"
        )
    chunks = []
    stride = max_device_timesteps - (spec.window + spec.horizon)
    start = 0
    while True:
        stop = min(t, start + max_device_timesteps)
        if stop == t:
            chunks.append(Chunk(t - max_device_timesteps, t))
            return chunks
        chunks.append(Chunk(start, stop))
        start += stride


def assign_anchors(
    chunks: list[Chunk], global_anchors: np.ndarray, spec: WindowSpec
) -> list[np.ndarray]:
    """Partition global anchors among chunks (first eligible chunk wins);
    returns each chunk's local anchors."""
    remaining = set(np.asarray(global_anchors).tolist())
    out = []
    for ch in chunks:
        local = ch.local_anchors(np.array(sorted(remaining)), spec)
        out.append(local)
        remaining -= set((local + ch.start).tolist())
    if remaining:
        raise AssertionError(f"anchors not covered by any chunk: {sorted(remaining)[:5]}")
    return out
