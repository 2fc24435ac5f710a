"""The host pipeline of the reference, in plain numpy: graph, features and
windows of one box, worked out again from its raw fields.

Only the real nodes are kept: padding nodes have no edges and are masked
out of every loss, so they change no real node's output. The node count
that the program pads to is still needed for one thing, the shapes in which
the dropout masks are drawn (`reference/models.py`).
"""

from __future__ import annotations

import numpy as np

NODE_ALIGN = 128  # the program pads node counts to a multiple of this


def padded_nodes(n: int) -> int:
    return -(-n // NODE_ALIGN) * NODE_ALIGN


def adjacency(lats, lons, k: int) -> np.ndarray:
    """GCN-normalised adjacency D^-1/2 (A + I) D^-1/2 [N, N] float32 of the
    lat-major grid: A[dst, src] = 1 for each of dst's k nearest nodes in
    (lat, lon) degrees, self excluded, ties to the lower index."""
    lat_g, lon_g = np.meshgrid(np.asarray(lats), np.asarray(lons), indexing="ij")
    pos = np.stack([lat_g.ravel(), lon_g.ravel()], axis=-1).astype(np.float64)
    n = len(pos)
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    d2[np.arange(n), np.arange(n)] = np.inf
    nbr = np.argsort(d2, axis=1, kind="stable")[:, :k]
    a = np.zeros((n, n))
    a[np.repeat(np.arange(n), k), nbr.ravel()] = 1.0
    a += np.eye(n)
    inv = 1.0 / np.sqrt(a.sum(axis=1))
    return (inv[:, None] * a * inv[None, :]).astype(np.float32)


def time_features(times) -> np.ndarray:
    """[T, 4]: sin / cos of 2 pi day-of-year / 365.25 and of 2 pi hour / 24."""
    ts = np.asarray(times).astype("datetime64[s]")
    day = (ts.astype("datetime64[D]") - ts.astype("datetime64[Y]").astype("datetime64[D]"))
    doy = day.astype(np.int64) + 1
    hour = (ts - ts.astype("datetime64[D]")).astype(np.int64) / 3600.0
    yp, dp = 2 * np.pi * doy / 365.25, 2 * np.pi * hour / 24.0
    return np.stack([np.sin(yp), np.cos(yp), np.sin(dp), np.cos(dp)], -1).astype(np.float32)


def features(field) -> np.ndarray:
    """[T, N, 16] float32: the 12 variables z-scored over (time, nodes) in
    float64 (std + 1e-8), then the 4 time features."""
    t = field.weather.shape[0]
    w = field.weather.reshape(t, -1, field.weather.shape[-1]).astype(np.float64)
    mean, std = w.mean(axis=(0, 1)), w.std(axis=(0, 1)) + 1e-8
    z = ((w - mean) / std).astype(np.float32)
    tf = np.broadcast_to(time_features(field.times)[:, None, :], (t, z.shape[1], 4))
    return np.concatenate([z, tf], axis=-1)


def windows(feats: np.ndarray, anchors, window: int, horizon: int, n_vars: int = 12):
    """x [S, W, N, C] = feats[a - W : a], y [S, H, N, 12] = feats[a + 1 :
    a + 1 + H, :, :12] for each anchor a."""
    x = np.stack([feats[a - window:a] for a in anchors])
    y = np.stack([feats[a + 1:a + 1 + horizon, :, :n_vars] for a in anchors])
    return x, y


def task_anchors(timesteps: int, window: int, horizon: int, meta: dict):
    """(support anchors, query anchors) of a meta-training task: the first
    `max_samples_per_task` windows split at `support_fraction` in time, the
    inner loop's `inner_batches` support windows and `query_batches` query
    windows cycled from the start of each part."""
    total = min(meta["max_samples_per_task"], timesteps - horizon - window)
    cut = int(meta["support_fraction"] * total)
    support = np.resize(np.arange(0, cut), meta["inner_batches"])
    query = np.resize(np.arange(cut, total), max(1, meta["query_batches"]))
    return window + support, window + query
