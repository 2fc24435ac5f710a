"""Difficulty-weighted task sampling for the meta-training loop.

A copy of `weatherforecast_stgcn_maml_tpu/train/sampling.py`: with the same
seed and the same per-task losses it draws the same task indices.
Difficulties are an EMA of each task's own query loss. Host-side numpy:
sampling happens between device steps.
"""

from __future__ import annotations

import numpy as np


class DifficultySampler:
    """Loss-proportional sampling without replacement with EMA difficulties."""

    def __init__(self, num_tasks: int, batch_size: int, ema: float = 0.9, seed: int = 0):
        self.num_tasks = num_tasks
        self.batch_size = min(batch_size, num_tasks)
        self.ema = ema
        self.difficulty = np.zeros(num_tasks, dtype=np.float64)
        self.seen = np.zeros(num_tasks, dtype=bool)
        self._rng = np.random.default_rng(seed)

    def sample(self) -> np.ndarray:
        """Sample task indices; uniform until difficulties exist."""
        if self.batch_size == self.num_tasks:
            return np.arange(self.num_tasks)
        total = self.difficulty.sum()
        if not self.seen.any() or not np.isfinite(total) or total <= 0:
            # Non-finite difficulties can only appear via a restored legacy
            # checkpoint (update() filters them) — fall back to uniform.
            probs = None
        else:
            # Unseen tasks get the mean difficulty so they are not starved.
            d = self.difficulty.copy()
            mean_seen = d[self.seen].mean()
            d[~self.seen] = mean_seen
            if np.count_nonzero(d) < self.batch_size:
                # Fewer positive-probability entries than the batch needs
                # (e.g. query losses collapsed to 0 on degenerate regions):
                # Generator.choice(replace=False) would crash. Blend in a
                # uniform floor so every task stays sampleable.
                d = d + max(d.sum(), 1.0) / self.num_tasks
            probs = d / d.sum()
        return self._rng.choice(
            self.num_tasks, size=self.batch_size, replace=False, p=probs
        )

    def update(self, indices: np.ndarray, losses: np.ndarray) -> None:
        """EMA-update difficulties of the sampled tasks with their own
        query losses."""
        for i, loss in zip(np.asarray(indices), np.asarray(losses)):
            if not np.isfinite(loss):
                # A diverged epoch must not poison the sampler: NaN/inf in
                # `difficulty` makes every later sample() (and any resume
                # that restores the array) crash in Generator.choice.
                continue
            if self.seen[i]:
                self.difficulty[i] = (
                    self.ema * self.difficulty[i] + (1.0 - self.ema) * float(loss)
                )
            else:
                self.difficulty[i] = float(loss)
                self.seen[i] = True
