"""The plain reference of first-order MAML meta-training (Finn et al. 2017,
first-order approximation; the reference repo's `train_hybrid_maml_v5.py`
loop), in plain torch.

A meta step samples `meta_batch` tasks (regions) by difficulty, splits
them into `grad_accum` micro-batches, and for each task: copies the
meta-parameters, takes `inner_epochs * inner_batches` SGD steps on its
support windows (window s % S at step s; global-norm clip, then p - lr g),
and differentiates the query loss at the adapted parameters. Each micro-
batch's mean gradient feeds one global-norm clip and AdamW update (optax's
decoupled form, p - lr (adam + wd p)) under the cosine warm-restart
schedule, stepped per update.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import models

B1, B2, EPS = 0.9, 0.999, 1e-8


class Sampler:
    """Loss-proportional task sampling without replacement, difficulties an
    EMA of each task's query loss; uniform until a loss is seen, unseen
    tasks at the mean of the seen."""

    def __init__(self, n: int, batch: int, ema: float, seed: int):
        self.n, self.batch, self.ema = n, min(batch, n), ema
        self.d = np.zeros(n)
        self.seen = np.zeros(n, bool)
        self.rng = np.random.default_rng(seed)

    def sample(self) -> np.ndarray:
        if self.batch == self.n:
            return np.arange(self.n)
        p = None
        if self.seen.any() and np.isfinite(self.d.sum()) and self.d.sum() > 0:
            d = self.d.copy()
            d[~self.seen] = d[self.seen].mean()
            if np.count_nonzero(d) < self.batch:
                d = d + max(d.sum(), 1.0) / self.n
            p = d / d.sum()
        return self.rng.choice(self.n, size=self.batch, replace=False, p=p)

    def update(self, idx, losses) -> None:
        for i, loss in zip(idx, losses):
            if not np.isfinite(loss):
                continue
            self.d[i] = self.ema * self.d[i] + (1 - self.ema) * loss if self.seen[i] else loss
            self.seen[i] = True


def schedule(meta: dict, count: int) -> float:
    """SGDR: cycles of t0, t0 * t_mult, ... epochs, grad_accum updates an
    epoch, evaluated in float32."""
    f = np.float32
    epoch = f(count) / f(max(1, meta["grad_accum"]))
    t0, tm = f(meta["cosine_t0"]), f(meta["cosine_t_mult"])
    if meta["cosine_t_mult"] == 1:
        t_cur, t_i = np.mod(epoch, t0), t0
    else:
        k = np.floor(np.log(epoch / t0 * (tm - f(1)) + f(1)) / np.log(tm))
        t_cur, t_i = epoch - t0 * (tm ** k - f(1)) / (tm - f(1)), t0 * tm ** k
    cos = f(0.5) * (f(1) + np.cos(f(math.pi) * t_cur / t_i))
    return float(f(meta["eta_min"]) + (f(meta["outer_lr"]) - f(meta["eta_min"])) * cos)


def clip(grads: dict, max_norm: float) -> dict:
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    scale = torch.where(norm > max_norm, max_norm / (norm + 1e-6), torch.ones_like(norm))
    return {k: g * scale for k, g in grads.items()}


class Task(NamedTuple):
    """One region on the device: support / query windows of the real nodes,
    its adjacency and Koppen code, and the node count the program pads to."""

    sx: torch.Tensor
    sy: torch.Tensor
    qx: torch.Tensor
    qy: torch.Tensor
    a_hat: torch.Tensor
    koppen: int
    n_pad: int


class MetaState(NamedTuple):
    params: dict
    mu: dict
    nu: dict
    count: int


def init_state(weights: dict) -> MetaState:
    params = {k: v.detach().clone() for k, v in weights.items()}
    return MetaState(params, {k: torch.zeros_like(v) for k, v in params.items()},
                     {k: torch.zeros_like(v) for k, v in params.items()}, 0)


def _loss(model, p, task, x, y, gen):
    masks = models.draw_masks(model, gen, task.n_pad, x.device)
    return models.masked_mse(models.forward(model, p, task.a_hat, x, task.koppen, masks), y)


def task_gradient(model: dict, meta: dict, params: dict, task: Task, gen):
    """(query loss, its gradient at the adapted parameters) of one task."""
    fast = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    names = list(fast)
    s_count = task.sx.shape[0]
    for s in range(meta["inner_epochs"] * s_count):
        i = s % s_count
        loss = _loss(model, fast, task, task.sx[i], task.sy[i], gen)
        grads = clip(dict(zip(names, torch.autograd.grad(loss, [fast[k] for k in names]))),
                     meta["clip_norm"])
        with torch.no_grad():
            for k in names:
                fast[k].sub_(meta["inner_lr"] * grads[k])
    q = max(1, min(meta["query_batches"], task.qx.shape[0]))
    qgen = gen if meta["query_train_mode"] else None
    loss = torch.stack([_loss(model, fast, task, task.qx[i], task.qy[i], qgen)
                        for i in range(q)]).mean()
    grads = torch.autograd.grad(loss, [fast[k] for k in names])
    return loss.detach(), dict(zip(names, grads))


@torch.no_grad()
def adamw(meta: dict, state: MetaState, grads: dict) -> MetaState:
    grads = clip(grads, meta["clip_norm"])
    count = state.count + 1
    lr = schedule(meta, state.count)
    params, mu, nu = {}, {}, {}
    for k, p in state.params.items():
        g = grads[k]
        mu[k] = B1 * state.mu[k] + (1 - B1) * g
        nu[k] = B2 * state.nu[k] + (1 - B2) * g * g
        u = (mu[k] / (1 - B1 ** count)) / (torch.sqrt(nu[k] / (1 - B2 ** count)) + EPS)
        params[k] = p - lr * (u + meta["weight_decay"] * p)
    return MetaState(params, mu, nu, count)


def meta_step(model: dict, meta: dict, state: MetaState, tasks: list, idx, gen):
    """One meta step on tasks[idx]: (new state, per-task query losses)."""
    per = len(idx) // max(1, min(meta["grad_accum"], len(idx)))
    losses = []
    for u in range(0, len(idx), per):
        total = None
        for i in idx[u:u + per]:
            loss, grads = task_gradient(model, meta, state.params, tasks[i], gen)
            losses.append(float(loss))
            total = grads if total is None else {k: total[k] + grads[k] for k in total}
        state = adamw(meta, state, {k: g / per for k, g in total.items()})
    return state, np.asarray(losses)
