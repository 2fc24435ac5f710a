"""Meta optimizer: global-norm clip, then AdamW with optax's semantics, under
the cosine warm-restart schedule; and the clip the inner SGD uses.

A functional optimizer over named parameters and a state (count, mu, nu),
the counterpart of `weatherforecast_stgcn_maml_tpu/train/optimizers.py`
(`meta_optimizer`: `clip_by_global_norm_torch` chained with
`optax.adamw`). `torch.optim.AdamW` is not used: it decays as
p * (1 - lr * wd) before the Adam step, which rounds differently from
optax's p - lr * (adam + wd * p).
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple

import numpy as np
import torch

from weatherforecast_stgcn_maml_tpu_torch.config import MetaConfig

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adamw defaults


def leaf_order(name: str) -> tuple:
    """Sort key putting state_dict names in the JAX parameter tree's leaf
    order (dict keys sorted, list indices numeric)."""
    return tuple(int(p) if p.isdigit() else p for p in name.split("."))


def clip_global_norm_tree(
    grads: Mapping[str, torch.Tensor], max_norm: float
) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """torch's clip_grad_norm_ semantics: scale by max_norm / (norm + 1e-6)
    only when norm > max_norm. The norm sums the leaves' squares in the JAX
    leaf order. Returns (clipped grads, norm)."""
    names = sorted(grads, key=leaf_order)
    norm = torch.sqrt(sum(torch.sum(torch.square(grads[k])) for k in names))
    scale = torch.where(norm > max_norm, max_norm / (norm + 1e-6), 1.0)
    return {k: g * scale for k, g in grads.items()}, norm


def cosine_warm_restarts(
    base_lr: float, t0: int, t_mult: int, eta_min: float, steps_per_epoch: int = 1
):
    """Closed-form SGDR schedule (CosineAnnealingWarmRestarts): cycles of
    t0, t0 * t_mult, ... epochs, `steps_per_epoch` updates per epoch.
    Evaluated in float32, as the JAX package evaluates it."""
    f32 = np.float32

    def schedule(step: int) -> float:
        epoch = f32(step) / f32(steps_per_epoch)
        if t_mult == 1:
            t_cur = np.mod(epoch, f32(t0))
            t_i = f32(t0)
        else:
            tm = f32(t_mult)
            n = np.floor(np.log(epoch / f32(t0) * (tm - f32(1)) + f32(1)) / np.log(tm))
            cycle_start = f32(t0) * (tm**n - f32(1)) / (tm - f32(1))
            t_i = f32(t0) * tm**n
            t_cur = epoch - cycle_start
        cos = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * t_cur / t_i))
        return float(f32(eta_min) + (f32(base_lr) - f32(eta_min)) * cos)

    return schedule


class AdamState(NamedTuple):
    count: int  # updates taken
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


class MetaOptimizer:
    """clip(max_norm) -> AdamW(lr = schedule(count), weight_decay)."""

    def __init__(self, cfg: MetaConfig):
        self.clip_norm = cfg.clip_norm
        self.weight_decay = cfg.weight_decay
        self.schedule = cosine_warm_restarts(
            cfg.outer_lr, cfg.cosine_t0, cfg.cosine_t_mult, cfg.eta_min,
            steps_per_epoch=max(1, cfg.grad_accum),
        )

    @staticmethod
    def init(params: Mapping[str, torch.Tensor]) -> AdamState:
        zeros = {k: torch.zeros_like(p) for k, p in params.items()}
        return AdamState(0, zeros, {k: torch.zeros_like(p) for k, p in params.items()})

    @torch.no_grad()
    def update(
        self, grads: Mapping[str, torch.Tensor], state: AdamState,
        params: Mapping[str, torch.Tensor],
    ) -> AdamState:
        """Apply one update to `params` in place; return the new state."""
        grads, _ = clip_global_norm_tree(grads, self.clip_norm)
        count = state.count + 1
        lr = self.schedule(state.count)
        mu, nu = {}, {}
        for k, p in params.items():
            g = grads[k]
            mu[k] = (1 - ADAM_B1) * g + ADAM_B1 * state.mu[k]
            nu[k] = (1 - ADAM_B2) * g**2 + ADAM_B2 * state.nu[k]
            mu_hat = mu[k] / (1 - ADAM_B1**count)
            nu_hat = nu[k] / (1 - ADAM_B2**count)
            u = mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS) + self.weight_decay * p
            p.add_(-lr * u)
        return AdamState(count, mu, nu)
