"""Optimizers: the meta optimizer (global-norm clip, then AdamW with optax's
semantics, under the cosine warm-restart schedule), the clip the inner SGD
uses, and the climate-aware adaptation optimizer with its per-epoch
learning-rate schedule.

Functional optimizers over named parameters and a state (count, mu, nu),
the counterparts of `weatherforecast_stgcn_maml_tpu/train/optimizers.py`
(`meta_optimizer`: `clip_by_global_norm_torch` chained with `optax.adamw`;
`adaptation_optimizer`: the clip, `add_decayed_weights`, `scale_by_adam`).
`torch.optim.AdamW` is not used: it decays as p * (1 - lr * wd) before the
Adam step, which rounds differently from optax's p - lr * (adam + wd * p).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
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


# Region-name -> climate-zone membership (the reference's adaptive scheduler).
TROPICAL_REGIONS = frozenset({"Indonesia", "Thailand", "QueensAustralia"})
COLD_REGIONS = frozenset({"Moscow", "NorthSiberia", "Afghanistan"})

# Per-zone (lr multiplier, weight decay).
CLIMATE_LR_MULT = {"tropical": 0.9, "temperate": 1.0, "cold": 1.1}
CLIMATE_WEIGHT_DECAY = {"tropical": 1e-5, "temperate": 1e-4, "cold": 5e-5}


def climate_zone(region_name: str) -> str:
    if region_name in TROPICAL_REGIONS:
        return "tropical"
    if region_name in COLD_REGIONS:
        return "cold"
    return "temperate"


class AdaptOptimizer:
    """Climate-aware Adam: clip(max_norm) -> + weight_decay * p (torch
    Adam's L2 decay, folded into the gradient before the moments) -> Adam
    moments (optax `scale_by_adam` defaults). The learning rate comes with
    each update (the per-epoch schedule sets it) and the step applies
    p <- p - lr * u.

    `mask` ({name: trainable}, or None for all) freezes leaves as
    `optax.masked` + `set_to_zero` does: a frozen leaf takes no update and
    no decay, keeps no moments, and is left out of the clip's norm; its
    gradient is still computed.
    """

    def __init__(
        self, clip_norm: float, weight_decay: float, mask: Mapping[str, bool] | None = None
    ):
        self.clip_norm = clip_norm
        self.weight_decay = weight_decay
        self.mask = mask

    def trainable(self, name: str) -> bool:
        return self.mask is None or self.mask[name]

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamState:
        keep = [k for k in params if self.trainable(k)]
        return AdamState(
            0,
            {k: torch.zeros_like(params[k]) for k in keep},
            {k: torch.zeros_like(params[k]) for k in keep},
        )

    @torch.no_grad()
    def update(
        self, grads: Mapping[str, torch.Tensor], state: AdamState,
        params: Mapping[str, torch.Tensor], lr: float,
    ) -> AdamState:
        """Apply one update to the trainable `params` in place; return the
        new state."""
        grads, _ = clip_global_norm_tree(
            {k: g for k, g in grads.items() if self.trainable(k)}, self.clip_norm
        )
        count = state.count + 1
        mu, nu = {}, {}
        for k, g in grads.items():
            g = g + self.weight_decay * params[k]
            mu[k] = (1 - ADAM_B1) * g + ADAM_B1 * state.mu[k]
            nu[k] = (1 - ADAM_B2) * g**2 + ADAM_B2 * state.nu[k]
            mu_hat = mu[k] / (1 - ADAM_B1**count)
            nu_hat = nu[k] / (1 - ADAM_B2**count)
            params[k].add_(-lr * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)))
        return AdamState(count, mu, nu)


def adaptation_optimizer(
    region_name: str, base_lr: float = 6e-4, clip_norm: float = 1.0
) -> tuple[AdaptOptimizer, float]:
    """The region's climate-aware Adam and its first-epoch lr
    (base_lr * the zone's multiplier)."""
    zone = climate_zone(region_name)
    return AdaptOptimizer(clip_norm, CLIMATE_WEIGHT_DECAY[zone]), base_lr * CLIMATE_LR_MULT[zone]


def trainable_mask(names, model_cfg) -> dict[str, bool]:
    """{parameter name: trainable}: False for the encoder under
    `model.stop_base_gradients` and for the Koppen table when
    `model.train_koppen_embedding` is off."""

    def keep(name):
        top = name.split(".")[0]
        if top == "encoder":
            return not model_cfg.stop_base_gradients
        if top == "koppen":
            return model_cfg.train_koppen_embedding
        return True

    return {name: keep(name) for name in names}


def masked_freeze(tx: AdaptOptimizer, mask: Mapping[str, bool]) -> AdaptOptimizer:
    """`tx` restricted to the leaves `mask` marks trainable; the others take
    zero updates (torch's not-in-the-optimizer semantics)."""
    return AdaptOptimizer(tx.clip_norm, tx.weight_decay, dict(mask))


@dataclass
class ClimateLRSchedule:
    """Per-epoch climate-aware lr: 5-epoch cosine cycles scaled by the
    zone's multiplier, with loss-based nudges after epoch 3 (x1.1 if the
    epoch loss > 1.0, x0.95 if < 0.2). Takes the raw base lr: `step`
    applies the multiplier itself."""

    region_name: str
    base_lr: float = 6e-4
    cycle_length: int = 5
    epoch: int = 0

    def step(self, epoch_loss: float | None = None) -> float:
        self.epoch += 1
        progress = (self.epoch - 1) % self.cycle_length / self.cycle_length
        cosine = 0.5 * (1.0 + np.cos(np.pi * progress))
        lr = self.base_lr * CLIMATE_LR_MULT[climate_zone(self.region_name)] * cosine
        if epoch_loss is not None and self.epoch > 3:
            if epoch_loss > 1.0:
                lr *= 1.1
            elif epoch_loss < 0.2:
                lr *= 0.95
        return float(lr)
