"""Supervised single-region training (the core of regional adaptation), the
forward over a window batch, and the serving `predict` built on it.

Counterpart of `weatherforecast_stgcn_maml_tpu/train/supervised.py`. A train
step takes a batch of windows gathered on the device from the region's
`[T, N, C]` features; the climate-aware learning rate enters each update as
a number, set per epoch by the host-side schedule. An epoch is a Python
loop over `[nb, B]` anchor batches (the JAX package scans them in one
compiled program).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from weatherforecast_stgcn_maml_tpu_torch.config import ModelConfig
from weatherforecast_stgcn_maml_tpu_torch.data.windows import WindowSpec, gather_batch
from weatherforecast_stgcn_maml_tpu_torch.models.losses import masked_mse
from weatherforecast_stgcn_maml_tpu_torch.models.registry import apply_model
from weatherforecast_stgcn_maml_tpu_torch.train.optimizers import AdamState, AdaptOptimizer


class SupervisedState(NamedTuple):
    params: nn.Module  # updates change it in place
    opt_state: AdamState


def batched_forward(
    params, a_hat, x, koppen, model_cfg: ModelConfig, *, train: bool = False,
    generator: torch.Generator | None = None, masks: dict | None = None,
) -> torch.Tensor:
    """The model over a [B, W, N, C] window batch -> [B, H, N, 12].

    The weights are shared across windows, so the batch folds into the
    encoder's time slices and the LSTM's rows: one kernel launch each for
    the whole batch. In train mode every window has its own dropout masks
    (drawn from `generator` window by window, or given per window).
    """
    return apply_model(
        params, a_hat, x, koppen, model_cfg, train=train, generator=generator, masks=masks
    )


def make_train_step(model_cfg: ModelConfig, tx: AdaptOptimizer):
    """Build `step(state, x, y, a_hat, node_mask, koppen, lr, generator) ->
    (state, loss)`: the masked MSE of a train-mode forward over the batch,
    its gradient, then `tx`'s update p <- p - lr * u."""

    def step(state: SupervisedState, x, y, a_hat, node_mask, koppen, lr: float, generator):
        named = list(state.params.named_parameters())
        preds = batched_forward(
            state.params, a_hat, x, koppen, model_cfg, train=True, generator=generator
        )
        loss = masked_mse(preds, y, node_mask)
        # allow_unused: the encoder under `model.stop_base_gradients`.
        grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
        grads = {
            k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(named, grads)
        }
        opt_state = tx.update(grads, state.opt_state, dict(named), lr)
        return SupervisedState(state.params, opt_state), loss.detach()

    return step


def make_epoch_runner(model_cfg: ModelConfig, tx: AdaptOptimizer, spec: WindowSpec):
    """Build `run_epoch(state, features, anchor_batches, a_hat, node_mask,
    koppen, lr, generator) -> (state, batch_losses [nb])`: one train step
    per row of the `[nb, B]` anchor batches (host integers), each batch of
    windows gathered from the `[T, N, C]` features on their device."""
    step = make_train_step(model_cfg, tx)

    def run_epoch(state, features, anchor_batches, a_hat, node_mask, koppen, lr, generator):
        losses = []
        for anchors in np.asarray(anchor_batches):
            x, y = gather_batch(features, anchors, spec)
            state, loss = step(state, x, y, a_hat, node_mask, koppen, lr, generator)
            losses.append(loss)
        return state, torch.stack(losses)

    return run_epoch


def make_batched_eval(model_cfg: ModelConfig, spec: WindowSpec):
    """Build `run_eval(params, features, anchor_batches, a_hat, node_mask,
    koppen) -> [nb, B]`: per-WINDOW MSEs (eval mode), so callers can drop
    padding windows and weight every window exactly once."""

    @torch.no_grad()
    def run_eval(params, features, anchor_batches, a_hat, node_mask, koppen):
        rows = []
        for anchors in np.asarray(anchor_batches):
            x, y = gather_batch(features, anchors, spec)
            preds = batched_forward(params, a_hat, x, koppen, model_cfg)
            rows.append(torch.stack([masked_mse(p, t, node_mask) for p, t in zip(preds, y)]))
        return torch.stack(rows)

    return run_eval


def make_predict(model_cfg: ModelConfig):
    """Build `predict(params, x, a_hat, koppen) -> [B, H, N, 12]` (eval mode,
    no autograd)."""

    @torch.inference_mode()
    def predict(params, x, a_hat, koppen):
        return batched_forward(params, a_hat, x, koppen, model_cfg)

    return predict
