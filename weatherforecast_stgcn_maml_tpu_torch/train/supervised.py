"""Supervised single-region training (the core of regional adaptation), the
forward over a window batch, and the serving `predict` built on it.

Counterpart of `weatherforecast_stgcn_maml_tpu/train/supervised.py`. A train
step takes a batch of windows gathered on the device from the region's
`[T, N, C]` features; the climate-aware learning rate enters each update as
a number, set per epoch by the host-side schedule. An epoch is a Python
loop over `[nb, B]` anchor batches (the JAX package scans them in one
compiled program).

The region fleet (`parallel/fleet_mesh.py`) trains V regions side by side,
each at its own parameters, held as one region-stacked tree {name: [V,
...]}: `make_region_train_step` is its step. It mirrors what the JAX
package's vmap over regions runs: by default each region's slice in turn
through the serial step's kernels (a vmap of a Pallas call walks its
regions one after another on the grid), and under
`ops.fused_lstm_stack._VBATCH` every region's LSTM stack in one launch each
way (the task-batched kernels, rows 16-17, the region as the task axis).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from weatherforecast_stgcn_maml_tpu_torch.config import ModelConfig
from weatherforecast_stgcn_maml_tpu_torch.data.windows import WindowSpec, gather_batch
from weatherforecast_stgcn_maml_tpu_torch.models.hybrid import (
    apply_hybrid_tasks,
    lockstep_planned,
    lockstep_stack,
)
from weatherforecast_stgcn_maml_tpu_torch.models.losses import masked_mse
from weatherforecast_stgcn_maml_tpu_torch.models.registry import (
    apply_model,
    draw_masks,
    functional_apply,
)
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
    the whole batch. In train mode under `ops.fused_lstm_stack._VBATCH`
    without `_ROWFOLD` the LSTM runs one window a task instead (rows 16-17,
    the weights shared; `models/hybrid.window_batch_unfolded`), as the JAX
    package's vmap over windows does. In train mode every window has its
    own dropout masks (drawn from `generator` window by window, or given
    per window).
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


def region_batched_route(model_cfg: ModelConfig, regions: int, rows: int,
                         device: torch.device) -> bool:
    """Whether a fleet step runs its `regions` regions' LSTM stacks in one
    task-batched launch each way (`rows` LSTM rows a region: windows x
    nodes): where `models/hybrid.lockstep_stack` names a stack, and for the
    fused stack where `lockstep_planned` holds for the regions' rows, as
    the meta step's lockstep route decides for tasks. Where it does not,
    the regions run in turn, counted in
    `make_region_train_step.serial_fallbacks`."""
    stack = lockstep_stack(model_cfg)
    if stack != "fused":
        return stack is not None
    if lockstep_planned(model_cfg, regions, rows, device):
        return True
    make_region_train_step.serial_fallbacks += 1
    return False


def _zero_unused(grads, like):
    return [torch.zeros_like(p) if g is None else g for g, p in zip(grads, like)]


def make_region_train_step(model_cfg: ModelConfig, tx: AdaptOptimizer, template: nn.Module):
    """Build the fleet's train step over V regions, each at its own
    parameters:

      step(params, states, x, y, a_hat, node_mask, koppen, lrs, generators)
        -> (states, losses [V])

    `params` {name: [V, ...]} is the region-stacked tree (the names of
    `template.named_parameters()`; updated in place), `states` the V
    regions' Adam states, x [V, B, W, N, C] and y [V, B, H, N, 12] each
    region's window batch, a_hat [V, N, N], node_mask [V, N], koppen V
    ints, lrs V learning rates and generators V dropout generators. Region
    v takes exactly the serial step (`make_train_step`) on its slice: the
    same masks, drawn from its generator window by window, the same loss,
    gradient and update with its own lr.

    By default the regions run in turn, each through `template`'s forward
    with its slice of the tree (rows 6-7 for the encoder, rows 4-5 for the
    LSTM stack with the window batch folded into its rows). Under
    `region_batched_route` one task-batched forward (`apply_hybrid_tasks`,
    B windows a task: rows 16-17) and one backward of the summed losses
    serve every region: the regions share no parameter, so each one's
    gradient is its own slice.
    """
    names = [k for k, _ in template.named_parameters()]

    def step(params, states, x, y, a_hat, node_mask, koppen, lrs, generators):
        nv = x.shape[0]
        states = list(states)
        losses = []
        if region_batched_route(model_cfg, nv, x.shape[1] * x.shape[3], x.device):
            leaves = [params[k].detach().requires_grad_(True) for k in names]
            drawn = [draw_masks(model_cfg, g, x[v]) for v, g in enumerate(generators)]
            masks = {k: torch.stack([m[k] for m in drawn]) for k in drawn[0]}
            codes = torch.tensor(list(koppen), dtype=torch.long, device=x.device)
            preds = apply_hybrid_tasks(dict(zip(names, leaves)), a_hat, x, codes, model_cfg,
                                       masks=masks)
            per_region = torch.stack([masked_mse(preds[v], y[v], node_mask[v])
                                      for v in range(nv)])
            # allow_unused: the encoder under `model.stop_base_gradients`.
            grads = _zero_unused(torch.autograd.grad(per_region.sum(), leaves,
                                                     allow_unused=True), leaves)
            for v in range(nv):
                states[v] = tx.update({k: g[v] for k, g in zip(names, grads)}, states[v],
                                      {k: params[k][v] for k in names}, lrs[v])
            return states, per_region.detach()
        for v in range(nv):
            leaves = [params[k][v].detach().requires_grad_(True) for k in names]
            preds = functional_apply(template, dict(zip(names, leaves)), apply_model,
                                     a_hat[v], x[v], koppen[v], model_cfg, train=True,
                                     generator=generators[v])
            loss = masked_mse(preds, y[v], node_mask[v])
            grads = _zero_unused(torch.autograd.grad(loss, leaves, allow_unused=True), leaves)
            states[v] = tx.update(dict(zip(names, grads)), states[v],
                                  {k: params[k][v] for k in names}, lrs[v])
            losses.append(loss.detach())
        return states, torch.stack(losses)

    return step


make_region_train_step.serial_fallbacks = 0  # fleet steps run region by region under _VBATCH


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
