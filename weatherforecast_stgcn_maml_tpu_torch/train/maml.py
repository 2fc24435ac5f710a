"""First-order MAML (FOMAML) meta step.

Counterpart of the first-order path of
`weatherforecast_stgcn_maml_tpu/train/maml.py`. Per task:

  inner loop    : a copy of the meta-parameters (the "fast" model) takes
                  `inner_epochs * S` SGD steps on the support windows
                  (window s % S at step s): a train-mode forward and
                  backward, a global-norm clip, then p - inner_lr * g, all
                  outside the meta-gradient's graph. With
                  `fused_inner_update` (the default) the clip and update
                  are one kernel over the whole tree (ops/fused_sgd.py);
                  without it, per-leaf PyTorch operations;
  meta-gradient : the query loss at the adapted parameters (train mode when
                  `query_train_mode`) is differentiated w.r.t. them. In the
                  first-order approximation d adapted / d params is the
                  identity, so that gradient is the task's meta-gradient.

Tasks run one after another on one device (the JAX package vmaps them). The
meta batch splits into `grad_accum` micro-batches run in sequence; the mean
meta-gradient of each feeds one clip + AdamW update (train/optimizers.py)
from the parameters the previous update left.

Dropout masks come from one `torch.Generator` on the model's device,
consumed in order: task by task, inner step by inner step, then the query
windows; each forward draws encoder, LSTM, head masks in that order.
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import torch
from torch import nn

from weatherforecast_stgcn_maml_tpu_torch.config import MetaConfig, ModelConfig
from weatherforecast_stgcn_maml_tpu_torch.models.losses import masked_mse
from weatherforecast_stgcn_maml_tpu_torch.models.registry import apply_model, init_model
from weatherforecast_stgcn_maml_tpu_torch.ops.fused_sgd import clip_sgd_update
from weatherforecast_stgcn_maml_tpu_torch.train.optimizers import (
    AdamState,
    MetaOptimizer,
    clip_global_norm_tree,
    leaf_order,
)
from weatherforecast_stgcn_maml_tpu_torch.train.tasks import Task, task_at


class MamlState(NamedTuple):
    params: nn.Module  # the meta-parameters; updates change them in place
    opt_state: AdamState
    step: int  # optimizer updates taken


def check_supported(model_cfg: ModelConfig, cfg: MetaConfig) -> None:
    """Raise NotImplementedError, naming it, for a setting not ported."""
    unported = {
        "meta.second_order=true (second-order MAML, the Hessian-vector "
        "kernels of JAX ops/fused_lstm_hvp.py rows 10-11)": cfg.second_order,
        "meta.epochs_per_dispatch > 1 (chained meta epochs)":
            cfg.epochs_per_dispatch > 1,
        "model.lstm_kernel='pallas' (the per-layer recurrence kernel)":
            model_cfg.lstm_kernel == "pallas",
        "model.use_pallas_lstm (the old eval-only LSTM kernel)":
            model_cfg.use_pallas_lstm,
        "model.lstm_wavefront (the wavefront LSTM schedule)":
            model_cfg.lstm_wavefront,
    }
    missing = [name for name, on in unported.items() if on]
    if missing:
        raise NotImplementedError("not ported: " + "; ".join(missing))


def init_meta_state(
    generator: torch.Generator, model_cfg: ModelConfig, meta_cfg: MetaConfig,
    *, device: torch.device | str = "cpu",
) -> MamlState:
    """Random meta-parameters from `generator` (a CPU generator) on
    `device`, a fresh optimizer state."""
    model = init_model(generator, model_cfg, device=device)
    return MamlState(model, MetaOptimizer.init(dict(model.named_parameters())), 0)


def _grads(loss: torch.Tensor, params: list[torch.Tensor]) -> list[torch.Tensor]:
    """d loss / d params; zero for a parameter the loss does not reach (the
    encoder under `model.stop_base_gradients`)."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]


def adapt_and_query_loss(
    params: nn.Module,
    task: Task,
    generator: torch.Generator | None,
    model_cfg: ModelConfig,
    cfg: MetaConfig,
    fast: nn.Module,
) -> torch.Tensor:
    """Inner-adapt `fast` (overwritten with a copy of `params`) on the
    task's support set and return the query loss, differentiable w.r.t.
    `fast`'s parameters: its gradient there is the task's first-order
    meta-gradient."""
    # The JAX parameter tree's leaf order: the order the clip sums squares in.
    named = sorted(fast.named_parameters(), key=lambda kv: leaf_order(kv[0]))
    fast_params = [p for _, p in named]
    with torch.no_grad():
        for q, p in zip(fast.parameters(), params.parameters()):
            q.copy_(p)
    n_support = task.support_x.shape[0]
    for s in range(cfg.inner_epochs * n_support):
        idx = s % n_support  # epoch-major pass over the same support windows
        preds = apply_model(
            fast, task.a_hat, task.support_x[idx], task.koppen, model_cfg,
            train=True, generator=generator,
        )
        loss = masked_mse(preds, task.support_y[idx], task.node_mask)
        grads = _grads(loss, fast_params)
        with torch.no_grad():
            if cfg.fused_inner_update:
                # The whole-tree clip + SGD as one kernel (rows 8-9).
                clip_sgd_update(fast_params, grads, cfg.inner_lr, cfg.clip_norm)
            else:
                clipped, _ = clip_global_norm_tree(
                    dict(zip((n for n, _ in named), grads)), cfg.clip_norm
                )
                for name, p in named:
                    p.sub_(cfg.inner_lr * clipped[name])

    # A train-mode forward without a generator has no dropout: the eval
    # function, but differentiable (the eval kernels have no backward).
    q = max(1, min(cfg.query_batches, task.query_x.shape[0]))
    losses = [
        masked_mse(
            apply_model(
                fast, task.a_hat, task.query_x[i], task.koppen, model_cfg,
                train=True, generator=generator if cfg.query_train_mode else None,
            ),
            task.query_y[i], task.node_mask,
        )
        for i in range(q)
    ]
    return torch.stack(losses).mean()


def task_batch_grad(
    params: nn.Module,
    tasks: Task,
    generator: torch.Generator | None,
    model_cfg: ModelConfig,
    cfg: MetaConfig,
    fast: nn.Module | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The first-order meta-gradient of the mean query loss over a stacked
    batch of tasks: (per-task query losses [B], {name: gradient})."""
    fast = copy.deepcopy(params) if fast is None else fast
    named = list(fast.named_parameters())
    fast_params = [p for _, p in named]
    batch = tasks.support_x.shape[0]
    total, losses = None, []
    for i in range(batch):
        loss = adapt_and_query_loss(
            params, task_at(tasks, i), generator, model_cfg, cfg, fast
        )
        grads = _grads(loss, fast_params)
        total = grads if total is None else [a + b for a, b in zip(total, grads)]
        losses.append(loss.detach())
    return torch.stack(losses), {n: g / batch for (n, _), g in zip(named, total)}


def make_meta_step(model_cfg: ModelConfig, cfg: MetaConfig):
    """Build `meta_step(state, tasks, generator) -> (state, metrics)`.

    `tasks` is a stacked Task of B tasks (B divisible by the update count
    min(grad_accum, B)). Metrics: `meta_loss` (mean of the per-task query
    losses), `per_task_loss` [B] in input order, `learning_rate` (the
    schedule at the last update)."""
    check_supported(model_cfg, cfg)
    opt = MetaOptimizer(cfg)

    def meta_step(state: MamlState, tasks: Task, generator: torch.Generator | None):
        batch = tasks.support_x.shape[0]
        n_updates = max(1, min(cfg.grad_accum, batch))
        if batch % n_updates:
            raise ValueError(f"meta batch {batch} not divisible by grad_accum {n_updates}")
        per = batch // n_updates
        fast = copy.deepcopy(state.params)
        params = dict(state.params.named_parameters())
        opt_state, step, losses = state.opt_state, state.step, []
        for u in range(n_updates):
            micro = Task(*(f[u * per:(u + 1) * per] for f in tasks))
            per_task, grads = task_batch_grad(
                state.params, micro, generator, model_cfg, cfg, fast
            )
            opt_state = opt.update(grads, opt_state, params)
            step += 1
            losses.append(per_task)
        per_task = torch.cat(losses)
        metrics = {
            "meta_loss": per_task.mean(),
            "per_task_loss": per_task,
            "learning_rate": opt.schedule(step - 1),
        }
        return MamlState(state.params, opt_state, step), metrics

    return meta_step
