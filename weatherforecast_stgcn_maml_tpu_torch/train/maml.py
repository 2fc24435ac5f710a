"""MAML meta step, first-order (FOMAML) or second-order.

Counterpart of `weatherforecast_stgcn_maml_tpu/train/maml.py`. Per task,
first order (the default):

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

Second order (`meta.second_order`): the inner loop runs on a functional
parameter dict that stays in the meta-parameters' graph. Each step's
gradient comes from train/so_grad.py (the first-order gradient forward, a
Hessian-vector product backward, by `meta.so_impl`); the global-norm clip
and p - inner_lr * g are per-leaf and differentiable (the fused clip + SGD
kernel is first-order only), and the query loss is differentiated w.r.t. the
meta-parameters themselves: the exact MAML meta-gradient.

Tasks run one after another on one device (the JAX package vmaps them),
except in lockstep: with `ops.fused_lstm_stack._VBATCH` on, the first-order
step of the hybrid family on the merged fused LSTM stack runs the tasks of
a micro-batch side by side (`lockstep_batch_grad`), as the JAX package's
vmap does, their LSTM stacks in one launch each way (kernel rows 16-17) and
their inner updates in one (row 9); on both meshes (parallel/meta_dp.py,
parallel/meta_sp.py) a rank runs its tasks so too, through its
`TaskRoute`. The meta batch splits into
`grad_accum` micro-batches run in sequence; the mean meta-gradient of each
feeds one clip + AdamW update (train/optimizers.py) from the parameters
the previous update left.

Dropout masks come from one `torch.Generator` on the model's device,
consumed in order: task by task, inner step by inner step, then the query
windows (in lockstep: inner step by inner step, task by task within a step,
then the query windows, task by task within each); each forward draws
encoder, LSTM, head masks in that order.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from weatherforecast_stgcn_maml_tpu_torch.config import MetaConfig, ModelConfig
from weatherforecast_stgcn_maml_tpu_torch.models.common import accum_dtype, resolve_dtype
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
    init_model,
)
from weatherforecast_stgcn_maml_tpu_torch.ops.fused_sgd import (
    clip_sgd_update,
    clip_sgd_update_plain,
)
from weatherforecast_stgcn_maml_tpu_torch.train.optimizers import (
    AdamState,
    MetaOptimizer,
    clip_global_norm_tree,
    leaf_order,
)
from weatherforecast_stgcn_maml_tpu_torch.train.so_fused import (
    make_grad_loss_fused,
    plain_route,
    support_loss,
)
from weatherforecast_stgcn_maml_tpu_torch.train.so_grad import SO_IMPLS, make_so_grad
from weatherforecast_stgcn_maml_tpu_torch.train.tasks import Task, select_tasks, task_at


class MamlState(NamedTuple):
    params: nn.Module  # the meta-parameters; updates change them in place
    opt_state: AdamState
    step: int  # optimizer updates taken


SO_REMATS = ("step", "dots", "none", "sqrt")


def check_supported(cfg: MetaConfig) -> None:
    """Raise ValueError for an unknown second-order setting."""
    if cfg.second_order:
        if cfg.so_impl not in SO_IMPLS:
            raise ValueError(f"meta.so_impl={cfg.so_impl!r}: expected one of {SO_IMPLS}")
        chunk = cfg.so_remat.startswith("chunk:") and cfg.so_remat[6:].isdigit()
        if cfg.so_remat not in SO_REMATS and not chunk:
            raise ValueError(
                f"meta.so_remat={cfg.so_remat!r}: expected 'step', 'dots', 'none', "
                "'sqrt', or 'chunk:<k>'"
            )


def init_meta_state(
    generator: torch.Generator, model_cfg: ModelConfig, meta_cfg: MetaConfig,
    *, device: torch.device | str = "cpu",
) -> MamlState:
    """Random meta-parameters from `generator` (a CPU generator) on
    `device`, a fresh optimizer state. The parameters are float32, and
    float64 under float64 compute (the JAX package's x64 mode)."""
    model = init_model(generator, model_cfg, device=device).to(
        accum_dtype(resolve_dtype(model_cfg.compute_dtype)))
    return MamlState(model, MetaOptimizer.init(dict(model.named_parameters())), 0)


class TaskRoute(NamedTuple):
    """Where one task's losses run (`adapt_and_query_loss`): one device, the
    whole task (`device_route`), or a dp x sp rank's node rows
    (parallel/meta_sp.local_route).

      forward(model, a_hat, x, koppen, cfg, *, train, generator, masks):
          the predictions;
      mse(preds, y, node_mask): the window's loss, the same on every rank;
      masks(cfg, generator, x [W, N, F]): one train forward's dropout masks;
      reduce([gradient]): the inner gradient, before the clip (also the
          stacked [V, ...] gradients of tasks run in lockstep);
      grad_loss_fused(model, cfg): `so_impl="fhvp"`'s gradient, forward-
          differentiable through rows 10-11 (train/so_fused.py);
      forward_tasks(params, a_hat, x, koppen, cfg, *, masks): V tasks'
          train-mode predictions at their own parameters ({name: [V, ...]},
          x [V, W, N, F]), for `lockstep_grad_sums`.
    """

    forward: Callable
    mse: Callable
    masks: Callable
    reduce: Callable
    grad_loss_fused: Callable
    forward_tasks: Callable


def device_route() -> TaskRoute:
    """One device, the whole task: this module's model functions, looked up
    when the route is made, and no sum over ranks."""
    return TaskRoute(apply_model, masked_mse, draw_masks, lambda grads: grads,
                     make_grad_loss_fused, apply_hybrid_tasks)


def param_grads(loss: torch.Tensor, params: list[torch.Tensor]) -> list[torch.Tensor]:
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
    fast: nn.Module | None = None,
    route: TaskRoute | None = None,
) -> torch.Tensor:
    """Inner-adapt on the task's support set and return the query loss.

    First order: `fast` (overwritten with a copy of `params`) adapts, and
    the loss is differentiable w.r.t. `fast`'s parameters: its gradient
    there is the task's first-order meta-gradient. Second order: the loss
    is differentiable w.r.t. `params`' own parameters, and its gradient
    there is the exact meta-gradient (`fast` is not used). On a dp x sp
    rank (`route`) the gradients are the rank's partials of those."""
    route = route or device_route()
    if cfg.second_order:
        return _so_adapt_and_query_loss(params, task, generator, model_cfg, cfg, route)
    # The JAX parameter tree's leaf order: the order the clip sums squares in.
    named = sorted(fast.named_parameters(), key=lambda kv: leaf_order(kv[0]))
    fast_params = [p for _, p in named]
    with torch.no_grad():
        for q, p in zip(fast.parameters(), params.parameters()):
            q.copy_(p)
    n_support = task.support_x.shape[0]
    for s in range(cfg.inner_epochs * n_support):
        idx = s % n_support  # epoch-major pass over the same support windows
        preds = route.forward(
            fast, task.a_hat, task.support_x[idx], task.koppen, model_cfg,
            train=True, generator=generator,
        )
        loss = route.mse(preds, task.support_y[idx], task.node_mask)
        inner_sgd_update(named, route.reduce(param_grads(loss, fast_params)), cfg)

    return _query_loss(fast, None, task, generator, model_cfg, cfg, route)


@torch.no_grad()
def inner_sgd_update(named: list, grads: list[torch.Tensor], cfg: MetaConfig) -> None:
    """One first-order inner step in place: p <- p - inner_lr * clip(g),
    the norm over the whole tree. `named` [(name, parameter)] in the JAX
    leaf order, `grads` in the same order."""
    if cfg.fused_inner_update:
        # The whole-tree clip + SGD as one kernel (rows 8-9).
        clip_sgd_update([p for _, p in named], grads, cfg.inner_lr, cfg.clip_norm)
        return
    clipped, _ = clip_global_norm_tree(dict(zip((n for n, _ in named), grads)), cfg.clip_norm)
    for name, p in named:
        p.sub_(cfg.inner_lr * clipped[name])


def _query_loss(model, params, task, generator, model_cfg, cfg, route) -> torch.Tensor:
    """The mean query loss of `model`, at `params` ({name: tensor}) when
    given. A train-mode forward without a generator has no dropout: the
    eval function, but differentiable (the eval kernels have no backward)."""
    q = max(1, min(cfg.query_batches, task.query_x.shape[0]))
    gen = generator if cfg.query_train_mode else None

    def loss_at(m, i):
        preds = route.forward(m, task.a_hat, task.query_x[i], task.koppen, model_cfg,
                              train=True, generator=gen)
        return route.mse(preds, task.query_y[i], task.node_mask)

    return torch.stack([
        loss_at(model, i) if params is None else functional_apply(model, params, loss_at, i)
        for i in range(q)
    ]).mean()


def _so_adapt_and_query_loss(params, task, generator, model_cfg, cfg, route) -> torch.Tensor:
    """Second order: the inner loop on a functional copy of `params`' tensors
    that stays in their graph, then the query loss.

    Each step draws its dropout masks once (encoder, LSTM, head, in the
    first-order path's order); the inner gradient and its Hessian-vector
    product both use them. `meta.so_remat` picks the JAX package's
    rematerialisation policy for its scan; here the inner gradient's
    autograd.Function keeps only the step's parameters and masks and
    recomputes the rest inside its backward, so every policy gives the same
    numbers and the same memory (an unknown one raises in check_supported).

    "xla" runs the plain route everywhere; the other so_impl values take the
    inner gradient on the model's own route and differentiate twice on the
    plain route ("hvp", "rof"; with `meta.so_wavefront` its LSTM is the
    wavefront, `models/lstm.lstm_wavefront`) or through rows 10-11
    ("fhvp", which ignores `so_wavefront`, as does "xla"). On a dp x sp
    rank `route.reduce` sums each step's partial gradient over sp before the
    clip; its backward sums the cotangents over sp before each rank's
    Hessian transpose.
    """
    check_supported(cfg)
    route_x = plain_route(model_cfg)
    if cfg.so_impl == "xla":
        model_cfg = route_x  # double backward needs the plain route everywhere
    elif cfg.so_wavefront and cfg.so_impl in ("hvp", "rof"):
        # Their Hessian transpose runs the wavefront LSTM (the same cells and
        # masks, T + L - 1 serial steps), as the JAX package's does.
        route_x = dataclasses.replace(route_x, lstm_wavefront=True)
    fused = route.grad_loss_fused(params, model_cfg) if cfg.so_impl == "fhvp" else None
    inner_grad = make_so_grad(support_loss(params, model_cfg, route.forward, route.mse),
                              support_loss(params, route_x, route.forward, route.mse),
                              cfg.so_impl, fused)
    p = dict(params.named_parameters())
    names = list(p)
    n_support = task.support_x.shape[0]
    for s in range(cfg.inner_epochs * n_support):
        idx = s % n_support  # epoch-major pass over the same support windows
        aux = (task.support_x[idx], task.support_y[idx], task.a_hat, task.koppen,
               task.node_mask)
        masks = route.masks(model_cfg, generator, task.support_x[idx])
        g = inner_grad(p, aux, masks)
        g, _ = clip_global_norm_tree(dict(zip(names, route.reduce([g[k] for k in names]))),
                                     cfg.clip_norm)
        p = {k: v - cfg.inner_lr * g[k] for k, v in p.items()}
    return _query_loss(params, p, task, generator, model_cfg, cfg, route)


def lockstep_route(model_cfg: ModelConfig, cfg: MetaConfig, tasks: Task | None = None) -> bool:
    """Whether the meta step runs a micro-batch's tasks in lockstep: first
    order, where `lockstep_stack` names a stack. Given the stacked `tasks`,
    the fused stack goes in lockstep only where `lockstep_planned` holds for
    their V tasks (a dp x sp rank's: its node rows); elsewhere the tasks run
    one after another, counted in `lockstep_route.serial_fallbacks`, where
    `auto` then takes the plain stack if one task has no plan either."""
    stack = None if cfg.second_order else lockstep_stack(model_cfg)
    if stack != "fused" or tasks is None:
        return stack is not None
    nv, _, _, nodes, _ = tasks.support_x.shape  # [V, S, W, N, F]
    if lockstep_planned(model_cfg, nv, nodes, tasks.support_x.device):
        return True
    lockstep_route.serial_fallbacks += 1
    return False


lockstep_route.serial_fallbacks = 0  # micro-batches run serially for want of a plan


@torch.no_grad()
def inner_sgd_update_tasks(params: list, grads: list[torch.Tensor], cfg: MetaConfig) -> None:
    """`inner_sgd_update` for leaves with a leading task axis, each task
    clipped by its own norm: with `fused_inner_update` the batched kernel
    (row 9), else per-leaf operations (its plain version). `params` and
    `grads` in the JAX leaf order."""
    update = clip_sgd_update if cfg.fused_inner_update else clip_sgd_update_plain
    update(params, grads, cfg.inner_lr, cfg.clip_norm, batched=True)


def lockstep_grad_sums(
    params: nn.Module,
    tasks: Task,
    generator,
    model_cfg: ModelConfig,
    cfg: MetaConfig,
    route: TaskRoute | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The first-order meta-gradients of a stacked batch of V tasks, run in
    lockstep: (per-task query losses [V], {name: gradient summed over the
    tasks}); on a dp x sp rank (`route`, parallel/meta_sp.local_route) the
    rank's partials of those.

    The fast parameters are one copy of the meta-parameters stacked V
    times. Inner step s runs one task-batched train forward and backward
    (`route.forward_tasks`: `apply_hybrid_tasks`, or a rank's node rows) on
    support window s % S of every task, sums the stacked gradients over
    the ranks (`route.reduce`, before any clip), then one clip + SGD update
    of the whole stacked tree, each task clipped by its own norm
    (`inner_sgd_update_tasks`). Then the query loss of every task, and each
    task's gradient at its adapted parameters. The tasks share no
    parameter, so one backward of the summed losses gives each task's own
    gradient in its slice.

    Dropout: `generator` is one torch.Generator (or None) or a sequence of
    V, one a task; each task's masks are `route.masks`' of its window. From
    one, masks come inner step by inner step, task by task within a step
    (each task's encoder, LSTM, head masks), then query window by query
    window, task by task within each: the same draws as the serial route's,
    in another order, so the same seed gives other masks. From V, task v
    draws from its own in the order its serial run would (its inner steps,
    then its query windows): the same masks as the serial route given that
    generator (the meshes' per-task generators).
    """
    route = route or device_route()
    named = sorted(params.named_parameters(), key=lambda kv: leaf_order(kv[0]))
    names = [k for k, _ in named]
    nv = tasks.support_x.shape[0]
    fast = [p.detach().unsqueeze(0).repeat(nv, *[1] * p.dim()).requires_grad_(True)
            for _, p in named]
    gens = generator if isinstance(generator, (list, tuple)) else [generator] * nv

    def masks_of(gens, x):  # x [V, W, N, F]
        per_task = [route.masks(model_cfg, g, x[v]) for v, g in enumerate(gens)]
        return {k: torch.stack([m[k] for m in per_task]) for k in per_task[0]}

    def losses_at(x, y, gens):  # per-task losses [V] of one window a task
        preds = route.forward_tasks(dict(zip(names, fast)), tasks.a_hat, x, tasks.koppen,
                                    model_cfg, masks=masks_of(gens, x))
        return torch.stack([route.mse(preds[v], y[v], tasks.node_mask[v]) for v in range(nv)])

    n_support = tasks.support_x.shape[1]
    for s in range(cfg.inner_epochs * n_support):
        idx = s % n_support  # epoch-major pass over the same support windows
        losses = losses_at(tasks.support_x[:, idx], tasks.support_y[:, idx], gens)
        inner_sgd_update_tasks(fast, route.reduce(param_grads(losses.sum(), fast)), cfg)
    q = max(1, min(cfg.query_batches, tasks.query_x.shape[1]))
    query_gens = gens if cfg.query_train_mode else [None] * nv
    losses = torch.stack([losses_at(tasks.query_x[:, i], tasks.query_y[:, i], query_gens)
                          for i in range(q)]).mean(dim=0)
    grads = dict(zip(names, param_grads(losses.sum(), fast)))
    return losses.detach(), {k: grads[k].sum(dim=0) for k, _ in params.named_parameters()}


def lockstep_batch_grad(
    params: nn.Module,
    tasks: Task,
    generator,
    model_cfg: ModelConfig,
    cfg: MetaConfig,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """`lockstep_grad_sums` with the mean gradient over the V tasks:
    (per-task query losses [V], {name: mean gradient})."""
    losses, sums = lockstep_grad_sums(params, tasks, generator, model_cfg, cfg)
    nv = tasks.support_x.shape[0]
    return losses, {k: g / nv for k, g in sums.items()}


def task_batch_grad(
    params: nn.Module,
    tasks: Task,
    generator: torch.Generator | None,
    model_cfg: ModelConfig,
    cfg: MetaConfig,
    fast: nn.Module | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The meta-gradient (first- or second-order, by `cfg.second_order`) of
    the mean query loss over a stacked batch of tasks: (per-task query
    losses [B], {name: gradient}). Under `lockstep_route` the tasks run in
    lockstep (`lockstep_batch_grad`), else one after another."""
    if lockstep_route(model_cfg, cfg, tasks):
        return lockstep_batch_grad(params, tasks, generator, model_cfg, cfg)
    if cfg.second_order:
        named = list(params.named_parameters())
    else:
        fast = copy.deepcopy(params) if fast is None else fast
        named = list(fast.named_parameters())
    targets = [p for _, p in named]
    batch = tasks.support_x.shape[0]
    total, losses = None, []
    for i in range(batch):
        loss = adapt_and_query_loss(
            params, task_at(tasks, i), generator, model_cfg, cfg, fast
        )
        grads = param_grads(loss, targets)
        total = grads if total is None else [a + b for a, b in zip(total, grads)]
        losses.append(loss.detach())
    return torch.stack(losses), {n: g / batch for (n, _), g in zip(named, total)}


def make_meta_step(model_cfg: ModelConfig, cfg: MetaConfig):
    """Build `meta_step(state, tasks, generator) -> (state, metrics)`.

    `tasks` is a stacked Task of B tasks (B divisible by the update count
    min(grad_accum, B)). Metrics: `meta_loss` (mean of the per-task query
    losses), `per_task_loss` [B] in input order, `learning_rate` (the
    schedule at the last update)."""
    check_supported(cfg)
    opt = MetaOptimizer(cfg)

    def meta_step(state: MamlState, tasks: Task, generator: torch.Generator | None):
        batch = tasks.support_x.shape[0]
        n_updates = max(1, min(cfg.grad_accum, batch))
        if batch % n_updates:
            raise ValueError(f"meta batch {batch} not divisible by grad_accum {n_updates}")
        per = batch // n_updates
        fast = None if cfg.second_order else copy.deepcopy(state.params)
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


def make_chained_meta_step(step, epoch_rng: Callable):
    """Chain k meta steps into one call: `chained(state, pool, idx_k,
    epochs_k) -> (state, metrics_k)`.

    Counterpart of the JAX package's `make_chained_meta_step`. For each
    epoch e of `epochs_k`, in order, the batch at the matching row of
    `idx_k` ([k, B] task indices) is gathered on the device from the staged
    `pool` (`select_tasks`) and `step` (any meta step: one device, the dp
    mesh, either dp x sp step) runs on it with `epoch_rng(e)`, the rng
    argument the engine gives epoch e alone. So a chained call is bitwise
    k single steps fed the same indices. Metrics come back stacked on a
    leading [k] axis and stay on the device (`learning_rate` is the host's
    schedule, a float64 array); `fetch_metrics` brings them over in one
    copy."""

    def chained(state: MamlState, pool: Task, idx_k, epochs_k):
        per = []
        for idx, epoch in zip(idx_k, epochs_k):
            state, metrics = step(state, select_tasks(pool, idx), epoch_rng(int(epoch)))
            per.append(metrics)
        return state, {
            "meta_loss": torch.stack([m["meta_loss"] for m in per]),
            "per_task_loss": torch.stack([m["per_task_loss"] for m in per]),
            "learning_rate": np.asarray([m["learning_rate"] for m in per], np.float64),
        }

    return chained


def fetch_metrics(metrics: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A meta step's or a chained step's metrics on the host: (meta_loss
    [k] float64, per_task_loss [k, B] float32 (float64 under float64),
    learning_rate [k]), the two losses in one device-to-host copy.
    `fetch_metrics.fetches` counts the calls."""
    loss = metrics["meta_loss"].reshape(-1, 1)
    dtype = torch.float64 if loss.dtype == torch.float64 else torch.float32
    per_task = metrics["per_task_loss"].reshape(loss.shape[0], -1)
    host = torch.cat([loss.to(dtype), per_task.to(dtype)], dim=1).detach().cpu().numpy()
    fetch_metrics.fetches += 1
    lr = np.asarray(metrics["learning_rate"], np.float64).reshape(-1)
    return host[:, 0].astype(np.float64), host[:, 1:], lr


fetch_metrics.fetches = 0
