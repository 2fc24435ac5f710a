"""Data-parallel MAML meta step over a mesh of ranks.

Counterpart of `weatherforecast_stgcn_maml_tpu/parallel/meta_dp.py`
(`make_parallel_meta_step`). Each micro-batch of the meta batch splits over
the dp ranks in contiguous blocks; every rank runs the whole inner loop of
its tasks with no communication (the inner loop is task-local), and one
all-reduce per update sums the meta-gradients. Parameters and optimizer
state are replicated: every rank takes the same AdamW step from the same
gradient, so they stay bitwise equal.

`mesh_batch_grad` is shared with the node-sharded step (parallel/meta_sp.py),
which plugs in its own per-task loss and task placement.

Second order needs no communication inside a task either: each rank
differentiates its tasks' query losses w.r.t. the meta-parameters
themselves (train/maml.py's second-order inner loop), and the same
all-reduce sums the exact meta-gradients. Under `ops.fused_lstm_stack.
_VBATCH` (train/maml.lockstep_route) a rank runs its tasks of a
micro-batch side by side (`train/maml.lockstep_grad_sums`: rows 16-17
each way and row 9 an inner step), as the dp x sp shardmap step does.
`model.lstm_wavefront` and `meta.so_wavefront` act as on one device: a
rank runs train/maml.py's loop on models/hybrid.py.

Dropout: task i of the meta batch draws from its own generator,
`shard_generator((*key, i), sp_index)` (parallel/mesh.py), so a task's
masks do not depend on which rank runs it, nor on whether the rank's
tasks run one after another or side by side. The single-device step
(train/maml.py) draws every task from one generator instead.

The dp x sp mesh runs `make_shardmap_meta_step_2d` (parallel/meta_sp.py)
or the GSPMD step's counterpart, `make_parallel_meta_step_2d`
(parallel/meta_gspmd.py).
"""

from __future__ import annotations

import copy

import torch

from weatherforecast_stgcn_maml_tpu_torch.config import MetaConfig, ModelConfig
from weatherforecast_stgcn_maml_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_rows,
    all_reduce_tensors,
    shard_generator,
    shard_task_batch,
)
from weatherforecast_stgcn_maml_tpu_torch.train.maml import (
    MamlState,
    adapt_and_query_loss,
    check_supported,
    lockstep_grad_sums,
    lockstep_route,
    param_grads,
)
from weatherforecast_stgcn_maml_tpu_torch.train.optimizers import MetaOptimizer
from weatherforecast_stgcn_maml_tpu_torch.train.tasks import Task, task_at


def mesh_batch_grad(mesh: Mesh, local_tasks, task_loss, second_order: bool = False,
                    lockstep=None, task_streams: bool = False):
    """Build `batch_grad(params, tasks, key, fast=None, offset=0) ->
    (per-task losses [B], {name: mean meta-gradient})` for a stacked batch
    of B tasks that every rank holds whole.

    `local_tasks(tasks, mesh)` cuts this rank's share; `task_loss(params,
    task, generator, fast)` is one task's loss, differentiable w.r.t.
    `fast`'s parameters (first order) or `params`' own (`second_order`).
    `offset` is the batch's first index in the meta batch (it picks the
    tasks' generators). `lockstep(params, tasks, generators)`, where given,
    runs this rank's tasks side by side and returns (per-task losses,
    {name: gradient summed over them}), or None where they run one after
    another. With `task_streams` every sp rank takes its task's dp-mesh
    generator (sp index 0), so that the sp group draws one stream a task,
    the dp step's (the GSPMD step, parallel/meta_gspmd.py). Both results
    are the same on every rank."""

    def batch_grad(params, tasks: Task, key, fast=None, offset: int = 0):
        batch = tasks.support_x.shape[0]
        if batch % mesh.dp:
            raise ValueError(f"{batch} tasks do not split evenly over {mesh.dp} dp ranks")
        local = batch // mesh.dp
        mine = local_tasks(tasks, mesh)
        first = offset + mesh.dp_index * local  # this rank's first task in the meta batch
        stream = 0 if task_streams else mesh.sp_index
        gens = [shard_generator(None if key is None else (*key, first + j), stream,
                                tasks.support_x.device) for j in range(local)]
        if second_order:
            named = list(params.named_parameters())
        else:
            fast = copy.deepcopy(params) if fast is None else fast
            named = list(fast.named_parameters())
        side_by_side = None if lockstep is None else lockstep(params, mine, gens)
        if side_by_side is not None:
            per_task, sums = side_by_side
            total, losses = [sums[n] for n, _ in named], list(per_task)
        else:
            total, losses = None, []
            for j in range(local):
                loss = task_loss(params, task_at(mine, j), gens[j], fast)
                grads = param_grads(loss, [p for _, p in named])
                total = grads if total is None else [a + b for a, b in zip(total, grads)]
                losses.append(loss.detach())
        # The meta-gradient: every rank's sum (over sp, each rank's partial
        # of its tasks; over dp, other tasks) summed over the whole mesh,
        # then the mean over the batch. Every rank gets the same tensor.
        total = all_reduce_tensors(total, mesh.group)
        # Every rank's sampler must see every task's loss, or the samplers
        # drift apart and the ranks pick different tasks.
        per_task = all_gather_rows(torch.stack(losses), mesh.dp_group)
        return per_task, {n: g / batch for (n, _), g in zip(named, total)}

    return batch_grad


def make_mesh_meta_step(cfg: MetaConfig, batch_grad):
    """`meta_step(state, tasks, key) -> (state, metrics)` over grad_accum
    micro-batches, each through `batch_grad` (mesh_batch_grad) and one
    AdamW update; metrics as train/maml.py's meta step."""
    opt = MetaOptimizer(cfg)

    def meta_step(state: MamlState, tasks: Task, key):
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
            per_task, grads = batch_grad(state.params, micro, key, fast, offset=u * per)
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


def make_parallel_meta_step(model_cfg: ModelConfig, meta_cfg: MetaConfig, mesh: Mesh):
    """The dp meta step on a 1-D mesh: `(state, tasks, key) -> (state,
    metrics)`, the signature of train/maml.py's step with `key` (a tuple of
    ints, or None for no dropout) in place of the generator. `tasks` is the
    whole stacked batch on every rank. First or second order (the loss is
    differentiated w.r.t. the meta-parameters themselves); under
    `lockstep_route` a rank's tasks run side by side (rows 16-17 and 9),
    each drawing from the generator its serial run would draw from.

    Requires meta_batch / grad_accum (the tasks per update) to be divisible
    by the mesh size, so every rank holds equal task shares."""
    check_supported(meta_cfg)
    if mesh.sp != 1:
        raise ValueError(
            "make_parallel_meta_step takes a 1-D dp mesh; a dp x sp mesh runs "
            "parallel.meta_sp.make_shardmap_meta_step_2d"
        )
    per_update = meta_cfg.meta_batch // max(1, meta_cfg.grad_accum)
    if per_update % mesh.size:
        raise ValueError(
            f"tasks per update ({per_update}) must be divisible by mesh size "
            f"({mesh.size}) for even dp sharding"
        )

    return make_mesh_meta_step(meta_cfg, make_parallel_batch_grad(model_cfg, meta_cfg, mesh))


def make_parallel_batch_grad(model_cfg: ModelConfig, meta_cfg: MetaConfig, mesh: Mesh):
    """`batch_grad(params, tasks, key, fast=None, offset=0) -> (per-task
    losses [B], {name: mean meta-gradient})` of the dp step (see
    mesh_batch_grad); the counterpart of train/maml.py's task_batch_grad."""

    def task_loss(params, task, gen, fast):
        return adapt_and_query_loss(params, task, gen, model_cfg, meta_cfg, fast)

    def lockstep(params, tasks, gens):
        if not lockstep_route(model_cfg, meta_cfg, tasks):
            return None
        return lockstep_grad_sums(params, tasks, gens, model_cfg, meta_cfg)

    return mesh_batch_grad(mesh, shard_task_batch, task_loss, meta_cfg.second_order, lockstep)
