"""The dp x sp MAML meta step: tasks over dp, the padded node axis over sp,
the fused kernels engaged per node shard.

Counterpart of `weatherforecast_stgcn_maml_tpu/parallel/meta_sp.py`
(`make_shardmap_meta_step_2d`, first order). Each rank holds its tasks'
node rows (parallel/mesh.shard_task_batch_2d) and runs, per task:

  * the inner SGD loop on the node-local hybrid forward
    (parallel/spatial.hybrid_local_forward: the GCN sandwich kernels, rows
    12-13, with one all-gather per layer; the training LSTM kernels, rows
    4-5, on the rank's NL rows), the loss all-reduced over sp;
  * after each backward, the SUM over the sp group of every rank's partial
    gradient, then the whole-tree clip + SGD (row 8 with
    `meta.fused_inner_update`), identical on every sp rank;
  * the query loss at the adapted parameters, whose gradient is the rank's
    partial of the task's first-order meta-gradient.

The meta-gradient is the sum of those partials over the whole mesh divided
by the micro-batch size (parallel/meta_dp.mesh_batch_grad); every rank then
takes the same AdamW step. Dropout masks are per rank (its NL rows) and per
task, from `shard_generator((*key, task_index), sp_index)`: a valid stream
that differs from the unsharded step's.

Not ported: second-order MAML on this path (JAX `meta_sp.py:145-160` and
`so_fused.make_local_grad_loss_fused`) raises NotImplementedError.
"""

from __future__ import annotations

import torch

from weatherforecast_stgcn_maml_tpu_torch.config import MetaConfig, ModelConfig
from weatherforecast_stgcn_maml_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_tensors,
    shard_task_batch_2d,
)
from weatherforecast_stgcn_maml_tpu_torch.parallel.meta_dp import (
    make_mesh_meta_step,
    mesh_batch_grad,
    refuse_lockstep,
    refuse_second_order,
)
from weatherforecast_stgcn_maml_tpu_torch.parallel.spatial import (
    hybrid_local_forward,
    psum_masked_mse,
)
from weatherforecast_stgcn_maml_tpu_torch.train.maml import (
    check_supported,
    inner_sgd_update,
    param_grads,
)
from weatherforecast_stgcn_maml_tpu_torch.train.optimizers import leaf_order


def _local_adapt_and_query_loss(params, task, generator, model_cfg: ModelConfig,
                                cfg: MetaConfig, group, fast) -> torch.Tensor:
    """One task's first-order inner adaptation and query loss on this rank's
    node rows (`task` as shard_task_batch_2d cuts it). `fast` is overwritten
    with a copy of `params` and adapted; the returned loss (the whole
    task's, the same on every rank of `group`) is differentiable w.r.t.
    `fast`'s parameters, and its gradient there is this rank's partial of
    the task's meta-gradient."""
    # The JAX parameter tree's leaf order: the order the clip sums squares in.
    named = sorted(fast.named_parameters(), key=lambda kv: leaf_order(kv[0]))
    fast_params = [p for _, p in named]
    with torch.no_grad():
        for q, p in zip(fast.parameters(), params.parameters()):
            q.copy_(p)

    def loss_at(x, y, gen):
        preds = hybrid_local_forward(fast, task.a_hat, x, task.koppen, model_cfg, group,
                                     train=True, generator=gen)
        return psum_masked_mse(preds, y, task.node_mask, group)

    n_support = task.support_x.shape[0]
    for s in range(cfg.inner_epochs * n_support):
        idx = s % n_support  # epoch-major pass over the same support windows
        grads = param_grads(loss_at(task.support_x[idx], task.support_y[idx], generator),
                            fast_params)
        # The partial-gradient trap: each rank's gradient covers its own
        # node rows (plus what crossed the gathers), so the inner gradient
        # is the SUM over sp, taken BEFORE the global-norm clip. Clipping
        # or stepping on a partial would let the sp ranks' parameters drift
        # apart whenever real nodes span shards.
        inner_sgd_update(named, all_reduce_tensors(grads, group), cfg)

    q = max(1, min(cfg.query_batches, task.query_x.shape[0]))
    gen = generator if cfg.query_train_mode else None
    return torch.stack(
        [loss_at(task.query_x[i], task.query_y[i], gen) for i in range(q)]
    ).mean()


def make_shardmap_batch_grad(model_cfg: ModelConfig, meta_cfg: MetaConfig, mesh: Mesh):
    """`batch_grad(params, tasks, key, fast=None, offset=0) -> (per-task
    losses [B], {name: mean meta-gradient})` of the node-sharded path (see
    parallel/meta_dp.mesh_batch_grad); the counterpart of train/maml.py's
    task_batch_grad."""

    def task_loss(params, task, gen, fast):
        return _local_adapt_and_query_loss(params, task, gen, model_cfg, meta_cfg,
                                           mesh.sp_group, fast)

    return mesh_batch_grad(mesh, shard_task_batch_2d, task_loss)


def make_shardmap_meta_step_2d(model_cfg: ModelConfig, meta_cfg: MetaConfig, mesh: Mesh):
    """The dp x sp meta step: `(state, tasks, key) -> (state, metrics)`,
    `tasks` the whole stacked batch on every rank, `key` a tuple of ints
    (None: no dropout). The hybrid family only, first order."""
    if getattr(model_cfg, "family", "hybrid") != "hybrid":
        raise ValueError(
            "the dp x sp meta step supports family='hybrid' only (the JAX package's "
            "GSPMD step, which runs the other families, is not ported)"
        )
    per_update = meta_cfg.meta_batch // max(1, meta_cfg.grad_accum)
    if per_update % mesh.dp:
        raise ValueError(
            f"tasks per update ({per_update}) must be divisible by the dp mesh axis "
            f"({mesh.dp}) for even sharding"
        )
    refuse_second_order(meta_cfg, "the node-sharded (dp x sp) path")
    refuse_lockstep(model_cfg, meta_cfg, "the node-sharded (dp x sp) path")
    check_supported(model_cfg, meta_cfg)
    return make_mesh_meta_step(meta_cfg, make_shardmap_batch_grad(model_cfg, meta_cfg, mesh))
