"""The dp x sp MAML meta step: tasks over dp, the padded node axis over sp,
the fused kernels engaged per node shard.

Counterpart of `weatherforecast_stgcn_maml_tpu/parallel/meta_sp.py`
(`make_shardmap_meta_step_2d`). Each rank holds its tasks' node rows
(parallel/mesh.shard_task_batch_2d) and runs, per task, train/maml.py's
`adapt_and_query_loss` on `local_route`, first order:

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

Under `ops.fused_lstm_stack._VBATCH` (train/maml.lockstep_route, at the
rank's NL rows) a rank runs its tasks of a micro-batch side by side, as the
JAX package's vmap over them does: `train/maml.lockstep_grad_sums` on
`local_route`, each forward `spatial.hybrid_local_forward_tasks` (rows
12-13 task by task, rows 16-17 once for all), the stacked inner gradients
summed over sp BEFORE each task's clip, then row 9 (the per-task clip +
SGD). Each task draws from its own generator, so the lockstep step draws
the masks the serial step draws on the same key. Where no plan holds V
tasks' NL rows the tasks run one after another (counted in
`lockstep_route.serial_fallbacks`). Second order stays serial.

The shardmap step's LSTM is the node-local forward's (`apply_lstm`), as in
the JAX package, whose `_local_adapt_and_query_loss` reaches no wavefront:
`local_route` hands the forward `spatial.node_local(cfg)`, so
`model.lstm_wavefront` and `meta.so_wavefront` leave its routes as they are.

Second order (`meta.second_order`): the inner loop runs on a functional
copy of the parameters that stays in their graph. Each step's gradient is
train/so_grad.py's, on the node-local support loss (with `so_impl="fhvp"`
the Hessian transpose is the jvp of `make_local_grad_loss_fused`, rows
10-11 on the rank's NL rows), the rank's partial gradient;
`mesh.all_reduce_tensors` sums it over sp (its backward sums the cotangents
over sp before each rank's Hessian transpose), then the differentiable
global-norm clip and p - inner_lr * g. The query loss is differentiated
w.r.t. the meta-parameters themselves: each rank's partial of the exact
meta-gradient.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from weatherforecast_stgcn_maml_tpu_torch.config import MetaConfig, ModelConfig
from weatherforecast_stgcn_maml_tpu_torch.models.common import apply_dense, apply_mask, resolve_dtype
from weatherforecast_stgcn_maml_tpu_torch.models.stgcn import koppen_features
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm_stack
from weatherforecast_stgcn_maml_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_tensors,
    shard_task_batch_2d,
)
from weatherforecast_stgcn_maml_tpu_torch.parallel.meta_dp import (
    make_mesh_meta_step,
    mesh_batch_grad,
)
from weatherforecast_stgcn_maml_tpu_torch.parallel.spatial import (
    _spatial_encoder,
    hybrid_local_forward,
    hybrid_local_forward_tasks,
    local_masks,
    node_local,
    psum_masked_mse,
)
from weatherforecast_stgcn_maml_tpu_torch.train.maml import (
    TaskRoute,
    adapt_and_query_loss,
    check_supported,
    lockstep_grad_sums,
    lockstep_route,
)
from weatherforecast_stgcn_maml_tpu_torch.train.so_fused import (
    _stack_weights,
    _vjp_sandwich,
    plain_route,
    support_loss,
)


def local_route(group) -> TaskRoute:
    """The task route of a dp x sp rank: its node rows ([W, NL, C] windows,
    a_rows [NL, N], node_mask [NL], as shard_task_batch_2d cuts a task)
    through `hybrid_local_forward`, the masked MSE summed over `group` (the
    whole window's loss on every rank), this rank's dropout masks
    (`local_masks`), and the inner gradient summed over `group`.

    The partial-gradient trap: each rank's gradient covers its own node rows
    (plus what crossed the gathers), so the inner gradient is the SUM over
    sp, taken BEFORE the global-norm clip. Clipping or stepping on a partial
    would let the sp ranks' parameters drift apart whenever real nodes span
    shards."""

    def forward(model, a_rows, x, koppen, cfg, **kwargs):
        return hybrid_local_forward(model, a_rows, x, koppen, node_local(cfg), group, **kwargs)

    def mse(preds, y, node_mask):
        return psum_masked_mse(preds, y, node_mask, group)

    def masks(cfg, generator, x):
        return local_masks(cfg, generator, x.shape[0], x.shape[1], x.device)

    def grad_loss_fused(model, cfg):
        return make_local_grad_loss_fused(
            model, cfg, group, support_loss(model, plain_route(cfg), forward, mse))

    def forward_tasks(params, a_rows, x, koppen, cfg, *, masks=None):
        return hybrid_local_forward_tasks(params, a_rows, x, koppen, cfg, group, masks=masks)

    return TaskRoute(forward, mse, masks, lambda grads: all_reduce_tensors(grads, group),
                     grad_loss_fused, forward_tasks)


def make_local_grad_loss_fused(model: nn.Module, cfg: ModelConfig, group, loss_plain):
    """The node-sharded twin of train/so_fused.make_grad_loss_fused:
    grad_loss(q, aux, masks) -> {name: this rank's partial gradient} of the
    local support loss (`support_loss` on `local_route(group)`; `loss_plain`
    is it on the plain route) at q, aux = (x [W, NL, C], y [H, NL, 12],
    a_rows [NL, N], koppen, node_mask [NL]), with this rank's masks,
    forward-differentiable through the second-order stack kernels on this
    rank's NL rows.

      pre   the node-local Koppen embedding and the node-sharded encoder
            (`parallel.spatial._spatial_encoder`) on its plain layerwise
            route, one all-gather a layer (the sandwich kernels, rows 12-13,
            are first-order only), and the merged LSTM weights;
      stack `fwd_op` / `bwd_op` (rows 4-5; jvp rows 10-11) on the NL rows;
      post  head dropout, dense head, the masked MSE summed over `group`.

    The value is what torch.func.grad of the local loss returns on this
    rank: its partial of the gradient (its rows' share, plus what crossed
    the gathers); the caller sums it over sp. Its jvp pushes every rank's
    tangent through the collectives' jvps, which by the symmetry of the
    joint Hessian over the ranks' parameter copies is this rank's share of
    the Hessian transpose the second-order meta-gradient needs. Where
    `fused_lstm_stack.stack_planned` fails at NL rows, and under
    `lstm_kernel="xla"`, it is torch.func.grad of `loss_plain`, counted in
    `lstm_stack_train.plain_routes` where unplanned.

    Counterpart of `weatherforecast_stgcn_maml_tpu/train/so_fused.py`
    (`make_local_grad_loss_fused`)."""
    plain = torch.func.grad(loss_plain)
    if cfg.lstm_kernel == "xla":
        return plain
    dtype = resolve_dtype(cfg.compute_dtype)
    enc_cfg = dataclasses.replace(cfg, use_pallas_gcn=False)
    keep = 1.0 - cfg.lstm_dropout

    def grad_loss(q, aux, masks):
        xb, yb, a_rows, koppen, node_mask = aux
        nl = xb.shape[1]
        if not fused_lstm_stack.stack_planned(cfg.lstm_hidden, nl, dtype, xb.device):
            fused_lstm_stack.lstm_stack_train.plain_routes += 1
            return plain(q, aux, masks)

        def pre(m):
            h = koppen_features(m, xb, koppen).transpose(0, 1)  # [NL, W, C_in]
            h = _spatial_encoder(m.encoder.layers, a_rows, h, enc_cfg, group,
                                 masks.get("encoder"))
            if cfg.stop_base_gradients:
                h = h.detach()
            return h.transpose(0, 1).contiguous(), *_stack_weights(m)  # [W, NL, hidden]

        def post(m, feat):
            if "head" in masks:
                feat = apply_mask(feat, masks["head"], keep)
            out = apply_dense(m.head, feat, compute_dtype=dtype)
            preds = out.reshape(nl, cfg.horizon, cfg.num_weather_vars).transpose(0, 1)
            return psum_masked_mse(preds, yb, node_mask, group)

        return _vjp_sandwich(model, q, pre, post, masks.get("lstm"), keep, dtype)

    return grad_loss


def make_shardmap_batch_grad(model_cfg: ModelConfig, meta_cfg: MetaConfig, mesh: Mesh):
    """`batch_grad(params, tasks, key, fast=None, offset=0) -> (per-task
    losses [B], {name: mean meta-gradient})` of the node-sharded path (see
    parallel/meta_dp.mesh_batch_grad); the counterpart of train/maml.py's
    task_batch_grad; under `lockstep_route` a rank's tasks run side by
    side."""

    route = local_route(mesh.sp_group)

    def task_loss(params, task, gen, fast):
        return adapt_and_query_loss(params, task, gen, model_cfg, meta_cfg, fast, route)

    def lockstep(params, tasks, gens):
        if not lockstep_route(model_cfg, meta_cfg, tasks):
            return None
        return lockstep_grad_sums(params, tasks, gens, model_cfg, meta_cfg, route)

    return mesh_batch_grad(mesh, shard_task_batch_2d, task_loss, meta_cfg.second_order,
                           lockstep)


def make_shardmap_meta_step_2d(model_cfg: ModelConfig, meta_cfg: MetaConfig, mesh: Mesh):
    """The dp x sp meta step: `(state, tasks, key) -> (state, metrics)`,
    `tasks` the whole stacked batch on every rank, `key` a tuple of ints
    (None: no dropout). The hybrid family only; first or second order."""
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
    check_supported(meta_cfg)
    return make_mesh_meta_step(meta_cfg, make_shardmap_batch_grad(model_cfg, meta_cfg, mesh))
