"""The GSPMD dp x sp MAML meta step: tasks over dp, the padded node axis
over sp, on the plain routes, every family.

Counterpart of `weatherforecast_stgcn_maml_tpu/parallel/meta_dp.py`
(`make_parallel_meta_step_2d`), which partitions the unsharded meta step
(`train/maml.py:make_meta_step` with a 2-D mesh). That step pins the XLA
routes (`lstm_kernel="xla"`, `use_pallas_gcn=False`,
`use_pallas_lstm=False`) and the per-leaf inner update
(`fused_inner_update=False`), because the partitioner cannot split a
Pallas kernel; its dropout streams are the unsharded step's. PyTorch has no
partitioner, so this is a manual-collective step that computes what the
partitioned step computes: the port's dp-mesh step (parallel/meta_dp.py)
with each task's node axis split over the sp ranks.

Each rank holds its tasks' node rows (parallel/mesh.shard_task_batch_2d)
and runs, per task, train/maml.py's `adapt_and_query_loss` on
`gspmd_route`:

  * forward: the node-local forward of the family
    (parallel/spatial.hybrid_local_forward, stgcn_local_forward: one
    all-gather a GCN layer, everything else node-local) on the plain
    routes, so no kernel launches here, as none runs in the JAX step. The
    JAX step runs models/hybrid.py, so `model.lstm_wavefront` selects the
    wavefront LSTM here, and `meta.so_wavefront` (so_impl hvp / rof) does
    in the Hessian transpose (train/maml.py), as on one device;
  * loss: the masked MSE summed over sp (`psum_masked_mse`);
  * the inner gradient summed over sp before the clip
    (`all_reduce_tensors`), first or second order (every so_impl;
    "fhvp" differentiates the plain gradient forward);
  * dropout: each task draws its full-N masks from the generator its
    dp-mesh run draws from, `shard_generator((*key, i), 0)`, in the same
    order; each rank keeps its node rows. So the step equals the dp-mesh
    step on the same key (up to the order of sums), masks included.

Memory: a rank holds its NL rows of every activation; the full-N objects
are the int8 masks, drawn and then cut, and the adjacency's row block
[NL, N].

The meta-gradient is the sum of the ranks' partials over the whole mesh
divided by the micro-batch size (parallel/meta_dp.mesh_batch_grad); every
rank takes the same AdamW step. Under `ops.fused_lstm_stack._VBATCH` a
rank's tasks run one after another, as in the JAX package's GSPMD step on
its pinned routes.
"""

from __future__ import annotations

import dataclasses

import torch

from weatherforecast_stgcn_maml_tpu_torch.config import MetaConfig, ModelConfig
from weatherforecast_stgcn_maml_tpu_torch.models.registry import window_masks
from weatherforecast_stgcn_maml_tpu_torch.parallel.mesh import Mesh, node_rows, shard_task_batch_2d
from weatherforecast_stgcn_maml_tpu_torch.parallel.meta_dp import (
    make_mesh_meta_step,
    mesh_batch_grad,
)
from weatherforecast_stgcn_maml_tpu_torch.parallel.meta_sp import local_route
from weatherforecast_stgcn_maml_tpu_torch.parallel.spatial import hybrid_local_forward
from weatherforecast_stgcn_maml_tpu_torch.train.maml import (
    TaskRoute,
    adapt_and_query_loss,
    check_supported,
)
from weatherforecast_stgcn_maml_tpu_torch.train.so_fused import plain_route, support_loss


def pinned_configs(model_cfg: ModelConfig, meta_cfg: MetaConfig):
    """The configs the GSPMD step runs: the plain routes and the per-leaf
    inner update (JAX `train/maml.py:make_meta_step` with `sp_axis`)."""
    return plain_route(model_cfg), dataclasses.replace(meta_cfg, fused_inner_update=False)


def gspmd_rows(masks: dict, mesh: Mesh) -> dict:
    """This rank's rows of one window's full-N masks, in the node-local
    forward's layouts: the encoder's [n, W, N, hid] -> [n, NL, W, hid]
    (node-major), the LSTM's [n, W, N, H] -> [n, W, NL, H], the head's
    [N, H] -> [NL, H]."""
    out = {}
    for site, m in masks.items():
        if site == "encoder":
            out[site] = node_rows(m, 2, mesh).transpose(1, 2)
        elif site == "lstm":
            out[site] = node_rows(m, 2, mesh)
        else:
            out[site] = node_rows(m, 0, mesh)
    return out


def gspmd_route(mesh: Mesh) -> TaskRoute:
    """The task route of a GSPMD dp x sp rank: `local_route`'s loss and
    inner-gradient sum over sp, with the family's node-local forward and
    each window's masks drawn at full N from the task's generator and cut
    to this rank's rows (`gspmd_rows`)."""
    group = mesh.sp_group
    base = local_route(group)

    def draw(cfg, generator, x):  # x [W, NL, C]
        w, nl = x.shape[:2]
        return gspmd_rows(window_masks(cfg, generator, w, nl * mesh.sp, x.device), mesh)

    def forward(model, a_rows, x, koppen, cfg, *, train=False, generator=None, masks=None):
        if train and masks is None:
            masks = draw(cfg, generator, x)
        return hybrid_local_forward(model, a_rows, x, koppen, cfg, group, train=train,
                                    masks=masks)

    def grad_loss_fused(model, cfg):
        # The routes are plain: "fhvp" takes the plain loss's gradient,
        # forward-differentiable through the collectives' jvps.
        return torch.func.grad(support_loss(model, plain_route(cfg), forward, base.mse))

    return base._replace(forward=forward, masks=draw, grad_loss_fused=grad_loss_fused)


def make_gspmd_batch_grad(model_cfg: ModelConfig, meta_cfg: MetaConfig, mesh: Mesh):
    """`batch_grad(params, tasks, key, fast=None, offset=0) -> (per-task
    losses [B], {name: mean meta-gradient})` of the GSPMD step (see
    parallel/meta_dp.mesh_batch_grad), on the pinned configs."""
    model_cfg, meta_cfg = pinned_configs(model_cfg, meta_cfg)
    route = gspmd_route(mesh)

    def task_loss(params, task, gen, fast):
        return adapt_and_query_loss(params, task, gen, model_cfg, meta_cfg, fast, route)

    return mesh_batch_grad(mesh, shard_task_batch_2d, task_loss, meta_cfg.second_order,
                           task_streams=True)


def make_parallel_meta_step_2d(model_cfg: ModelConfig, meta_cfg: MetaConfig, mesh: Mesh):
    """The GSPMD dp x sp meta step: `(state, tasks, key) -> (state,
    metrics)`, `tasks` the whole stacked batch on every rank, `key` a tuple
    of ints (None: no dropout). Every family, first or second order."""
    per_update = meta_cfg.meta_batch // max(1, meta_cfg.grad_accum)
    if per_update % mesh.dp:
        raise ValueError(
            f"tasks per update ({per_update}) must be divisible by the dp mesh axis "
            f"({mesh.dp}) for even sharding"
        )
    check_supported(meta_cfg)
    model_cfg, meta_cfg = pinned_configs(model_cfg, meta_cfg)
    return make_mesh_meta_step(meta_cfg, make_gspmd_batch_grad(model_cfg, meta_cfg, mesh))
