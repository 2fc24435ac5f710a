"""The region fleet: adapt many regions at once, their lanes split over the
ranks of a mesh.

Counterpart of `weatherforecast_stgcn_maml_tpu/parallel/fleet_mesh.py`.
Regional adaptations are independent (own parameters, data and Adam state;
no reduction across regions), so a fleet of R regions is a region-stacked
tree {name: [R, ...]} whose lanes are split over the mesh's data axis: each
rank holds and trains its contiguous block of lanes, as the JAX package's
`P("dp")` sharding places them, and no collective runs in a step. A fleet
whose R does not divide over the mesh is padded with copies of region 0
(`pad_fleet`); callers drop the padding lanes' results.

All regions share one padded node count and one feature length T. Each
region keeps its own learning rate (a host float a lane, from its own
`ClimateLRSchedule`) and its own dropout generator, so lane i computes
what the serial engine computes for region i.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from weatherforecast_stgcn_maml_tpu_torch.config import ModelConfig
from weatherforecast_stgcn_maml_tpu_torch.data.windows import WindowSpec, gather_batch
from weatherforecast_stgcn_maml_tpu_torch.models.losses import masked_mse
from weatherforecast_stgcn_maml_tpu_torch.models.registry import apply_model, functional_apply
from weatherforecast_stgcn_maml_tpu_torch.train.optimizers import AdaptOptimizer
from weatherforecast_stgcn_maml_tpu_torch.train.supervised import make_region_train_step


def pad_fleet(r: int, mesh=None) -> int:
    """Fleet size after padding to a multiple of the mesh size (no mesh:
    one rank)."""
    d = 1 if mesh is None else mesh.size
    return -(-r // d) * d


def lane_block(total: int, mesh=None) -> range:
    """This rank's contiguous block of the `total` lanes: its block of the
    data axis (ranks that share a dp index, over sp, hold the same lanes)."""
    if mesh is None:
        return range(total)
    per = total // mesh.dp
    return range(mesh.dp_index * per, (mesh.dp_index + 1) * per)


def stack_fleet(trees: list, mesh=None, device: torch.device | str | None = None):
    """Stack this rank's lanes of the per-region trees ({name: tensor}
    each) on a new leading axis, on `device`: the fleet padded to the mesh
    size with copies of the first tree. Returns (stacked, real_r)."""
    r = len(trees)
    lanes = [trees[i] if i < r else trees[0] for i in lane_block(pad_fleet(r, mesh), mesh)]
    stacked = {k: torch.stack([t[k].detach() for t in lanes]).to(device) for k in trees[0]}
    return stacked, r


def make_fleet_epoch_runner(model_cfg: ModelConfig, tx: AdaptOptimizer, spec: WindowSpec,
                            template: nn.Module):
    """A fleet training epoch over this rank's V lanes:

      run_epoch(params, states, features, anchor_batches, a_hat, node_mask,
                koppen, lrs, generators) -> (states, losses [V, nb])

    `params` is the region-stacked tree (updated in place), `states` the V
    lanes' Adam states, features [V, T, N, C], anchor_batches [V, nb, B]
    host integers, a_hat [V, N, N], node_mask [V, N], and koppen, lrs and
    generators one a lane. One fleet step (`make_region_train_step`) per
    batch index, each lane's window batch gathered from its own features."""
    step = make_region_train_step(model_cfg, tx, template)

    def run_epoch(params, states, features, anchor_batches, a_hat, node_mask, koppen, lrs,
                  generators):
        anchor_batches = np.asarray(anchor_batches)
        losses = []
        for b in range(anchor_batches.shape[1]):
            xs, ys = zip(*(gather_batch(features[v], anchor_batches[v, b], spec)
                           for v in range(anchor_batches.shape[0])))
            states, loss = step(params, states, torch.stack(xs), torch.stack(ys), a_hat,
                                node_mask, koppen, lrs, generators)
            losses.append(loss)
        return states, torch.stack(losses, dim=1)

    return run_epoch


def make_fleet_eval(model_cfg: ModelConfig, spec: WindowSpec, template: nn.Module):
    """Fleet evaluation over this rank's lanes: `run_eval(params, features,
    anchor_batches, a_hat, node_mask, koppen) -> [V, nb, B]` per-window
    MSEs (eval mode), each lane through `template`'s forward at its slice
    of the tree, batch by batch as the serial engine's eval."""

    @torch.no_grad()
    def run_eval(params, features, anchor_batches, a_hat, node_mask, koppen):
        out = []
        for v, batches in enumerate(np.asarray(anchor_batches)):
            lane = {k: p[v] for k, p in params.items()}
            rows = []
            for anchors in batches:
                x, y = gather_batch(features[v], anchors, spec)
                preds = functional_apply(template, lane, apply_model, a_hat[v], x, koppen[v],
                                         model_cfg)
                rows.append(torch.stack([masked_mse(p, t, node_mask[v])
                                         for p, t in zip(preds, y)]))
            out.append(torch.stack(rows))
        return torch.stack(out)

    return run_eval
