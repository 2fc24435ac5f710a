"""Fleet adaptation: many regions fine-tuned side by side.

Counterpart of `weatherforecast_stgcn_maml_tpu/engines/fleet_adapt.py`.
Regions are grouped by climate zone (a zone's regions share the Adam's
weight decay) and each group trains as one fleet (`parallel/fleet_mesh.py`):
a region-stacked tree whose lanes are split over the ranks of a mesh, each
lane with its own learning rate, Adam state, batch shuffle and dropout
generator. Lane i computes what the serial engine (`engines/adapt.py`)
computes for region i: the same optimizer and schedule, the same
contiguous split, the same checkpoint schema (with `"fleet_mesh": true`).

With no mesh, this process holds every lane; on a mesh (every rank calls
this with the same regions) each rank trains its block of lanes, writes
the checkpoints and logs of its regions, and every rank returns every
region's result.

Limitations, as in the JAX package: the regions of a group must share the
feature length T and the padded node count, and streaming
(`adapt.max_device_timesteps`) is refused: a fleet keeps every region's
features on its device.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from weatherforecast_stgcn_maml_tpu_torch.config import ExperimentConfig, to_dict
from weatherforecast_stgcn_maml_tpu_torch.data.preprocess import pad_nodes, prepare_features
from weatherforecast_stgcn_maml_tpu_torch.data.windows import WindowSpec, contiguous_split
from weatherforecast_stgcn_maml_tpu_torch.engines.adapt import (
    AdaptResult,
    _batch_anchors,
    adapt_epoch_generator,
    adapted_ckpt_path,
    pad_eval_batches,
)
from weatherforecast_stgcn_maml_tpu_torch.engines.data_source import get_region_data
from weatherforecast_stgcn_maml_tpu_torch.graph import build_region_graph
from weatherforecast_stgcn_maml_tpu_torch.models.common import accum_dtype, resolve_dtype
from weatherforecast_stgcn_maml_tpu_torch.models.registry import init_model, load_params
from weatherforecast_stgcn_maml_tpu_torch.parallel.fleet_mesh import (
    lane_block,
    make_fleet_epoch_runner,
    make_fleet_eval,
    pad_fleet,
    stack_fleet,
)
from weatherforecast_stgcn_maml_tpu_torch.train.optimizers import (
    ClimateLRSchedule,
    adaptation_optimizer,
    climate_zone,
    masked_freeze,
    trainable_mask,
)
from weatherforecast_stgcn_maml_tpu_torch.utils.checkpoint import (
    check_family,
    load_checkpoint,
    save_checkpoint,
)
from weatherforecast_stgcn_maml_tpu_torch.utils.metrics import JsonlLogger


def run_fleet_adaptation(
    cfg: ExperimentConfig,
    regions: list[tuple[tuple, str]],
    *,
    device: torch.device | str | None = None,
    meta_ckpt: str | None = None,
    mesh=None,
    log_cb=print,
) -> list[AdaptResult]:
    """Adapt `[(box, name), ...]` as fleets, one a climate zone, on
    `device` or on `mesh` (this rank's lanes, on its device). Returns the
    AdaptResults in input order, the serial engine's artifacts per region:
    its adapted checkpoint (with stats) and its `adapt/<name>.jsonl`."""
    model_cfg, ad = cfg.model, cfg.adapt
    if ad.max_device_timesteps:
        raise ValueError(
            "fleet adaptation keeps whole regions in HBM; "
            "adapt.max_device_timesteps (streaming) requires the serial engine"
        )
    if mesh is None and device is None:
        raise ValueError("pass a device, or a mesh")
    device = mesh.device if mesh is not None else torch.device(device)
    if meta_ckpt is None:
        meta_ckpt = os.path.join(cfg.out_dir, "meta", "ckpt_best")

    state_dict, meta = load_checkpoint(meta_ckpt)
    check_family(meta, model_cfg.family, meta_ckpt)
    template = init_model(torch.Generator().manual_seed(0), model_cfg)
    load_params(template, state_dict)
    template = template.to(device, accum_dtype(resolve_dtype(model_cfg.compute_dtype)))

    # A zone's regions share one optimizer (its weight decay).
    by_zone: dict[str, list[int]] = {}
    for i, (_, name) in enumerate(regions):
        by_zone.setdefault(climate_zone(name), []).append(i)

    results: list[AdaptResult | None] = [None] * len(regions)
    spec = WindowSpec(model_cfg.window, model_cfg.horizon)
    ranks = 1 if mesh is None else mesh.size
    for zone, idxs in by_zone.items():
        group = [regions[i] for i in idxs]
        log_cb(f"[fleet-adapt] zone {zone}: {len(group)} regions over {ranks} ranks")
        for i, res in zip(idxs, _run_zone_group(
                cfg, group, zone, template, spec, device, mesh, meta_ckpt, log_cb)):
            results[i] = res
    return results  # type: ignore[return-value]


def _run_zone_group(cfg, group, zone, template, spec, device, mesh, meta_ckpt, log_cb):
    model_cfg, ad = cfg.model, cfg.adapt
    tx, lr0 = adaptation_optimizer(group[0][1], ad.base_lr, ad.clip_norm)
    meta_params = dict(template.named_parameters())
    if model_cfg.stop_base_gradients or not model_cfg.train_koppen_embedding:
        tx = masked_freeze(tx, trainable_mask(meta_params, model_cfg))

    feats, a_hats, masks, kops, stats_list, datas = [], [], [], [], [], []
    for box, name in group:
        region = get_region_data(box, cfg.data.adapt_years, cfg.data, tag="adapt", name=name)
        graph = build_region_graph(region.lats, region.lons, k_neighbors=cfg.data.k_neighbors)
        f_np, stats = prepare_features(region, rel_coords=model_cfg.relative_coords)
        feats.append(pad_nodes(f_np, graph.padded_nodes))
        a_hats.append(graph.a_hat)
        masks.append(graph.node_mask)
        kops.append(0 if cfg.compat.koppen_zero_in_adapt else max(region.koppen_code, 0))
        stats_list.append(stats)
        datas.append(region)
    t_set = {f.shape[0] for f in feats}
    n_set = {f.shape[1] for f in feats}
    if len(t_set) > 1 or len(n_set) > 1:
        raise ValueError(
            f"fleet regions must share (T, padded N); got T={sorted(t_set)} "
            f"N={sorted(n_set)} — pad/trim histories or use the serial engine"
        )

    n_samples = spec.num_samples(feats[0].shape[0])
    train_idx, val_idx = contiguous_split(n_samples, ad.train_fraction, ad.max_samples)
    if len(train_idx) == 0 or len(val_idx) == 0:
        raise ValueError(f"{n_samples} windows cannot be split {ad.train_fraction:.0%}")

    run_epoch = make_fleet_epoch_runner(model_cfg, tx, spec, template)
    run_eval = make_fleet_eval(model_cfg, spec, template)

    r = len(group)
    total = pad_fleet(r, mesh)
    lanes = lane_block(total, mesh)
    params, _ = stack_fleet([meta_params] * r, mesh, device)
    states = [tx.init({k: p[v] for k, p in params.items()}) for v in range(len(lanes))]

    def local(values):  # this rank's lanes of a per-region list, padded with region 0's
        return [values[i] if i < r else values[0] for i in lanes]

    features = torch.from_numpy(np.stack(local(feats))).to(device)
    a_hat = torch.from_numpy(np.stack(local(a_hats))).to(device)
    node_mask = torch.from_numpy(np.stack(local(masks))).to(device)
    koppen = local(kops)
    names = local([name for _, name in group])
    owned = [(j, i) for j, i in enumerate(lanes) if i < r]  # (local lane, region)
    writer = mesh is None or mesh.sp_index == 0

    # Each lane shuffles with its own generator, seeded as the serial
    # engine's, and keeps its own schedule (a padding lane too: sharing one
    # would advance it once a lane). The schedule takes the raw base lr.
    np_rngs = [np.random.default_rng(ad.seed) for _ in lanes]
    schedules = [ClimateLRSchedule(name, base_lr=ad.base_lr) for name in names]
    lrs = [lr0] * len(lanes)
    anchors = spec.window + train_idx
    jsonls = {j: JsonlLogger(os.path.join(cfg.out_dir, "adapt", f"{names[j]}.jsonl"))
              for j, _ in owned if writer}

    epoch_losses = [[] for _ in lanes]
    for epoch in range(ad.epochs):
        batches = np.stack([_batch_anchors(anchors, ad.batch_size, shuffle=ad.shuffle, rng=g)
                            for g in np_rngs])
        # Each lane draws its own masks, from its region's generator (a
        # padding lane from region 0's), as the serial engine draws them.
        generators = [adapt_epoch_generator(ad.seed, name, epoch, 0, device) for name in names]
        states, losses = run_epoch(params, states, features, batches, a_hat, node_mask, koppen,
                                   lrs, generators)
        for j in range(len(lanes)):
            avg = float(losses[j].double().mean())
            epoch_losses[j].append(avg)
            if j in jsonls:
                jsonls[j].log({"epoch": epoch + 1, "loss": avg, "lr": lrs[j]})
            lrs[j] = schedules[j].step(avg)
        log_cb(
            f"[fleet-adapt] zone {zone} epoch {epoch + 1}/{ad.epochs} "
            f"losses {[round(epoch_losses[j][-1], 4) for j, _ in owned]}"
        )

    # Exact per-window validation: the last batch padded, its padding dropped.
    val_anchors = spec.window + val_idx
    padded = pad_eval_batches(val_anchors, ad.batch_size)
    per_window = run_eval(params, features, np.broadcast_to(padded, (len(lanes),) + padded.shape),
                          a_hat, node_mask, koppen).reshape(len(lanes), -1)[:, :len(val_anchors)]

    mine = {}
    for j, i in owned:
        box, name = group[i]
        val_mse = float(per_window[j].double().sum()) / len(val_anchors)
        path = adapted_ckpt_path(cfg.out_dir, name, box)
        if writer:
            save_checkpoint(
                path,
                {k: p[j].clone() for k, p in params.items()},
                {
                    "schema": "wfstgcn-adapted-v1",
                    "model_version": "torch-1.0",
                    "region": list(box),
                    "region_name": name,
                    "climate_zone": zone,
                    "koppen_code": int(datas[i].koppen_code),
                    "stats": stats_list[i].to_dict(),
                    "val_mse": val_mse,
                    "epoch_losses": epoch_losses[j],
                    "base_checkpoint": os.path.abspath(meta_ckpt),
                    "config": to_dict(cfg),
                    "fleet_mesh": True,
                },
            )
            log_cb(f"[fleet-adapt] {name}: val MSE {val_mse:.6f} -> {path}")
        mine[i] = AdaptResult(ckpt_path=path, val_mse=val_mse, epoch_losses=epoch_losses[j],
                              region_name=name)
    if mesh is not None and mesh.size > 1:
        everyone = [None] * mesh.size
        dist.all_gather_object(everyone, mine, group=mesh.group)
        for part in everyone:
            mine.update(part)
    return [mine[i] for i in range(r)]
