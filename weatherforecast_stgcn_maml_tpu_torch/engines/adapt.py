"""Regional adaptation engine.

Counterpart of `weatherforecast_stgcn_maml_tpu/engines/adapt.py`: load the
meta-trained checkpoint and the region's adaptation-year data, fine-tune
every trainable parameter with the climate-aware Adam under its per-epoch
lr schedule, score the held-out contiguous tail window by window, and save
the adapted checkpoint with the region's normalization stats (which
validation and forecasting reuse).

The features stay on the device (or move there chunk by chunk under
`adapt.max_device_timesteps`); each epoch runs one train step per batch of
`adapt.batch_size` windows gathered there. Dropout draws from a
torch.Generator on the device seeded from (adapt.seed, the region's name,
epoch, chunk), so regions never share masks and a rerun draws the same.
"""

from __future__ import annotations

import os
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from weatherforecast_stgcn_maml_tpu_torch.config import ExperimentConfig, to_dict
from weatherforecast_stgcn_maml_tpu_torch.data.preprocess import pad_nodes, prepare_features
from weatherforecast_stgcn_maml_tpu_torch.data.region import RegionData
from weatherforecast_stgcn_maml_tpu_torch.data.streaming import assign_anchors, plan_chunks
from weatherforecast_stgcn_maml_tpu_torch.data.windows import WindowSpec, contiguous_split
from weatherforecast_stgcn_maml_tpu_torch.engines.data_source import get_region_data
from weatherforecast_stgcn_maml_tpu_torch.graph import build_region_graph
from weatherforecast_stgcn_maml_tpu_torch.models.common import accum_dtype, resolve_dtype
from weatherforecast_stgcn_maml_tpu_torch.models.registry import init_model, load_params
from weatherforecast_stgcn_maml_tpu_torch.train.optimizers import (
    ClimateLRSchedule,
    adaptation_optimizer,
    climate_zone,
    masked_freeze,
    trainable_mask,
)
from weatherforecast_stgcn_maml_tpu_torch.train.supervised import (
    SupervisedState,
    make_batched_eval,
    make_epoch_runner,
)
from weatherforecast_stgcn_maml_tpu_torch.utils.checkpoint import (
    check_family,
    load_checkpoint,
    save_checkpoint,
)
from weatherforecast_stgcn_maml_tpu_torch.utils.metrics import JsonlLogger


@dataclass
class AdaptResult:
    ckpt_path: str
    val_mse: float
    epoch_losses: list
    region_name: str


def adapted_ckpt_path(out_dir: str, region_name: str, box) -> str:
    """`<out_dir>/adapted/<name>_<lat_min>_<lat_max>_<lon_min>_<lon_max>`,
    coordinates %g-canonicalized so int and float boxes share one path.
    Where that does not exist, a checkpoint under an older spelling,
    `<name>_(lat_min, lat_max, lon_min, lon_max)` with int or float
    coordinates, is found instead (and a new adaptation overwrites it)."""
    safe = region_name.replace("/", "_")
    coords = "_".join(f"{float(v):g}" for v in box)
    path = os.path.join(out_dir, "adapted", f"{safe}_{coords}")
    if not os.path.exists(path):
        for legacy_box in (tuple(box), tuple(float(v) for v in box)):
            legacy = os.path.join(out_dir, "adapted", f"{safe}_{legacy_box}")
            if os.path.exists(legacy):
                return legacy
    return path


def adapt_epoch_generator(
    seed: int, region_name: str, epoch: int, chunk: int, device: torch.device
) -> torch.Generator:
    """The dropout generator of one adaptation epoch and chunk, from the
    region's identity (a stable hash of its name) as well as (seed, epoch,
    chunk): without it every region would draw the same masks."""
    rid = zlib.crc32(region_name.encode()) % (2**31)
    state = np.random.SeedSequence([seed, rid, epoch, chunk]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(state[0]) << 32 | int(state[1]))


def _batch_anchors(anchors: np.ndarray, batch_size: int, *, shuffle, rng):
    """[S] anchors -> [nb, B], shuffled, the remainder wrapped around so
    every anchor appears at least once."""
    a = np.asarray(anchors)
    if shuffle:
        a = rng.permutation(a)
    b = max(1, min(batch_size, len(a)))
    nb = -(-len(a) // b)
    return np.resize(a, nb * b).reshape(nb, b)


def pad_eval_batches(anchors: np.ndarray, batch_size: int) -> np.ndarray:
    """[S] anchors -> [nb, B] for exact per-window eval: the last batch is
    padded by repeating the last anchor; callers drop the padding by
    slicing the flat losses back to len(anchors)."""
    a = np.asarray(anchors)
    b = max(1, min(batch_size, len(a)))
    nb = -(-len(a) // b)
    return np.concatenate([a, np.full(nb * b - len(a), a[-1])]).reshape(nb, b)


def run_adaptation(
    cfg: ExperimentConfig,
    box,
    region_name: str,
    *,
    device: torch.device | str,
    meta_ckpt: str | None = None,
    region: RegionData | None = None,
    log_cb=print,
) -> AdaptResult:
    device = torch.device(device)
    model_cfg, ad = cfg.model, cfg.adapt
    out_dir = cfg.out_dir
    if meta_ckpt is None:
        meta_ckpt = os.path.join(out_dir, "meta", "ckpt_best")

    state_dict, meta = load_checkpoint(meta_ckpt)
    check_family(meta, model_cfg.family, meta_ckpt)
    model = init_model(torch.Generator().manual_seed(0), model_cfg)
    load_params(model, state_dict)
    # Parameters are float32, and float64 under float64 compute (the JAX
    # package's x64 mode), so that a float64 run trains in float64.
    model = model.to(device, accum_dtype(resolve_dtype(model_cfg.compute_dtype)))
    log_cb(
        f"[adapt:{region_name}] loaded {meta_ckpt} (epoch {meta.get('epoch')}, "
        f"{sum(p.numel() for p in model.parameters()):,} params)"
    )

    if region is None:
        region = get_region_data(box, cfg.data.adapt_years, cfg.data, tag="adapt",
                                 name=region_name)
    graph = build_region_graph(region.lats, region.lons, k_neighbors=cfg.data.k_neighbors)
    features_np, stats = prepare_features(region, rel_coords=model_cfg.relative_coords)
    features_np = pad_nodes(features_np, graph.padded_nodes)

    spec = WindowSpec(model_cfg.window, model_cfg.horizon)
    chunks = plan_chunks(region.num_timesteps, spec, ad.max_device_timesteps)
    if len(chunks) > 1:
        log_cb(
            f"[adapt:{region_name}] streaming {region.num_timesteps} timesteps to the "
            f"device in {len(chunks)} chunks of {chunks[0].stop - chunks[0].start}"
        )
    whole = torch.from_numpy(features_np).to(device) if len(chunks) == 1 else None

    def chunk_features(i):
        if whole is not None:
            return whole
        return torch.from_numpy(features_np[chunks[i].start : chunks[i].stop]).to(device)

    n_samples = spec.num_samples(region.num_timesteps)
    train_idx, val_idx = contiguous_split(n_samples, ad.train_fraction, ad.max_samples)
    if len(train_idx) == 0 or len(val_idx) == 0:
        raise ValueError(
            f"region {region_name}: {n_samples} windows cannot be split "
            f"{ad.train_fraction:.0%}/{1 - ad.train_fraction:.0%}"
        )
    log_cb(
        f"[adapt:{region_name}] {len(train_idx)} train / {len(val_idx)} val windows, "
        f"{graph.num_nodes} nodes (padded {graph.padded_nodes}), climate zone "
        f"{climate_zone(region_name)}"
    )

    # The reference adapts with Koppen code 0 (the padding class) under this flag.
    koppen = 0 if cfg.compat.koppen_zero_in_adapt else max(region.koppen_code, 0)
    a_hat = torch.from_numpy(graph.a_hat).to(device)
    node_mask = torch.from_numpy(graph.node_mask).to(device)

    tx, lr0 = adaptation_optimizer(region_name, ad.base_lr, ad.clip_norm)
    params = dict(model.named_parameters())
    if model_cfg.stop_base_gradients or not model_cfg.train_koppen_embedding:
        tx = masked_freeze(tx, trainable_mask(params, model_cfg))
    run_epoch = make_epoch_runner(model_cfg, tx, spec)
    run_eval = make_batched_eval(model_cfg, spec)
    # The schedule takes the raw base lr and applies the zone's multiplier
    # itself; epoch 1 runs at the optimizer's lr0 = base * multiplier, and
    # the schedule steps after each epoch to set the next one's.
    schedule = ClimateLRSchedule(region_name, base_lr=ad.base_lr)

    state = SupervisedState(model, tx.init(params))
    np_rng = np.random.default_rng(ad.seed)
    jsonl = JsonlLogger(os.path.join(out_dir, "adapt", f"{region_name}.jsonl"))
    train_sets = assign_anchors(chunks, spec.window + train_idx, spec)
    val_sets = assign_anchors(chunks, spec.window + val_idx, spec)
    active = [ci for ci in range(len(chunks)) if len(train_sets[ci]) > 0]

    epoch_losses: list[float] = []
    lr = lr0
    for epoch in range(ad.epochs):
        losses = []
        for ci in active:
            batches = _batch_anchors(train_sets[ci], ad.batch_size, shuffle=ad.shuffle,
                                     rng=np_rng)
            state, chunk_losses = run_epoch(
                state, chunk_features(ci), batches, a_hat, node_mask, koppen, lr,
                adapt_epoch_generator(ad.seed, region_name, epoch, ci, device),
            )
            losses.append(chunk_losses)
        avg = float(torch.cat(losses).double().mean())
        epoch_losses.append(avg)
        jsonl.log({"epoch": epoch + 1, "loss": avg, "lr": lr})
        log_cb(f"[adapt:{region_name}] epoch {epoch + 1}/{ad.epochs} loss {avg:.6f} lr {lr:.6f}")
        lr = schedule.step(avg)

    # Exact per-window validation MSE: the last batch is padded with the
    # last anchor and the padding's losses are dropped.
    total_se, total_n = 0.0, 0
    for ci, anchors in enumerate(val_sets):
        if len(anchors) == 0:
            continue
        per_window = run_eval(
            state.params, chunk_features(ci), pad_eval_batches(anchors, ad.batch_size),
            a_hat, node_mask, koppen,
        ).reshape(-1)[: len(anchors)]
        total_se += float(per_window.double().sum())
        total_n += len(anchors)
    val_mse = total_se / max(1, total_n)
    log_cb(f"[adapt:{region_name}] validation MSE {val_mse:.6f}")

    path = adapted_ckpt_path(out_dir, region_name, box)
    save_checkpoint(
        path,
        state.params.state_dict(),
        {
            "schema": "wfstgcn-adapted-v1",
            "model_version": "torch-1.0",
            "region": list(box),
            "region_name": region_name,
            "climate_zone": climate_zone(region_name),
            "koppen_code": int(region.koppen_code),
            "stats": stats.to_dict(),
            "val_mse": val_mse,
            "epoch_losses": epoch_losses,
            "base_checkpoint": os.path.abspath(meta_ckpt),
            "config": to_dict(cfg),
        },
    )
    log_cb(f"[adapt:{region_name}] saved {path}")
    return AdaptResult(ckpt_path=path, val_mse=val_mse, epoch_losses=epoch_losses,
                       region_name=region_name)
