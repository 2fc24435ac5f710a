"""Meta-training engine: MAML over the meta-training regions, on one device
or on a mesh of ranks.

Counterpart of `weatherforecast_stgcn_maml_tpu/engines/meta_train.py`:
load the regions and build their tasks (a region that fails to load or
build is skipped), fit meta_batch / grad_accum to the tasks built, then run
`num_epochs` meta epochs of difficulty-sampled task batches. Every epoch
appends `meta_log.csv` and `meta_log.jsonl`; `ckpt_best` keeps the best
epoch, `ckpt_last` (every `checkpoint_every` epochs and the last) carries
the optimizer and sampler state for `resume`, `ckpt_final` the end state.
The sidecar schema is the JAX package's (`wfstgcn-meta-v1`), and
`ckpt_best`'s `params.pt` is what `forecast` and `validate` load. Float64
compute trains float64 parameters on float64 tasks.

Epochs run in chunks of `meta.epochs_per_dispatch` = k (the remainder,
when fewer than k epochs are left, one at a time), each chunk one call of
the chained step (train/maml.make_chained_meta_step). The k batches of a
chunk are sampled before the sampler sees any of its losses, so within a
chunk it draws from difficulties up to k - 1 epochs stale; the metrics
reach the host once a chunk (`fetch_metrics`); best and last checkpoints
are decided at chunk ends from the chunk-end loss and state. k = 1 is the
reference's epoch-by-epoch cadence.

Dropout draws from a torch.Generator on the device seeded from
(meta.seed + 1, epoch), so a resumed run draws what a straight run draws.

On a mesh (parallel/mesh.py; `cli meta-train --mesh`) every rank runs this
engine: a 1-D mesh takes the data-parallel step (parallel/meta_dp.py), a
dp x sp mesh the node-sharded one (parallel/meta_sp.py, `mesh.sp_impl`
"shardmap") or the GSPMD one (parallel/meta_gspmd.py, "gspmd"; "auto"
picks it for every family but the hybrid), each keyed by (meta.seed + 1,
epoch). Every rank stages the whole task pool and keeps its own sampler;
the steps hand every rank every task's loss, so the samplers pick the
same tasks. Rank 0 alone writes the logs and checkpoints, and every rank
waits at a barrier after each save; on `resume` every rank loads
`ckpt_last`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from weatherforecast_stgcn_maml_tpu_torch.config import (
    META_TRAIN_REGIONS,
    ExperimentConfig,
    to_dict,
)
from weatherforecast_stgcn_maml_tpu_torch.data.region import RegionData
from weatherforecast_stgcn_maml_tpu_torch.engines.data_source import get_region_data
from weatherforecast_stgcn_maml_tpu_torch.parallel.mesh import Mesh, resolve_sp_impl
from weatherforecast_stgcn_maml_tpu_torch.parallel.meta_dp import make_parallel_meta_step
from weatherforecast_stgcn_maml_tpu_torch.parallel.meta_gspmd import make_parallel_meta_step_2d
from weatherforecast_stgcn_maml_tpu_torch.parallel.meta_sp import make_shardmap_meta_step_2d
from weatherforecast_stgcn_maml_tpu_torch.train.maml import (
    MamlState,
    check_supported,
    fetch_metrics,
    init_meta_state,
    make_chained_meta_step,
    make_meta_step,
)
from weatherforecast_stgcn_maml_tpu_torch.train.optimizers import AdamState
from weatherforecast_stgcn_maml_tpu_torch.train.sampling import DifficultySampler
from weatherforecast_stgcn_maml_tpu_torch.train.tasks import (
    build_task,
    common_padded_nodes,
    stage_tasks,
)
from weatherforecast_stgcn_maml_tpu_torch.utils.checkpoint import (
    checkpoint_exists,
    load_checkpoint,
    load_opt_state,
    save_checkpoint,
)
from weatherforecast_stgcn_maml_tpu_torch.utils.metrics import CsvLogger, JsonlLogger
from weatherforecast_stgcn_maml_tpu_torch.utils.profiling import Timer


@dataclass
class MetaTrainResult:
    best_loss: float
    final_loss: float
    best_path: str
    final_path: str
    epochs_run: int
    param_count: int


def _load_regions(cfg: ExperimentConfig, log_cb) -> list[RegionData]:
    """The meta-training regions in META_TRAIN_REGIONS order; a region that
    fails to load is skipped without reordering the rest."""
    regions = []
    for i, box in enumerate(META_TRAIN_REGIONS):
        try:
            regions.append(
                get_region_data(box, cfg.data.train_years, cfg.data, tag="train",
                                name=f"region{i}")
            )
        except Exception as e:
            log_cb(f"[meta-train] skipping region {box}: {e}")
    return regions


def epoch_generator(seed: int, epoch: int, device: torch.device) -> torch.Generator:
    """The dropout generator of one meta epoch, from (seed, epoch) alone."""
    state = np.random.SeedSequence([seed, epoch]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        int(state[0]) << 32 | int(state[1])
    )


def _check_mesh(cfg: ExperimentConfig, mesh: Mesh) -> str | None:
    """The dp x sp step `mesh` runs ("shardmap" or "gspmd", `mesh.sp_impl`
    resolved for the model family), None on a 1-D mesh; an unknown
    `mesh.sp_impl` raises."""
    if len(mesh.axis_names) == 1:
        return None
    sp_impl = resolve_sp_impl(cfg.mesh.sp_impl, cfg.model)
    if sp_impl not in ("gspmd", "shardmap"):
        raise ValueError(
            f"mesh.sp_impl={cfg.mesh.sp_impl!r}: expected 'auto', 'gspmd' or 'shardmap'"
        )
    return sp_impl


def run_meta_training(
    cfg: ExperimentConfig,
    regions: list[RegionData] | None = None,
    *,
    device: torch.device | str | None = None,
    mesh: Mesh | None = None,
    resume: bool = False,
    log_cb=print,
) -> MetaTrainResult:
    """Meta-train on `device`, or on `mesh` (this rank's part; its device)."""
    if mesh is None and device is None:
        raise ValueError("pass a device, or a mesh")
    device = mesh.device if mesh is not None else torch.device(device)
    main = mesh is None or mesh.rank == 0
    if not main:
        log_cb = lambda *a: None  # noqa: E731 - rank 0 reports for the mesh
    model_cfg, meta_cfg = cfg.model, cfg.meta
    check_supported(meta_cfg)
    sp_impl = None if mesh is None else _check_mesh(cfg, mesh)
    out_dir = os.path.join(cfg.out_dir, "meta")
    os.makedirs(out_dir, exist_ok=True)

    if regions is None:
        regions = _load_regions(cfg, log_cb)
    if not regions:
        raise RuntimeError("no meta-training regions could be loaded")
    timer = Timer()
    with timer.span("task_build"):
        pad = common_padded_nodes(regions)
        built = []
        for r in regions:
            try:
                built.append(build_task(r, model_cfg, meta_cfg, cfg.data, pad_to=pad))
            except Exception as e:
                log_cb(f"[meta-train] skipping region {r.name!r}: {e}")
    if not built:
        raise RuntimeError("no meta-training tasks could be built")
    log_cb(
        f"[meta-train] {len(built)} tasks, padded nodes="
        f"{built[0].graph.padded_nodes}"
    )

    # Fewer tasks than meta_batch, or a batch grad_accum does not divide:
    # take the nearest valid decomposition.
    batch = min(meta_cfg.meta_batch, len(built))
    accum = max(1, min(meta_cfg.grad_accum, batch))
    while batch % accum:
        accum -= 1
    if (batch, accum) != (meta_cfg.meta_batch, meta_cfg.grad_accum):
        log_cb(
            f"[meta-train] adjusting meta_batch {meta_cfg.meta_batch}->"
            f"{batch}, grad_accum {meta_cfg.grad_accum}->{accum} "
            f"({len(built)} tasks available)"
        )
        meta_cfg = dataclasses.replace(meta_cfg, meta_batch=batch, grad_accum=accum)

    state = init_meta_state(
        torch.Generator().manual_seed(meta_cfg.seed), model_cfg, meta_cfg, device=device
    )
    params_n = sum(p.numel() for p in state.params.parameters())
    log_cb(f"[meta-train] {model_cfg.family} model: {params_n:,} parameters")
    if mesh is None:
        meta_step = make_meta_step(model_cfg, meta_cfg)
    elif sp_impl is None:
        meta_step = make_parallel_meta_step(model_cfg, meta_cfg, mesh)
    elif sp_impl == "shardmap":
        meta_step = make_shardmap_meta_step_2d(model_cfg, meta_cfg, mesh)
    else:
        meta_step = make_parallel_meta_step_2d(model_cfg, meta_cfg, mesh)
    if sp_impl is not None:
        log_cb(f"[meta-train] dp {mesh.dp} x sp {mesh.sp} mesh: "
               + ("the node-sharded (shardmap) step" if sp_impl == "shardmap" else
                  "the GSPMD step (plain routes, per-leaf inner update)"))
    if mesh is None:
        chained = make_chained_meta_step(
            meta_step, lambda e: epoch_generator(meta_cfg.seed + 1, e, device))
    else:  # each task's generator derives from the epoch's key
        chained = make_chained_meta_step(meta_step, lambda e: (meta_cfg.seed + 1, e))

    sampler = DifficultySampler(
        len(built), meta_cfg.meta_batch, ema=meta_cfg.difficulty_ema, seed=meta_cfg.seed
    )
    if main:
        csv = CsvLogger(
            os.path.join(out_dir, "meta_log.csv"), ["epoch", "meta_loss", "learning_rate"]
        )
        jsonl = JsonlLogger(os.path.join(out_dir, "meta_log.jsonl"))
    best_path = os.path.join(out_dir, "ckpt_best")
    final_path = os.path.join(out_dir, "ckpt_final")
    last_path = os.path.join(out_dir, "ckpt_last")
    task_names = [b.region_name or f"task{i}" for i, b in enumerate(built)]

    start_epoch, best_loss = 0, float("inf")
    resumed_meta: dict = {}
    if resume and checkpoint_exists(last_path):
        state_dict, meta = load_checkpoint(last_path)
        state.params.load_state_dict(state_dict)
        opt = load_opt_state(last_path)
        if opt is None:
            raise FileNotFoundError(f"{last_path} holds no optimizer state to resume from")
        state = MamlState(
            state.params,
            AdamState(
                opt["count"],
                {k: v.to(device) for k, v in opt["mu"].items()},
                {k: v.to(device) for k, v in opt["nu"].items()},
            ),
            int(meta["step"]),
        )
        # Sampler state means something only for the same task pool.
        if meta.get("task_names") == task_names:
            sampler.difficulty = np.asarray(meta["sampler_difficulty"], np.float64)
            sampler.seen = np.asarray(meta["sampler_seen"], bool)
            rng_state = meta.get("sampler_rng_state")
            if rng_state is not None:
                sampler._rng.bit_generator.state = rng_state
        else:
            log_cb(
                "[meta-train] task pool changed since the checkpoint; "
                "resetting the difficulty sampler"
            )
        start_epoch = int(meta["epoch"]) + 1
        best_loss = float(meta["best_loss"])
        resumed_meta = meta
        log_cb(f"[meta-train] resumed at epoch {start_epoch} (best {best_loss:.4f})")

    def ckpt_meta(epoch, loss):
        return {
            "schema": "wfstgcn-meta-v1",
            "model_version": "torch-1.0",
            "epoch": epoch,
            "step": state.step,
            "meta_loss": loss,
            "best_loss": best_loss,
            "total_params": params_n,
            "config": to_dict(cfg),
            "task_names": task_names,
            "sampler_difficulty": sampler.difficulty.tolist(),
            "sampler_seen": sampler.seen.tolist(),
            # bit_generator.state nests numpy integers: round-trip to JSON.
            "sampler_rng_state": json.loads(json.dumps(
                sampler._rng.bit_generator.state,
                default=lambda o: o.item() if hasattr(o, "item") else list(o),
            )),
        }

    def save(path, epoch, loss):
        if main:
            save_checkpoint(
                path, state.params.state_dict(), ckpt_meta(epoch, loss),
                opt_state=state.opt_state._asdict(),
            )
        if mesh is not None:
            dist.barrier(group=mesh.group)

    if start_epoch >= meta_cfg.num_epochs:
        log_cb(
            f"[meta-train] checkpoint already at epoch {start_epoch} >= "
            f"num_epochs {meta_cfg.num_epochs}; nothing to do"
        )
        return MetaTrainResult(
            best_loss=best_loss,
            final_loss=float(resumed_meta.get("meta_loss", best_loss)),
            best_path=best_path,
            final_path=final_path,
            epochs_run=0,
            param_count=params_n,
        )

    staged = stage_tasks([b.task for b in built], device)
    if next(state.params.parameters()).dtype == torch.float64:
        staged = type(staged)(*(f.double() if f.is_floating_point() else f for f in staged))
    k = max(1, int(meta_cfg.epochs_per_dispatch))
    loss = float("nan")
    epoch = start_epoch
    while epoch < meta_cfg.num_epochs:
        # A remainder shorter than k runs one epoch at a time.
        kk = k if meta_cfg.num_epochs - epoch >= k else 1
        t0 = time.perf_counter()
        idx_k = np.stack([sampler.sample() for _ in range(kk)])
        state, metrics = chained(state, staged, idx_k, range(epoch, epoch + kk))
        loss_k, per_task_k, lr_k = fetch_metrics(metrics)
        dt = time.perf_counter() - t0
        for j in range(kk):
            sampler.update(idx_k[j], per_task_k[j])
            if main:
                csv.log(epoch=epoch + j + 1, meta_loss=float(loss_k[j]),
                        learning_rate=float(lr_k[j]))
                rec = {
                    "epoch": epoch + j + 1,
                    "meta_loss": float(loss_k[j]),
                    "learning_rate": float(lr_k[j]),
                    "per_task_loss": per_task_k[j].tolist(),
                    "task_indices": idx_k[j].tolist(),
                    "epoch_seconds": dt / kk,
                }
                if kk > 1:
                    rec["dispatch_epochs"] = kk
                jsonl.log(rec)
        loss, lr = float(loss_k[-1]), float(lr_k[-1])
        last_epoch = epoch + kk - 1
        log_cb(
            f"[meta-train] epoch {last_epoch + 1}/{meta_cfg.num_epochs} "
            f"loss {loss:.4f} lr {lr:.6f} ({dt:.2f}s"
            + (f", {kk} epochs/dispatch)" if kk > 1 else ")")
        )
        # The chunk-end loss and state decide: the parameters of an epoch
        # inside the chunk are gone by now.
        if loss < best_loss:
            best_loss = loss
            save(best_path, last_epoch, loss)
        if (last_epoch + 1) % max(1, meta_cfg.checkpoint_every) < kk or (
            last_epoch == meta_cfg.num_epochs - 1
        ):
            save(last_path, last_epoch, loss)
        epoch += kk

    save(final_path, meta_cfg.num_epochs - 1, loss)
    log_cb(f"[meta-train] done: best {best_loss:.4f}; spans {timer.summary()}")
    return MetaTrainResult(
        best_loss=best_loss,
        final_loss=loss,
        best_path=best_path,
        final_path=final_path,
        epochs_run=meta_cfg.num_epochs - start_epoch,
        param_count=params_n,
    )
