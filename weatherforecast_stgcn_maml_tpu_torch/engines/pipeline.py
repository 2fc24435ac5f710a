"""The multi-region pipeline (counterpart of
`weatherforecast_stgcn_maml_tpu/engines/pipeline.py`).

For each named region: adapt the meta-trained model unless an adapted
checkpoint exists, then validate. Each region is error-isolated and timed,
and the run ends with a summary. The region list can be sharded across
hosts (`shard_id` / `num_shards`); they share checkpoints through the
filesystem. Validation writes its plots unless `make_plots` is False;
where matplotlib is missing that raises an ImportError naming `--no-plots`
before the first region.

With `mesh_fleet`, every region without an adapted checkpoint is first
adapted in one fleet pass (`engines/fleet_adapt.py`: regions side by side,
grouped by climate zone); if the fleet raises, the per-region loop below
adapts what is still missing, as without it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from weatherforecast_stgcn_maml_tpu_torch.config import ADAPTATION_REGIONS, ExperimentConfig
from weatherforecast_stgcn_maml_tpu_torch.engines.adapt import adapted_ckpt_path, run_adaptation
from weatherforecast_stgcn_maml_tpu_torch.engines.fleet_adapt import run_fleet_adaptation
from weatherforecast_stgcn_maml_tpu_torch.engines.validate import run_validation
from weatherforecast_stgcn_maml_tpu_torch.eval.plots import require_matplotlib
from weatherforecast_stgcn_maml_tpu_torch.parallel.fleet import partition_round_robin
from weatherforecast_stgcn_maml_tpu_torch.utils.checkpoint import checkpoint_exists
from weatherforecast_stgcn_maml_tpu_torch.utils.metrics import JsonlLogger


@dataclass
class PipelineResult:
    validations: dict = field(default_factory=dict)  # name -> results dict
    errors: dict = field(default_factory=dict)  # name -> error string
    seconds: dict = field(default_factory=dict)  # name -> wall-clock


def run_pipeline(
    cfg: ExperimentConfig,
    regions=None,
    *,
    device: torch.device | str,
    shard_id: int = 0,
    num_shards: int = 1,
    make_plots: bool = True,
    mesh_fleet: bool = False,
    log_cb=print,
) -> PipelineResult:
    if make_plots:
        require_matplotlib()
    if regions is None:
        regions = list(ADAPTATION_REGIONS)
    regions = partition_round_robin(regions, num_shards, shard_id)
    result = PipelineResult()
    jsonl = JsonlLogger(f"{cfg.out_dir}/pipeline.jsonl")

    if mesh_fleet:
        pending = [
            (box, name) for box, name in regions
            if not checkpoint_exists(adapted_ckpt_path(cfg.out_dir, name, box))
        ]
        if pending:
            t0 = time.perf_counter()
            try:
                run_fleet_adaptation(cfg, pending, device=device, log_cb=log_cb)
                log_cb(
                    f"[pipeline] fleet-adapted {len(pending)} regions in "
                    f"{time.perf_counter() - t0:.1f}s"
                )
            except Exception as e:
                log_cb(
                    f"[pipeline] fleet adaptation failed "
                    f"({type(e).__name__}: {e}); falling back to serial"
                )

    for box, name in regions:
        t0 = time.perf_counter()
        try:
            log_cb(f"[pipeline] region {name} {box}")
            if not checkpoint_exists(adapted_ckpt_path(cfg.out_dir, name, box)):
                run_adaptation(cfg, box, name, device=device, log_cb=log_cb)
            else:
                log_cb(f"[pipeline] using existing adapted model for {name}")
            val = run_validation(
                cfg, box, name, device=device, make_plots=make_plots, log_cb=log_cb
            )
            result.validations[name] = val.results
            jsonl.log({"region": name, "status": "ok", "results": val.results})
        except Exception as e:  # per-region isolation
            result.errors[name] = f"{type(e).__name__}: {e}"
            log_cb(f"[pipeline] ERROR in {name}: {result.errors[name]}")
            jsonl.log({"region": name, "status": "error", "error": str(e)})
        finally:
            result.seconds[name] = time.perf_counter() - t0
            log_cb(f"[pipeline] {name}: {result.seconds[name]:.1f}s")

    log_cb("[pipeline] summary:")
    for name, secs in result.seconds.items():
        status = "ok" if name in result.validations else "ERROR"
        mse = result.validations.get(name, {}).get("average_mse", float("nan"))
        log_cb(f"  {name:>28}: {secs / 60:6.1f} min  {status}  avg_mse={mse:.3f}")
    return result
