"""Command-line interface of the PyTorch port:

  python -m weatherforecast_stgcn_maml_tpu_torch.cli meta-train
  python -m weatherforecast_stgcn_maml_tpu_torch.cli adapt --region Moscow
  python -m weatherforecast_stgcn_maml_tpu_torch.cli validate --region Moscow --no-plots
  python -m weatherforecast_stgcn_maml_tpu_torch.cli forecast --region Moscow
  python -m weatherforecast_stgcn_maml_tpu_torch.cli pipeline --regions "Moscow;NewYork" --no-plots
  python -m weatherforecast_stgcn_maml_tpu_torch.cli pipeline --mesh-fleet --no-plots
  python -m weatherforecast_stgcn_maml_tpu_torch.cli import-checkpoint ref.pt
  python -m weatherforecast_stgcn_maml_tpu_torch.cli export-checkpoint --out ref.pt
  python -m weatherforecast_stgcn_maml_tpu_torch.cli data-report --region Moscow
  python -m weatherforecast_stgcn_maml_tpu_torch.cli info

(`python -m weatherforecast_stgcn_maml_tpu_torch ...` is the same CLI.)
`--device` defaults to `cuda`; without a card the command fails unless
`--device cpu` is given, which runs the plain PyTorch versions of the
kernels. `import-checkpoint`, `export-checkpoint` and `data-report` run on
the host only. Config overrides use the JAX package's dotted `-o key=value`
form.

`meta-train --mesh` trains on a mesh of ranks, one process per device:

  torchrun --nproc_per_node=4 -m weatherforecast_stgcn_maml_tpu_torch.cli \
      meta-train --mesh -o mesh.spatial_devices=2

(dp 2 x sp 2; spatial_devices 1, the default, splits only the tasks). A
single process with `--mesh` forms a mesh of one rank.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from weatherforecast_stgcn_maml_tpu_torch.config import (
    ADAPTATION_REGIONS,
    ExperimentConfig,
    apply_overrides,
    to_dict,
)


def _region_by_name(name: str):
    for box, rname in ADAPTATION_REGIONS:
        if rname == name:
            return box, rname
    names = "; ".join(n for _, n in ADAPTATION_REGIONS)
    raise SystemExit(f"unknown region {name!r}; known: {names}")


def _parse_region_list(spec: str):
    """Parse --regions. Six region names contain commas ('Lytton, Canada'),
    so ';' is the safe separator; comma-separated input is still accepted
    by greedily re-joining fragments until they match a known name."""
    if ";" in spec:
        return [_region_by_name(n.strip()) for n in spec.split(";") if n.strip()]
    known = {n for _, n in ADAPTATION_REGIONS}
    out, pending = [], ""
    for frag in spec.split(","):
        pending = f"{pending}, {frag.strip()}" if pending else frag.strip()
        if pending in known:
            out.append(_region_by_name(pending))
            pending = ""
    if pending:
        _region_by_name(pending)  # raises with the known-names list
    return out


def _resolve_region(args):
    if args.region:
        return _region_by_name(args.region)
    if args.box:
        box = tuple(float(v) for v in args.box)
        return box, (args.name or f"box{box}")
    raise SystemExit("pass --region NAME or --box LAT_MIN LAT_MAX LON_MIN LON_MAX")


def _resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass --device cpu to run the plain "
            "PyTorch route on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {name!r}")
    return device


def _json_safe(obj):
    """Replace non-finite floats by strings (json.dumps would emit invalid
    `Infinity`)."""
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    return obj


def _log_stderr(*args):
    """Engine progress goes to stderr so stdout stays machine-readable."""
    print(*args, file=sys.stderr)


def _add_region_args(p):
    p.add_argument("--region", help="named region (see `info`)")
    p.add_argument(
        "--box", nargs=4, metavar=("LAT_MIN", "LAT_MAX", "LON_MIN", "LON_MAX")
    )
    p.add_argument("--name", help="region name when using --box")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def _add_common(p):
    p.add_argument(
        "-o", "--override", action="append", default=[], metavar="KEY=VALUE",
        help="config override, e.g. -o model.compute_dtype=bfloat16 -o out_dir=out2",
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="wfstgcn-torch",
        description="MAML-STGCN-LSTM weather forecasting, PyTorch/CUDA port",
    )
    sub = p.add_subparsers(dest="command", required=True)

    mt = sub.add_parser("meta-train", help="MAML meta-training over global regions")
    mt.add_argument("--resume", action="store_true", help="resume from ckpt_last")
    mt.add_argument("--device", default="cuda",
                    help="cuda (default; with --mesh cuda:LOCAL_RANK), cuda:N, or cpu")
    mt.add_argument(
        "--mesh", action="store_true",
        help="train on every rank of the process group (torchrun, or the JAX "
        "package's COORDINATOR_ADDRESS/NUM_PROCESSES/PROCESS_ID): the meta batch "
        "over the ranks, with -o mesh.spatial_devices=S also the node axis",
    )
    _add_common(mt)

    ad = sub.add_parser("adapt", help="fine-tune the meta-trained model to one region")
    _add_region_args(ad)
    ad.add_argument("--meta-ckpt", help="the meta checkpoint (default <out_dir>/meta/ckpt_best)")
    _add_common(ad)

    va = sub.add_parser("validate", help="validate an adapted (or base) model")
    _add_region_args(va)
    va.add_argument("--no-plots", action="store_true")
    _add_common(va)

    fc = sub.add_parser("forecast", help="emit denormalized forecasts for a region")
    _add_region_args(fc)
    fc.add_argument("--plots", action="store_true")
    _add_common(fc)

    pl = sub.add_parser("pipeline", help="adapt and validate every region (or --regions)")
    pl.add_argument(
        "--regions",
        help="subset of region names, ';'-separated (names may contain commas)",
    )
    pl.add_argument("--shard", type=int, default=None, help="this host's shard id")
    pl.add_argument("--num-shards", type=int, default=None)
    pl.add_argument("--no-plots", action="store_true")
    pl.add_argument(
        "--mesh-fleet", action="store_true",
        help="adapt pending regions in one fleet pass (regions side by side, "
        "grouped by climate zone; engines/fleet_adapt.py)",
    )
    pl.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    _add_common(pl)

    imp = sub.add_parser(
        "import-checkpoint",
        help="convert a reference PyTorch .pt checkpoint into this framework",
    )
    imp.add_argument("path", help="reference .pt checkpoint")
    imp.add_argument(
        "--allow-unsafe-pickle", action="store_true",
        help="load with full pickle (executes arbitrary bytecode) - only "
        "for TRUSTED files that torch's safe weights_only load rejects",
    )
    imp.add_argument(
        "--out",
        help="output checkpoint dir (default: out/meta/ckpt_best, or the "
        "region's adapted-checkpoint path with --region/--box)",
    )
    imp.add_argument(
        "--region",
        help="import as an ADAPTED checkpoint for this named region "
        "(reference adaptation outputs carry region stats)",
    )
    imp.add_argument(
        "--box", nargs=4, metavar=("LAT_MIN", "LAT_MAX", "LON_MIN", "LON_MAX")
    )
    imp.add_argument("--name", help="region name when using --box")
    _add_common(imp)

    exp = sub.add_parser(
        "export-checkpoint",
        help="convert one of this framework's checkpoints to a reference "
        "PyTorch .pt (inverse of import-checkpoint)",
    )
    exp.add_argument(
        "path", nargs="?",
        help="framework checkpoint dir (default: out/meta/ckpt_best, or the "
        "region's adapted checkpoint with --region/--box)",
    )
    exp.add_argument("--out", required=True, help="output .pt path")
    exp.add_argument("--region", help="export this named region's adapted checkpoint")
    exp.add_argument(
        "--box", nargs=4, metavar=("LAT_MIN", "LAT_MAX", "LON_MIN", "LON_MAX")
    )
    exp.add_argument("--name", help="region name when using --box")
    _add_common(exp)

    dr = sub.add_parser(
        "data-report",
        help="NaN percentages, normalization stats, and graph info for a region",
    )
    dr.add_argument("--region", help="named region (see `info`)")
    dr.add_argument(
        "--box", nargs=4, metavar=("LAT_MIN", "LAT_MAX", "LON_MIN", "LON_MAX")
    )
    dr.add_argument("--name")
    dr.add_argument("--years", default="train", choices=["train", "adapt", "validate"])
    _add_common(dr)

    info = sub.add_parser("info", help="print config, regions, and CUDA devices")
    _add_common(info)
    return p


def _import_checkpoint(args, cfg) -> int:
    from weatherforecast_stgcn_maml_tpu_torch.utils.checkpoint import save_checkpoint
    from weatherforecast_stgcn_maml_tpu_torch.utils.torch_import import (
        import_torch_checkpoint,
    )

    params, model_cfg, stats, meta = import_torch_checkpoint(
        args.path, allow_unsafe_pickle=args.allow_unsafe_pickle
    )
    common = {
        "model_version": str(meta.get("model_version", "imported")),
        "imported_from": args.path,
        "epoch": int(meta.get("epoch", -1)),
        "stats": stats.to_dict() if stats is not None else None,
        "config": {**to_dict(cfg), "model": to_dict(model_cfg)},
    }
    if args.region or args.box:
        from weatherforecast_stgcn_maml_tpu_torch.engines.adapt import adapted_ckpt_path

        box, name = _resolve_region(args)
        out = args.out or adapted_ckpt_path(cfg.out_dir, name, box)
        save_checkpoint(out, params, {
            "schema": "wfstgcn-adapted-v1", "region": list(box), "region_name": name,
            **common,
        })
    else:
        out = args.out or f"{cfg.out_dir}/meta/ckpt_best"
        save_checkpoint(out, params, {"schema": "wfstgcn-meta-v1", **common})
    print(f"imported {args.path} -> {out}")
    print(f"model config: {model_cfg}")
    return 0


def _export_checkpoint(args, cfg) -> int:
    from weatherforecast_stgcn_maml_tpu_torch.config import experiment_from_dict
    from weatherforecast_stgcn_maml_tpu_torch.data.preprocess import NormStats
    from weatherforecast_stgcn_maml_tpu_torch.utils.checkpoint import load_checkpoint
    from weatherforecast_stgcn_maml_tpu_torch.utils.torch_export import (
        export_torch_checkpoint,
    )

    box = name = None
    if args.region or args.box:
        from weatherforecast_stgcn_maml_tpu_torch.engines.adapt import adapted_ckpt_path

        box, name = _resolve_region(args)
        src = args.path or adapted_ckpt_path(cfg.out_dir, name, box)
    else:
        src = args.path or f"{cfg.out_dir}/meta/ckpt_best"
    params, meta = load_checkpoint(src)
    model_cfg = cfg.model
    if isinstance(meta.get("config"), dict) and "model" in meta["config"]:
        model_cfg = experiment_from_dict(meta["config"]).model
    if model_cfg.family != "hybrid":
        raise SystemExit(
            f"export-checkpoint: reference schema is hybrid-only, "
            f"checkpoint family is {model_cfg.family!r}"
        )
    stats = NormStats.from_dict(meta["stats"]) if meta.get("stats") else None
    extra = {
        k: meta[k]
        for k in ("epoch", "val_mse", "koppen_code")
        if k in meta and meta[k] is not None
    }
    export_torch_checkpoint(
        args.out, params, model_cfg, stats=stats,
        region=tuple(box) if box else meta.get("region"),
        region_name=name or meta.get("region_name"),
        extra_meta=extra,
    )
    print(f"exported {src} -> {args.out}")
    return 0


def _data_report(args, cfg) -> int:
    import numpy as np

    from weatherforecast_stgcn_maml_tpu_torch.config import WEATHER_VARS
    from weatherforecast_stgcn_maml_tpu_torch.data.koppen import class_name
    from weatherforecast_stgcn_maml_tpu_torch.data.preprocess import (
        compute_stats,
        fill_nans_with_mean,
        nan_percentages,
    )
    from weatherforecast_stgcn_maml_tpu_torch.engines.data_source import get_region_data
    from weatherforecast_stgcn_maml_tpu_torch.graph import build_region_graph

    box, name = _resolve_region(args)
    years = {
        "train": cfg.data.train_years,
        "adapt": cfg.data.adapt_years,
        "validate": (cfg.data.validate_year,),
    }[args.years]
    region = get_region_data(box, years, cfg.data, tag=args.years, name=name)
    pct = nan_percentages(region.weather)
    t, la, lo, _ = region.weather.shape
    # The pipeline's NaN policy: fill with the per-variable nanmean, then
    # the stats the model sees.
    filled = fill_nans_with_mean(region.weather.reshape(t, la * lo, -1).astype(np.float32))
    stats = compute_stats(filled)
    g = build_region_graph(region.lats, region.lons, k_neighbors=cfg.data.k_neighbors)
    print(f"region {name} {tuple(box)} \u2014 {args.years} years {years}")
    print(
        f"  {t} timesteps x {la}x{lo} grid = {g.num_nodes} nodes "
        f"(padded {g.padded_nodes}); koppen {region.koppen_code} "
        f"({class_name(region.koppen_code)})"
    )
    print(f"  {'var':>6} {'nan%':>6} {'mean':>12} {'std':>12}")
    for i, var in enumerate(WEATHER_VARS):
        flag = "!!" if pct[i] >= 0.15 else (" !" if pct[i] >= 0.05 else "  ")
        print(
            f"  {var:>6} {100 * pct[i]:5.1f}{flag} {stats.mean[i]:12.4g} "
            f"{stats.std[i]:12.4g}"
        )
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        cfg = apply_overrides(ExperimentConfig(), args.override)
    except (ValueError, AttributeError, TypeError) as e:
        raise SystemExit(f"bad -o override: {e}") from e

    if args.command == "info":
        print(json.dumps(to_dict(cfg), indent=2))
        devices = [
            torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())
        ]
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
        print("cuda devices:", devices if devices else "none")
        print("regions:", ", ".join(n for _, n in ADAPTATION_REGIONS))
        return 0

    if args.command == "meta-train":
        from weatherforecast_stgcn_maml_tpu_torch.engines.meta_train import (
            run_meta_training,
        )

        device = _resolve_device(args.device)
        if not args.mesh:
            res = run_meta_training(
                cfg, device=device, resume=args.resume, log_cb=_log_stderr
            )
            print(f"best_loss={res.best_loss:.6f} best={res.best_path}")
            return 0
        import torch.distributed as dist

        from weatherforecast_stgcn_maml_tpu_torch.parallel import distributed
        from weatherforecast_stgcn_maml_tpu_torch.parallel.mesh import make_mesh

        # cuda:LOCAL_RANK over NCCL, unless a card is named: --device cuda:0
        # puts every rank on card 0, over gloo (NCCL refuses that).
        created = distributed.ensure_process_group(distributed.default_backend(device))
        try:
            mesh = make_mesh(cfg.mesh, device if device.index is not None
                             else distributed.local_device(device.type))
            res = run_meta_training(cfg, mesh=mesh, resume=args.resume, log_cb=_log_stderr)
        finally:
            if created:
                dist.destroy_process_group()
        print(f"rank={mesh.rank} best_loss={res.best_loss:.6f} "
              f"final_loss={res.final_loss:.6f} best={res.best_path}")
        return 0

    if args.command == "pipeline":
        from weatherforecast_stgcn_maml_tpu_torch.engines.pipeline import run_pipeline
        from weatherforecast_stgcn_maml_tpu_torch.parallel.fleet import auto_shard

        regions = _parse_region_list(args.regions) if args.regions else None
        if args.shard is not None and args.num_shards is not None:
            shard, num = args.shard, args.num_shards
        elif args.shard is None and args.num_shards is None:
            shard, num = auto_shard()
        else:
            raise SystemExit(
                "pass BOTH --shard and --num-shards (explicit partitioning) or neither"
            )
        res = run_pipeline(
            cfg, regions, device=_resolve_device(args.device), shard_id=shard,
            num_shards=num, make_plots=not args.no_plots, mesh_fleet=args.mesh_fleet,
            log_cb=_log_stderr,
        )
        return 1 if res.errors else 0

    if args.command == "import-checkpoint":
        return _import_checkpoint(args, cfg)
    if args.command == "export-checkpoint":
        return _export_checkpoint(args, cfg)
    if args.command == "data-report":
        return _data_report(args, cfg)

    box, name = _resolve_region(args)
    device = _resolve_device(args.device)

    if args.command == "adapt":
        from weatherforecast_stgcn_maml_tpu_torch.engines.adapt import run_adaptation

        res = run_adaptation(
            cfg, box, name, device=device, meta_ckpt=args.meta_ckpt, log_cb=_log_stderr
        )
        print(f"val_mse={res.val_mse:.6f} ckpt={res.ckpt_path}")
        return 0

    if args.command == "validate":
        from weatherforecast_stgcn_maml_tpu_torch.engines.validate import run_validation

        res = run_validation(
            cfg, box, name, device=device, make_plots=not args.no_plots,
            log_cb=_log_stderr,
        )
        print(json.dumps(_json_safe(res.results), indent=2))
        return 0

    if args.command == "forecast":
        from weatherforecast_stgcn_maml_tpu_torch.engines.forecast import run_forecast

        res = run_forecast(
            cfg, box, name, device=device, make_plots=args.plots, log_cb=_log_stderr
        )
        print(f"forecast={res.artifact_path} ({res.model_kind} model)")
        return 0

    raise SystemExit(f"unhandled command {args.command}")


if __name__ == "__main__":
    sys.exit(main())
