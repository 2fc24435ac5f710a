"""Configuration tree of the PyTorch port.

Field names and defaults equal those of `weatherforecast_stgcn_maml_tpu.config`
for every section (model, meta, adapt, data, mesh, compat), so a config dict
written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Sequence

# The 12 ERA5 surface variables used as model inputs/outputs, in feature order.
WEATHER_VARS: tuple[str, ...] = (
    "u10", "v10", "t2m", "d2m", "sp", "tp",
    "u100", "v100", "str", "hcc", "lcc", "e",
)

# Cyclical time features appended to every node.
TIME_VARS: tuple[str, ...] = (
    "year_progress_sin", "year_progress_cos",
    "day_progress_sin", "day_progress_cos",
)

NUM_WEATHER_VARS = len(WEATHER_VARS)  # 12
NUM_TIME_VARS = len(TIME_VARS)  # 4
T2M_INDEX = WEATHER_VARS.index("t2m")  # 2

# The 15 meta-training region boxes (lat_min, lat_max, lon_min, lon_max).
META_TRAIN_REGIONS: tuple[tuple[float, float, float, float], ...] = (
    (18, 23, 75, 80),            # India
    (8, 13, 98, 103),            # Thailand
    (53, 58, 35, 40),            # Russia
    (12.5, 17.5, 102.5, 107.5),  # Thailand/Cambodia
    (22.5, 27.5, 19.5, 24.5),    # Libya/Egypt
    (43.5, 48.5, 7.5, 12.5),     # Southern France
    (35.5, 40.5, -5.5, -0.5),    # Spain/Mediterranean
    (32.5, 37.5, 137.5, 142.5),  # Tokyo/Eastern Japan
    (-23.5, -18.5, 132.5, 137.5),  # Australia
    (-20, -15, -70, -65),        # Peru
    (44.5, 49.5, 125.5, 130.5),  # Northeast China
    (29.5, 34.5, -101.5, -96.5),  # Texas
    (-9.5, -4.5, -67.5, -62.5),  # Amazon Basin
    (67.5, 72.5, -32.5, -27.5),  # Greenland
    (51.5, 56.5, -112.5, -107.5),  # Alberta, Canada
)

# The 18 adaptation/validation regions (box, name).
ADAPTATION_REGIONS: tuple[tuple[tuple[float, float, float, float], str], ...] = (
    ((40, 45, 285, 290), "NewYork"),
    ((-5, 0, 100, 105), "Indonesia"),
    ((53, 58, 35, 40), "Moscow"),
    ((8, 13, 98, 103), "Thailand"),
    ((-33, -28, 290, 295), "Argentina"),
    ((-17, -12, 145, 150), "QueensAustralia"),
    ((70, 75, 82, 87), "NorthSiberia"),
    ((35, 40, 69, 74), "Afghanistan"),
    ((15, 20, 30, 35), "Sudan"),
    ((18, 23, 75, 80), "India"),
    ((10, 15, 40, 45), "Ethiopia (Afar Region)"),
    ((0, 5, 5, 10), "Debundscha, Cameroon"),
    ((65, 70, 130, 135), "Verkhoyansk, Russia"),
    ((60, 65, 140, 145), "Oymyakon, Russia"),
    ((50, 55, 235, 240), "Lytton, Canada"),
    ((-5, 0, 295, 300), "Amazon Rainforest, Brazil"),
    ((15, 20, 355, 360), "Sahara Desert (Mali region)"),
    ((75, 80, 10, 15), "Svalbard, Norway"),
)


@dataclass(frozen=True)
class ModelConfig:
    """Architecture of the hybrid STGCN->LSTM forecaster (reference width:
    GCN 4x256, LSTM 4x128, window 24, horizon 8)."""

    # "hybrid" (STGCN->LSTM) or "stgcn" (encoder + last-slice head).
    family: str = "hybrid"
    num_weather_vars: int = NUM_WEATHER_VARS
    num_time_vars: int = NUM_TIME_VARS
    koppen_classes: int = 31  # 0 = padding
    koppen_dim: int = 8
    hidden_channels: int = 256  # GCN width
    gcn_layers: int = 4
    gcn_dropout: float = 0.2
    lstm_hidden: int = 128
    lstm_layers: int = 4
    lstm_dropout: float = 0.2
    window: int = 24
    horizon: int = 8
    # Training-only switches, kept so configs round-trip; serving ignores them.
    stop_base_gradients: bool = False
    train_koppen_embedding: bool = True
    # Matmul operand dtype ("float32" | "bfloat16" | "float64"); parameters
    # are stored float32 and products accumulate in float32 (float64 under
    # float64, which always takes the plain PyTorch route).
    compute_dtype: str = "float32"
    # True: the encoder runs as one fused GCN stack (ops/fused_gcn.py, the
    # hand-written CUDA kernel on a card). False: the plain layerwise route.
    use_pallas_gcn: bool = True
    # The eval LSTM stack as per-layer projections and recurrences
    # (ops/fused_lstm.py, kernel row 20 on a card; its backward
    # differentiates the plain route). The hybrid takes it in eval, and in
    # train mode when lstm_dropout == 0; otherwise lstm_kernel decides.
    use_pallas_lstm: bool = False
    # "auto" / "pallas_stack": the fused LSTM stack (ops/fused_lstm_stack.py,
    # the hand-written CUDA kernel on a card). "pallas": the layerwise route
    # with the per-layer recurrence kernel (ops/lstm_scan.py, rows 18-19).
    # "xla": the plain layerwise route.
    lstm_kernel: str = "auto"
    # Scan unroll factor of the JAX package; the port's loops do not unroll.
    lstm_unroll: int = 0
    # Wavefront LSTM schedule of the JAX package; not ported (raises).
    lstm_wavefront: bool = False
    # Append 2 within-box relative-coordinate channels to the node features.
    relative_coords: bool = False

    @property
    def coord_channels(self) -> int:
        return 2 if self.relative_coords else 0

    @property
    def in_channels(self) -> int:  # 12 + 4 + 8 (+2) = 24 (26)
        return (
            self.num_weather_vars + self.num_time_vars + self.koppen_dim
            + self.coord_channels
        )

    @property
    def feature_channels(self) -> int:
        """Channels of precomputed features [T, N, C]: weather + time
        (+ optional relative coords); the Koppen embedding is looked up
        inside the model."""
        return self.num_weather_vars + self.num_time_vars + self.coord_channels


@dataclass(frozen=True)
class MetaConfig:
    """MAML meta-training, first or second order (engines/meta_train.py)."""

    seed: int = 42
    num_epochs: int = 40
    meta_batch: int = 4  # tasks per meta-epoch
    grad_accum: int = 2  # optimizer updates per meta-epoch (meta_batch / grad_accum tasks each)
    inner_epochs: int = 6
    inner_batches: int = 15  # support windows per inner epoch (batch 1 each)
    inner_lr: float = 0.01
    outer_lr: float = 1e-3
    weight_decay: float = 1e-4
    clip_norm: float = 1.0
    # Cosine annealing warm restarts, stepped per optimizer update
    # (grad_accum updates per epoch).
    cosine_t0: int = 10
    cosine_t_mult: int = 2
    eta_min: float = 1e-6
    # Exact (second-order) MAML: the meta-gradient through the inner SGD
    # steps, each step's Hessian-vector product by `so_impl`
    # (train/so_grad.py). False: first order.
    second_order: bool = False
    # The JAX package's rematerialisation policy of its inner scan under
    # second order ("step", "dots", "none", "sqrt", "chunk:<k>"). The port's
    # inner gradient keeps only each step's parameters and masks and
    # recomputes the rest in its backward under every policy; an unknown one
    # raises.
    so_remat: str = "step"
    # The Hessian transpose under second order: "fhvp" (the hybrid's LSTM
    # stack through the second-order kernels, rows 10-11), "hvp"
    # (forward-over-reverse), "rof" (reverse-over-forward) on the plain
    # route, or "xla" (double backward through the plain route everywhere).
    so_impl: str = "fhvp"
    # The JAX package's wavefront LSTM inside the hvp / rof Hessian
    # transposes; not ported (True with those raises, ignored with fhvp).
    so_wavefront: bool = False
    # True: the inner loop's clip + SGD is one kernel over the whole tree
    # (ops/fused_sgd.py, the hand-written CUDA kernel on a card). False:
    # per-leaf PyTorch operations.
    fused_inner_update: bool = True
    # XLA scan unroll factor of the JAX package; no meaning here (ignored).
    inner_unroll: int = 1
    # The query windows run in train mode (dropout on), as the reference.
    query_train_mode: bool = True
    query_batches: int = 1
    # Task construction.
    max_samples_per_task: int = 600
    support_fraction: float = 0.75
    # Per-task difficulty EMA of the task sampler.
    difficulty_ema: float = 0.9
    # The JAX package's PRNG implementation; dropout here draws from a
    # torch.Generator, so this is ignored.
    rng_impl: str = "rbg"
    # Write the resumable `ckpt_last` every N epochs (best/final always).
    checkpoint_every: int = 5
    # Meta epochs chained into one call (engines/meta_train.py): the sampler
    # sees a chunk's losses at its end, checkpoints are decided at chunk
    # ends; 1 is the reference's epoch-by-epoch cadence.
    epochs_per_dispatch: int = 1


@dataclass(frozen=True)
class AdaptConfig:
    """Regional adaptation (fine-tuning, engines/adapt.py)."""

    seed: int = 42
    epochs: int = 15
    base_lr: float = 6e-4
    clip_norm: float = 1.0
    max_samples: int = 1200
    train_fraction: float = 0.8
    # Windows per train step (the reference fine-tunes one at a time; 1
    # reproduces that). The batch folds into the encoder's time slices and
    # the LSTM's rows: B = 2 at 512 padded nodes makes 1024 LSTM rows.
    batch_size: int = 2
    shuffle: bool = True
    # The JAX package's PRNG implementation; dropout here draws from a
    # torch.Generator, so this is ignored.
    rng_impl: str = "rbg"
    # Move the [T, N, C] features to the device in chunks of this many
    # timesteps, overlapping by window + horizon (0 = all at once).
    max_device_timesteps: int = 0


@dataclass(frozen=True)
class DataConfig:
    """Data layout. Only the synthetic backend is ported: a non-empty `root`
    (ERA5 through xarray) raises NotImplementedError."""

    root: str = ""
    cache_dir: str = "out/cache"
    train_years: tuple[str, ...] = ("2020", "2021", "2022", "2023", "2024")
    adapt_years: tuple[str, ...] = ("2023", "2024")
    validate_year: str = "2025"
    quarters: tuple[str, ...] = ("Jan2Mar", "Apr2Jun", "Jul2Sept", "Oct2Dec")
    k_neighbors: int = 4
    koppen_map: str = ""
    validate_max_timesteps: int = 50
    validate_num_samples: int = 3
    synthetic_timesteps: int = 720
    # >= 0: all synthetic regions sample one shared global wave field with
    # this seed; -1: independent dynamics per (region, tag).
    synthetic_shared_seed: int = 0
    synthetic_train_time_spread_hours: int = 8766


@dataclass(frozen=True)
class MeshConfig:
    """The mesh of `meta-train --mesh` (parallel/mesh.py): ranks are OS
    processes, one per device, joined by torch.distributed.

    `num_devices` (0 = the world size) ranks form a dp x sp grid with
    `spatial_devices` ranks on the sp axis: spatial_devices = 1 gives a
    data-parallel mesh (tasks split over ranks), > 1 also splits the padded
    node axis of every task over the sp ranks (the node-sharded step,
    parallel/meta_sp.py). `sp_impl` picks the 2-D step: "auto" resolves to
    "shardmap" for the hybrid family (the kernels engaged per node shard)
    and to "gspmd" for the others (the JAX package's partitioner-driven
    step on the plain routes, parallel/meta_gspmd.py; every family).
    """

    data_axis: str = "dp"
    num_devices: int = 0  # 0 -> the world size
    spatial_axis: str = "sp"
    spatial_devices: int = 1  # > 1 -> 2-D dp x sp mesh
    sp_impl: str = "auto"


@dataclass(frozen=True)
class CompatConfig:
    """Flags reproducing documented reference quirks."""

    # Validation averages predictions and targets over the sampled windows
    # before scoring (the reference protocol).
    average_validation_targets: bool = True
    # Adaptation/validation pass Koppen code 0 instead of the region's class.
    koppen_zero_in_adapt: bool = False


@dataclass(frozen=True)
class ExperimentConfig:
    """Top-level config bundle."""

    model: ModelConfig = field(default_factory=ModelConfig)
    meta: MetaConfig = field(default_factory=MetaConfig)
    adapt: AdaptConfig = field(default_factory=AdaptConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    compat: CompatConfig = field(default_factory=CompatConfig)
    out_dir: str = "out"


def to_dict(cfg: Any) -> Any:
    """Recursively convert a config dataclass to plain dicts (for ckpts)."""
    if dataclasses.is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg


_CONFIG_TYPES = {
    "model": ModelConfig,
    "meta": MetaConfig,
    "adapt": AdaptConfig,
    "data": DataConfig,
    "mesh": MeshConfig,
    "compat": CompatConfig,
}


def _from_dict(cls: type, data: dict) -> Any:
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        sub = _CONFIG_TYPES.get(f.name)
        if sub is not None and isinstance(v, dict):
            v = _from_dict(sub, v)
        elif isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        kwargs[f.name] = v
    return cls(**kwargs)


def experiment_from_dict(data: dict) -> ExperimentConfig:
    return _from_dict(ExperimentConfig, data)


def apply_overrides(cfg: Any, overrides: Sequence[str]) -> Any:
    """Apply 'dotted.path=value' CLI overrides to a config tree."""
    for item in overrides:
        path, _, raw = item.partition("=")
        if not _:
            raise ValueError(f"override {item!r} must be key=value")
        cfg = _replace_path(cfg, path.split("."), raw)
    return cfg


def _coerce(raw: str, current: Any) -> Any:
    if isinstance(current, bool):
        low = raw.lower()
        if low in ("1", "true", "yes", "on"):
            return True
        if low in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"boolean override expects true/false, got {raw!r}")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, tuple):
        parts = [p for p in raw.split(",") if p != ""]
        elem = current[0] if current else ""
        return tuple(_coerce(p, elem) for p in parts)
    return raw


def _replace_path(cfg: Any, keys: Sequence[str], raw: str) -> Any:
    if len(keys) == 1:
        current = getattr(cfg, keys[0])
        if dataclasses.is_dataclass(current):
            raise ValueError(
                f"{keys[0]!r} is a config section, not a settable leaf — "
                f"override one of its fields (e.g. {keys[0]}.<field>=...)"
            )
        return dataclasses.replace(cfg, **{keys[0]: _coerce(raw, current)})
    child = getattr(cfg, keys[0])
    return dataclasses.replace(cfg, **{keys[0]: _replace_path(child, keys[1:], raw)})
