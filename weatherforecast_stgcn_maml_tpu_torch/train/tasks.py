"""Task construction: RegionData -> a MAML task on the device.

Counterpart of `weatherforecast_stgcn_maml_tpu/train/tasks.py`: build the
graph (nodes padded to one count shared by every task), preprocess features,
window, and split support/query contiguously. Only the support windows the
inner loop touches are gathered (`meta.inner_batches`, cycled over short
regions), and `meta.query_batches` query windows (at least 1), on the host:
by the native host pipeline's gather where it is on (`native`, as the JAX
package's `_materialize`), else by `gather_batch`. The Koppen code rides
along as an integer; the model looks its embedding up.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from weatherforecast_stgcn_maml_tpu_torch import native
from weatherforecast_stgcn_maml_tpu_torch.config import (
    NUM_WEATHER_VARS,
    DataConfig,
    MetaConfig,
    ModelConfig,
)
from weatherforecast_stgcn_maml_tpu_torch.data.preprocess import (
    NormStats,
    pad_nodes,
    prepare_features,
)
from weatherforecast_stgcn_maml_tpu_torch.data.region import RegionData
from weatherforecast_stgcn_maml_tpu_torch.data.windows import (
    WindowSpec,
    contiguous_split,
    gather_batch,
)
from weatherforecast_stgcn_maml_tpu_torch.graph import (
    RegionGraph,
    build_region_graph,
    round_up,
)


class Task(NamedTuple):
    """One meta-learning task (a climate region). Stacked tasks carry a
    leading task axis on every field."""

    support_x: torch.Tensor  # [S, W, N, C]
    support_y: torch.Tensor  # [S, H, N, 12]
    query_x: torch.Tensor  # [Q, W, N, C]
    query_y: torch.Tensor  # [Q, H, N, 12]
    koppen: torch.Tensor  # [] int64 climate class code
    a_hat: torch.Tensor  # [N, N]
    node_mask: torch.Tensor  # [N]


@dataclass
class BuiltTask:
    task: Task  # on the CPU
    stats: NormStats
    graph: RegionGraph
    region_name: str


def _materialize(features: np.ndarray, anchors: np.ndarray,
                 spec: WindowSpec) -> tuple[torch.Tensor, torch.Tensor]:
    """The windows at `anchors` of host features [T, N, C]: (x [S, W, N, C],
    y [S, H, N, 12]) CPU tensors, gathered by the native library where it is
    on (one copy a window), else by `gather_batch`."""
    out = native.gather_windows_native(features, anchors, spec.window, spec.horizon,
                                       y_channels=NUM_WEATHER_VARS)
    if out is not None:
        return torch.from_numpy(out[0]), torch.from_numpy(out[1])
    return gather_batch(torch.from_numpy(features), torch.from_numpy(anchors), spec)


def build_task(
    region: RegionData,
    model_cfg: ModelConfig,
    meta_cfg: MetaConfig,
    data_cfg: DataConfig,
    *,
    pad_to: int | None = None,
    stats: NormStats | None = None,
) -> BuiltTask:
    graph = build_region_graph(
        region.lats, region.lons, k_neighbors=data_cfg.k_neighbors, pad_to=pad_to
    )
    features, stats = prepare_features(
        region, stats=stats, rel_coords=model_cfg.relative_coords
    )
    features = pad_nodes(features, graph.padded_nodes)

    spec = WindowSpec(model_cfg.window, model_cfg.horizon)
    n_samples = spec.num_samples(region.num_timesteps)
    if n_samples < 2:
        raise ValueError(
            f"region {region.name!r}: {region.num_timesteps} timesteps give "
            f"{n_samples} windows; need >= 2"
        )
    support_idx, query_idx = contiguous_split(
        n_samples, meta_cfg.support_fraction, meta_cfg.max_samples_per_task
    )
    if len(query_idx) == 0:  # degenerate tiny regions: reuse the tail
        query_idx = support_idx[-1:]
        support_idx = support_idx[:-1]
    if len(support_idx) == 0 or len(query_idx) == 0:
        raise ValueError(
            f"region {region.name!r}: cannot form non-empty support and "
            f"query sets from {n_samples} windows"
        )
    # Sample i's anchor is window + i; counts cycle (np.resize wraps) so
    # every task holds exactly inner_batches support and query_batches
    # query windows.
    support_used = np.resize(support_idx, meta_cfg.inner_batches)
    query_used = np.resize(query_idx, max(1, meta_cfg.query_batches))
    sx, sy = _materialize(features, spec.window + support_used, spec)
    qx, qy = _materialize(features, spec.window + query_used, spec)
    task = Task(
        support_x=sx,
        support_y=sy,
        query_x=qx,
        query_y=qy,
        koppen=torch.tensor(max(region.koppen_code, 0), dtype=torch.int64),
        a_hat=torch.from_numpy(graph.a_hat),
        node_mask=torch.from_numpy(graph.node_mask),
    )
    return BuiltTask(task=task, stats=stats, graph=graph, region_name=region.name)


def common_padded_nodes(regions: list[RegionData]) -> int:
    """The node count every task is padded to: the largest region's,
    rounded up to a multiple of 128."""
    return round_up(max(r.num_nodes for r in regions))


def build_meta_tasks(
    regions: list[RegionData],
    model_cfg: ModelConfig,
    meta_cfg: MetaConfig,
    data_cfg: DataConfig,
) -> list[BuiltTask]:
    pad = common_padded_nodes(regions)
    return [
        build_task(r, model_cfg, meta_cfg, data_cfg, pad_to=pad) for r in regions
    ]


def stack_tasks(tasks: list[Task]) -> Task:
    """Stack tasks into one Task with a leading task axis."""
    return Task(*(torch.stack(fields) for fields in zip(*tasks)))


def stage_tasks(tasks: list[Task], device: torch.device | str) -> Task:
    """The whole task pool, stacked, on `device` once; epochs cut their
    batches from it with `select_tasks` without going back to the host."""
    return Task(*(f.to(device) for f in stack_tasks(tasks)))


def select_tasks(staged: Task, indices) -> Task:
    """The tasks at `indices` of a staged pool, gathered on its device."""
    idx = torch.as_tensor(np.asarray(indices), dtype=torch.int64).to(staged.a_hat.device)
    return Task(*(f.index_select(0, idx) for f in staged))


def task_at(tasks: Task, i: int) -> Task:
    """Task i of a stacked Task."""
    return Task(*(f[i] for f in tasks))
