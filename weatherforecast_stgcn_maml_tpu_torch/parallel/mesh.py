"""Rank meshes, task placement and the collectives of the parallel paths.

Counterpart of `weatherforecast_stgcn_maml_tpu/parallel/mesh.py`. A JAX
mesh is an array of devices inside one program; here a mesh is a grid of
ranks (OS processes, one device each) of the torch.distributed process
group, laid out row-major: rank r holds dp index r // sp and sp index
r % sp, so each sp group's ranks are adjacent (the per-GCN-layer gathers
stay between neighbouring devices) and the once-per-update meta-gradient
reduction crosses the longer stride. Each rank keeps the groups it belongs
to: its sp group (the ranks sharing its tasks), its dp group (the ranks
holding the same node rows of other tasks) and the whole mesh.

Task placement (`shard_task_batch`, `shard_task_batch_2d`) cuts a stacked
Task down to this rank's tasks and node rows, the counterpart of
`train/maml.py:task_partition_specs`: tasks over dp; over sp the node axis
of support/query windows ([..., W, NL, C]), the adjacency's rows ([NL, N])
and the node mask ([NL]).

The collectives with a gradient (`torch.autograd.Function`s, each with a
backward and a jvp that call the collectives again, so that the
second-order meta-gradient can differentiate through them twice):
`all_gather_nodes` and its transpose, a reduce-scatter (along dim 0;
exact cotangents and tangents both ways), `all_reduce_sum` (a sum whose
cotangent every rank holds whole: backward the identity, so each rank's
backward starts from its own share) and `all_reduce_tensors` (a sum whose
cotangent each rank holds in part: backward a sum too). `all_gather_rows`
takes no gradient.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from weatherforecast_stgcn_maml_tpu_torch.config import MeshConfig


@dataclass(frozen=True)
class Mesh:
    """This rank's view of a dp x sp mesh of ranks."""

    axis_names: tuple[str, ...]  # ("dp",) for a 1-D mesh, ("dp", "sp") for 2-D
    dp: int
    sp: int
    rank: int
    device: torch.device
    group: object  # every rank of the mesh
    dp_group: object  # the ranks with this rank's sp index
    sp_group: object  # the ranks with this rank's dp index

    @property
    def size(self) -> int:
        return self.dp * self.sp

    @property
    def dp_index(self) -> int:
        return self.rank // self.sp

    @property
    def sp_index(self) -> int:
        return self.rank % self.sp


def make_mesh_2d(
    dp: int, sp: int, device: torch.device | None = None,
    dp_axis: str = "dp", sp_axis: str = "sp", *, axis_names=None,
) -> Mesh:
    """2-D mesh of every rank of the process group: dp x sp, row-major.

    Every rank must call it (it creates the dp and sp subgroups, a
    collective). The mesh takes the whole world: dp * sp must equal the
    world size (a larger mesh raises as the JAX package does; a smaller one
    would leave ranks with nothing to run, and raises too)."""
    from weatherforecast_stgcn_maml_tpu_torch.parallel.distributed import local_device

    world = dist.get_world_size()
    if dp * sp > world:
        raise ValueError(f"requested {dp}x{sp} devices, have {world}")
    if dp * sp < world:
        raise ValueError(
            f"a {dp}x{sp} mesh leaves {world - dp * sp} of the {world} ranks idle; "
            f"launch {dp * sp} processes"
        )
    device = local_device() if device is None else torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    rank = dist.get_rank()
    # new_group is collective: every rank creates every group, in one order.
    sp_groups = [dist.new_group(list(range(d * sp, (d + 1) * sp))) for d in range(dp)]
    dp_groups = [dist.new_group(list(range(s, dp * sp, sp))) for s in range(sp)]
    return Mesh(
        axis_names=axis_names or (dp_axis, sp_axis), dp=dp, sp=sp, rank=rank,
        device=device, group=dist.group.WORLD,
        dp_group=dp_groups[rank % sp], sp_group=sp_groups[rank // sp],
    )


def make_mesh(cfg: MeshConfig = MeshConfig(), device: torch.device | None = None) -> Mesh:
    """The mesh of `cfg` over the process group: 1-D dp (spatial_devices
    = 1) or 2-D dp x sp (see make_mesh_2d). num_devices 0 = the world."""
    world = dist.get_world_size()
    n = cfg.num_devices or world
    if n > world:
        raise ValueError(f"requested {n} devices, have {world}")
    sp = max(1, cfg.spatial_devices)
    if n % sp:
        raise ValueError(
            f"num_devices ({n}) must be divisible by spatial_devices ({sp}) for a "
            "dp x sp mesh"
        )
    axis_names = (cfg.data_axis, cfg.spatial_axis) if sp > 1 else (cfg.data_axis,)
    return make_mesh_2d(n // sp, sp, device, axis_names=axis_names)


def resolve_sp_impl(sp_impl: str, model_cfg) -> str:
    """MeshConfig.sp_impl "auto" -> "shardmap" for the hybrid family (the
    node-sharded step with the kernels engaged per shard), "gspmd" for the
    others; an explicit choice passes through."""
    if sp_impl != "auto":
        return sp_impl
    return "shardmap" if getattr(model_cfg, "family", "hybrid") == "hybrid" else "gspmd"


def node_rows(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the node axis `dim` of t (rows sp_index * NL ...)."""
    n = t.shape[dim]
    if n % mesh.sp:
        raise ValueError(
            f"{n} padded nodes do not split over {mesh.sp} sp ranks; pad the node "
            "count to a multiple of the sp size"
        )
    nl = n // mesh.sp
    return t.narrow(dim, mesh.sp_index * nl, nl)


def shard_generator(key, sp_index: int, device) -> torch.Generator | None:
    """The dropout generator of sp rank `sp_index` for `key` (a tuple of
    ints), or None (no dropout) without a key."""
    if key is None:
        return None
    state = np.random.SeedSequence([*key, sp_index]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(state[0]) << 32 | int(state[1]))


def shard_task_batch(tasks, mesh: Mesh):
    """This rank's tasks of a stacked Task: the dp index's contiguous block."""
    from weatherforecast_stgcn_maml_tpu_torch.train.tasks import Task

    count = tasks.support_x.shape[0]
    if count % mesh.dp:
        raise ValueError(f"{count} tasks do not split evenly over {mesh.dp} dp ranks")
    local = count // mesh.dp
    return Task(*(f.narrow(0, mesh.dp_index * local, local) for f in tasks))


def shard_task_batch_2d(tasks, mesh: Mesh):
    """shard_task_batch, then this rank's node rows of every field."""
    from weatherforecast_stgcn_maml_tpu_torch.train.tasks import Task

    t = shard_task_batch(tasks, mesh)
    return Task(
        support_x=node_rows(t.support_x, -2, mesh),
        support_y=node_rows(t.support_y, -2, mesh),
        query_x=node_rows(t.query_x, -2, mesh),
        query_y=node_rows(t.query_y, -2, mesh),
        koppen=t.koppen,
        a_hat=node_rows(t.a_hat, -2, mesh),
        node_mask=node_rows(t.node_mask, -1, mesh),
    )


class _GatherNodes(torch.autograd.Function):
    # The setup_context form: the torch.func transforms unwrap the operands
    # before forward and jvp run, so the collective sees plain tensors. The
    # backward and the jvp call the collective Functions again, never the
    # raw collectives, so that their results stay differentiable (double
    # backward, jvp of a backward).
    @staticmethod
    def forward(x, group):
        size = dist.get_world_size(group)
        x = x.contiguous()
        out = x.new_empty((size * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatterNodes.apply(g, ctx.group), None

    @staticmethod
    def jvp(ctx, t, _):
        return _GatherNodes.apply(t, ctx.group)


class _ReduceScatterNodes(torch.autograd.Function):
    @staticmethod
    def forward(g, group):
        size = dist.get_world_size(group)
        g = g.contiguous()
        out = g.new_empty((g.shape[0] // size, *g.shape[1:]))
        dist.reduce_scatter_tensor(out, g, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _GatherNodes.apply(g, ctx.group), None

    @staticmethod
    def jvp(ctx, t, _):
        return _ReduceScatterNodes.apply(t, ctx.group)


def all_gather_nodes(x: torch.Tensor, group) -> torch.Tensor:
    """[NL, ...] node rows of every rank of `group`, stacked along dim 0 in
    rank order: [size * NL, ...]. Its backward is a reduce-scatter Function
    (the psum-scatter JAX's all_gather transposes to: each rank's partial
    cotangent of the gathered tensor, summed over the group, back to the
    rank that sent the rows; its own backward gathers); its jvp gathers the
    tangent. Every cotangent
    and tangent here is exact for the tensor it belongs to, so the pair is
    differentiable to any order (the second-order inner gradient's double
    backward and Hessian-vector products cross it)."""
    return _GatherNodes.apply(x, group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return g, None

    @staticmethod
    def jvp(ctx, t, _):
        return _AllReduceSum.apply(t, ctx.group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over `group`, for a sum whose cotangent every rank holds
    whole (a replicated loss: each rank's backward starts from 1). Its
    backward is the identity: each rank's gradient flows only into its own
    summand (psum's transpose into device-varying summands). Its jvp sums
    the tangent over the group."""
    return _AllReduceSum.apply(x, group)


class _SumPartials(_AllReduceSum):
    @staticmethod
    def backward(ctx, g):
        return _SumPartials.apply(g, ctx.group), None

    @staticmethod
    def jvp(ctx, t, _):
        return _SumPartials.apply(t, ctx.group)


def all_reduce_tensors(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """The elementwise sum over `group` of each tensor, in one collective
    (flattened into one buffer); returns views of that buffer. For a sum
    whose cotangent each rank holds only in part: a replicated value that
    feeds each rank's own computation (the inner gradient, summed over sp,
    then clipped and stepped into parameters that every rank differentiates
    on its own rows). Its backward sums the cotangents over the group too,
    so each summand gets the whole cotangent (JAX's psum followed by pcast
    to varying, whose transpose is a psum); its jvp sums the tangents. With
    `all_reduce_sum`'s identity backward a cotangent held in part would
    reach each summand unsummed: off by the other ranks' parts. On tensors
    that carry no graph (the first-order inner gradient, the meta-gradient)
    it records none."""
    flat = _SumPartials.apply(torch.cat([t.reshape(-1) for t in tensors]), group)
    return [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


@torch.no_grad()
def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """[n, ...] of every rank of `group`, stacked in rank order (no grad)."""
    size = dist.get_world_size(group)
    out = x.new_empty((size * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out
