"""Second-order MAML and the task-batched (`_VBATCH`) meta step on the
port's meshes against the JAX package, on the CPU.

Across OS processes joined by gloo (this file's `__main__` block is the
rank; each world size starts once and runs all of its cases in that
process, which writes its results for the tests to read; the JAX references
run here meanwhile). Inputs: four 10 x 10-node regions padded to 128 nodes
(real nodes on both sp shards), built on the JAX package's numpy host
route, and JAX's float64 initial parameters; dropout 0 wherever JAX is the
reference. JAX's second-order steps run `so_impl="hvp"` (every so_impl
computes the same exact meta-gradient; "hvp" compiles fastest on the CPU).

  * 2 ranks, dp 2: second-order meta steps (so_impl "xla" and "fhvp", the
    fused composition on its plain pieces) against JAX's
    `make_parallel_meta_step` with `second_order=True` (rtol 1e-8), "hvp"
    and "rof" against the port's "xla" mesh step (1e-9); under `_VBATCH`
    the lockstep mesh step against the serial mesh step with dropout on at
    every site (two LSTM layers, query windows in train mode, seeded
    weights; 1e-10: the same key, so the same masks) and, at dropout 0 on
    the plain stack, against JAX's dp step (1e-8).
  * 4 ranks, dp 2 x sp 2: the same second-order cases against JAX's
    `make_shardmap_meta_step_2d` (JAX's own case: meta_batch 2, grad_accum
    1, inner_epochs 1, inner_batches 2), parameters bitwise equal on every
    rank; under `_VBATCH` the lockstep shardmap step against the serial one
    with dropout on (1e-10), and the shardmap step with both wavefront flags
    against the step without them (bitwise: it ignores them); then on sp 4
    the node-sharded encoder's torch.func.jvp and its double backward
    (create_graph=True) against the unsharded encoder (float64, 1e-10): a
    collective whose backward leaves no graph drops the second-order terms
    that cross the gathers.
"""

import copy
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from weatherforecast_stgcn_maml_tpu_torch import config as tcfg
from weatherforecast_stgcn_maml_tpu_torch.parallel import distributed
from weatherforecast_stgcn_maml_tpu_torch.train.tasks import Task

torch.set_num_threads(1)  # small tensors; more threads oversubscribe side-by-side workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(hidden_channels=8, gcn_layers=2, lstm_hidden=8, lstm_layers=1, window=6,
             horizon=2, koppen_dim=4, gcn_dropout=0.0, lstm_dropout=0.0,
             compute_dtype="float64", lstm_kernel="xla")
META = dict(meta_batch=4, grad_accum=2, inner_epochs=1, inner_batches=2,
            query_train_mode=False)
META_DP = dict(META, second_order=True)  # dp 2: two tasks an update, one a rank
META_GRID = dict(META, meta_batch=2, grad_accum=1, second_order=True)  # JAX's 2 x 2 case
META_VBATCH = dict(META, grad_accum=1)  # two tasks a rank: V = 2 in lockstep
# The port's route for each so_impl: "fhvp" takes its fused composition
# (rows 4-5 and 10-11 on their plain pieces here) only off lstm_kernel="xla".
ROUTES = {"xla": "xla", "fhvp": "auto", "hvp": "auto", "rof": "auto"}
WORLDS = {"dp": 2, "grid": 4}
# The GSPMD step's cases against JAX's `make_parallel_meta_step_2d`: (case,
# family, meta config); the hybrid runs it as under a forced
# `mesh.sp_impl=gspmd`. JAX's second-order step runs "hvp", the port's its
# default "fhvp" (on the GSPMD step's plain routes: the forward derivative
# of the plain gradient).
GSPMD_CASES = (("stgcn-fo", "stgcn", META), ("stgcn-so", "stgcn", META_GRID),
               ("hybrid-fo", "hybrid", META))
# Dropout on at every site of each family: (case, family, model flags, meta
# flags). The wavefront cases run `model.lstm_wavefront` in every forward
# and `meta.so_wavefront` in the hvp Hessian transposes: the GSPMD step runs
# them as the JAX package's does (its step is models/hybrid.py's).
DROPOUT_CASES = (("stgcn-fo", "stgcn", {}, {}),
                 ("stgcn-so", "stgcn", {}, dict(second_order=True)),
                 ("hybrid-fo", "hybrid", {}, {}),
                 ("hybrid-so", "hybrid", {}, dict(second_order=True)),
                 ("hybrid-wavefront", "hybrid", dict(lstm_wavefront=True), {}),
                 ("hybrid-so-wavefront", "hybrid", {},
                  dict(second_order=True, so_impl="hvp", so_wavefront=True)))
CHAIN = [[0, 1, 2, 3], [3, 1, 0, 2]]  # two epochs' task indices
TOL_JAX = dict(rtol=1e-8, atol=1e-11)
# Parameters after the AdamW updates: the two packages' float32
# learning-rate schedules differ in the last bit of cos (numpy vs XLA), one
# float32 ulp (2^-23 relative) of lr = 1e-3 an update, 1.2e-10 after two
# (as tests/test_torch_port_parallel.py measures); the rest at rtol 1e-8.
TOL_JAX_PARAMS = dict(rtol=1e-8, atol=3e-10)


# ---------------------------------------------------------------------------
# The rank worker (run as a script)
# ---------------------------------------------------------------------------


def _load_inputs(out_dir, count):
    from weatherforecast_stgcn_maml_tpu_torch.models.registry import init_model
    from weatherforecast_stgcn_maml_tpu_torch.train.maml import MamlState
    from weatherforecast_stgcn_maml_tpu_torch.train.optimizers import MetaOptimizer

    saved = torch.load(os.path.join(out_dir, "inputs.pt"))
    tasks = Task(**{k: v[:count] for k, v in saved["tasks"].items()})

    def state(mc):
        model = init_model(torch.Generator().manual_seed(0), mc).double()
        model.load_state_dict(saved["params" if mc.family == "hybrid" else "params_stgcn"])
        return MamlState(model, MetaOptimizer.init(dict(model.named_parameters())), 0)

    return tasks, state


def _params(state):
    return {k: v.detach().clone() for k, v in state.params.state_dict().items()}


def _so_steps(make_step, mesh, out_dir, meta_kw):
    """One float64 second-order meta step on `mesh` for every so_impl:
    {so_impl: (per-task losses, parameters)}."""
    tasks, state = _load_inputs(out_dir, meta_kw["meta_batch"])
    res = {}
    for impl, kernel in ROUTES.items():
        mc = tcfg.ModelConfig(**dict(MODEL, lstm_kernel=kernel))
        meta = tcfg.MetaConfig(**meta_kw, so_impl=impl)
        s, m = make_step(mc, meta, mesh)(state(mc), tasks, None)
        res[impl] = (m["per_task_loss"].numpy(), _params(s))
    return res


def _dp_rank(out_dir, rank):
    """dp 2: the second-order steps, then `_VBATCH` (lockstep vs serial with
    dropout on; at dropout 0 on the plain stack for JAX)."""
    from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm_stack
    from weatherforecast_stgcn_maml_tpu_torch.parallel import meta_dp
    from weatherforecast_stgcn_maml_tpu_torch.parallel.mesh import make_mesh
    from weatherforecast_stgcn_maml_tpu_torch.train.maml import MamlState, init_meta_state
    from weatherforecast_stgcn_maml_tpu_torch.train.optimizers import MetaOptimizer

    mesh = make_mesh(tcfg.MeshConfig(), torch.device("cpu"))
    res = {"so": _so_steps(meta_dp.make_parallel_meta_step, mesh, out_dir, META_DP)}

    calls = []
    sums = meta_dp.lockstep_grad_sums

    def counted(params, tasks, gens, *args):
        calls.append(tasks.support_x.shape[0])
        return sums(params, tasks, gens, *args)

    meta_dp.lockstep_grad_sums = counted
    tasks, state = _load_inputs(out_dir, 4)

    # Dropout on at every site (two LSTM layers, query windows in train
    # mode); weights from a seed.
    drop = tcfg.ModelConfig(**dict(MODEL, gcn_dropout=0.3, lstm_dropout=0.3, lstm_layers=2,
                                   lstm_kernel="auto"))
    drop_meta = tcfg.MetaConfig(**dict(META_VBATCH, query_train_mode=True))
    drop_state = init_meta_state(torch.Generator().manual_seed(0), drop, drop_meta)
    vb = {}
    for name, flag, mc, meta, key in (
            ("lockstep", True, drop, drop_meta, (3,)),
            ("serial", False, drop, drop_meta, (3,)),
            ("plain", True, tcfg.ModelConfig(**MODEL), tcfg.MetaConfig(**META_VBATCH), None)):
        fused_lstm_stack._VBATCH = flag
        try:
            start = state(mc) if key is None else MamlState(
                copy.deepcopy(drop_state.params).double(), None, 0)
            start = start._replace(opt_state=MetaOptimizer.init(
                dict(start.params.named_parameters())))
            s, m = meta_dp.make_parallel_meta_step(mc, meta, mesh)(start, tasks, key)
        finally:
            fused_lstm_stack._VBATCH = False
        vb[name] = (m["per_task_loss"].numpy(), _params(s), list(calls))
        calls.clear()
    res["vbatch"] = vb

    # Two chained epochs on the dp mesh, dropout 0 (JAX's chained dp step).
    from weatherforecast_stgcn_maml_tpu_torch.train.maml import make_chained_meta_step

    mc, meta = tcfg.ModelConfig(**MODEL), tcfg.MetaConfig(**META_VBATCH)
    step = meta_dp.make_parallel_meta_step(mc, meta, mesh)
    s, m = make_chained_meta_step(step, lambda e: (11, e))(state(mc), tasks, CHAIN, range(2))
    res["chained"] = (m["per_task_loss"].numpy(), _params(s))
    return res


def _shardmap_cases(out_dir, mesh):
    """dp 2 x sp 2, the shardmap step, dropout on at every site (two LSTM
    layers, query windows in train mode), seeded weights, one key: under
    `_VBATCH` (each rank's two tasks in lockstep, V = 2 at its 64 rows)
    against the serial step; with `model.lstm_wavefront` and
    `meta.so_wavefront` against the step without them (the shardmap step
    ignores both, as the JAX package's does)."""
    from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm_stack
    from weatherforecast_stgcn_maml_tpu_torch.parallel import meta_sp
    from weatherforecast_stgcn_maml_tpu_torch.train.maml import MamlState, init_meta_state

    calls = []
    sums = meta_sp.lockstep_grad_sums

    def counted(params, tasks, gens, *args):
        calls.append(tasks.support_x.shape[0])
        return sums(params, tasks, gens, *args)

    meta_sp.lockstep_grad_sums = counted
    tasks, _ = _load_inputs(out_dir, 4)
    drop = dict(MODEL, gcn_dropout=0.3, lstm_dropout=0.3, lstm_layers=2, lstm_kernel="auto")
    drop_meta = dict(META_VBATCH, query_train_mode=True)
    start = init_meta_state(torch.Generator().manual_seed(0), tcfg.ModelConfig(**drop),
                            tcfg.MetaConfig(**drop_meta))
    out = {}
    for name, flag, model_kw, meta_kw in (
            ("lockstep", True, {}, {}),
            ("serial", False, {}, {}),
            ("so", False, {}, dict(second_order=True, so_impl="hvp")),
            ("so_wavefront", False, dict(lstm_wavefront=True),
             dict(second_order=True, so_impl="hvp", so_wavefront=True))):
        fused_lstm_stack._VBATCH = flag
        try:
            st = MamlState(copy.deepcopy(start.params), start.opt_state, 0)
            s, m = meta_sp.make_shardmap_meta_step_2d(
                tcfg.ModelConfig(**drop, **model_kw), tcfg.MetaConfig(**drop_meta, **meta_kw),
                mesh)(st, tasks, (5,))
        finally:
            fused_lstm_stack._VBATCH = False
        out[name] = (m["per_task_loss"].numpy(), _params(s), list(calls))
        calls.clear()
    return {"shardmap": out}


def _grid_rank(out_dir, rank):
    """dp 2 x sp 2: the second-order steps; sp 4: the encoder's jvp and
    double backward against the unsharded encoder."""
    from weatherforecast_stgcn_maml_tpu_torch.models.stgcn import init_encoder
    from weatherforecast_stgcn_maml_tpu_torch.ops.fused_gcn import gcn_stack_plain
    from weatherforecast_stgcn_maml_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
    from weatherforecast_stgcn_maml_tpu_torch.parallel.meta_sp import (
        make_shardmap_meta_step_2d,
    )
    from weatherforecast_stgcn_maml_tpu_torch.parallel.spatial import _spatial_encoder

    mesh = make_mesh(tcfg.MeshConfig(spatial_devices=2), torch.device("cpu"))
    assert (mesh.dp, mesh.sp, mesh.dp_index, mesh.sp_index) == (2, 2, rank // 2, rank % 2)
    res = {"so": _so_steps(make_shardmap_meta_step_2d, mesh, out_dir, META_GRID)}
    res.update(_gspmd_cases(out_dir, mesh))
    res.update(_shardmap_cases(out_dir, mesh))

    sp4 = make_mesh_2d(1, 4, torch.device("cpu"))
    cfg = tcfg.ModelConfig(hidden_channels=8, gcn_layers=3, gcn_dropout=0.3,
                           compute_dtype="float64")
    n, w, keep = 128, 5, 0.7
    draw = np.random.default_rng(0)
    layers = init_encoder(torch.Generator().manual_seed(1), cfg).double().layers
    x, tx, vx = (torch.from_numpy(draw.normal(size=(w, n, cfg.in_channels))) for _ in range(3))
    a = torch.from_numpy(draw.uniform(size=(n, n)) / n)
    masks = torch.from_numpy((draw.uniform(size=(2, w, n, 8)) < keep).astype(np.int8))
    ct = torch.from_numpy(draw.normal(size=(w, n, 8)))
    params = [p.detach() for layer in layers for p in (layer.w, layer.b)]
    tparams = [torch.from_numpy(draw.normal(size=p.shape)) for p in params]
    vparams = [torch.from_numpy(draw.normal(size=p.shape)) for p in params]
    rows = slice(sp4.sp_index * n // 4, (sp4.sp_index + 1) * n // 4)

    def node_major(t):
        return t[..., rows, :].transpose(-3, -2).contiguous()

    def sharded(x, *ps):
        layer_ps = [SimpleNamespace(w=wt, b=b) for wt, b in zip(ps[::2], ps[1::2])]
        return _spatial_encoder(layer_ps, a[rows].contiguous(), x, cfg, sp4.sp_group,
                                node_major(masks))

    def unsharded(x, *ps):
        layer_ps = [SimpleNamespace(w=wt, b=b) for wt, b in zip(ps[::2], ps[1::2])]
        return gcn_stack_plain(layer_ps, a, x, torch.float64, masks, keep)

    # Forward mode: this rank's rows of the output and its tangent.
    got = torch.func.jvp(sharded, (node_major(x), *params), (node_major(tx), *tparams))
    ref = torch.func.jvp(unsharded, (x, *params), (tx, *tparams))
    res["jvp"] = max(float((g - node_major(r)).abs().max()) for g, r in zip(got, ref))

    # Double backward: phi = <d<h, ct>/dx, vx> + <d<h, ct>/dparams, vparams>
    # summed over the ranks (each rank's parameter gradient is its partial),
    # differentiated again; x's rows exact, the parameters' summed over sp.
    def second(fn, xs, ct_, vx_):
        leaves = [t.clone().requires_grad_(True) for t in xs]
        grads = torch.autograd.grad((fn(*leaves) * ct_).sum(), leaves, create_graph=True)
        phi = (grads[0] * vx_).sum() + sum((g * v).sum() for g, v in zip(grads[1:], vparams))
        return torch.autograd.grad(phi, leaves)

    got = second(sharded, [node_major(x), *params], node_major(ct), node_major(vx))
    got_p = [g.clone() for g in got[1:]]
    for g in got_p:
        dist.all_reduce(g, group=sp4.sp_group)
    ref = second(unsharded, [x, *params], ct, vx)
    res["double_backward"] = max(
        float((g - r).abs().max()) for g, r in zip([got[0], *got_p], [node_major(ref[0]),
                                                                        *ref[1:]]))
    res["double_backward_scale"] = max(float(r.abs().max()) for r in ref)
    return res


def _gspmd_cases(out_dir, mesh):
    """dp 2 x sp 2: the GSPMD step at dropout 0 (for JAX); with dropout on
    against the dp-mesh step (dp 4) on the same key; two chained epochs of
    each dp x sp step against two single steps; the engine on the dp x sp
    mesh (stgcn, `sp_impl=auto`, two epochs a chunk) and on dp 4."""
    from weatherforecast_stgcn_maml_tpu_torch.data.synthetic import synthetic_region_for_box
    from weatherforecast_stgcn_maml_tpu_torch.engines import meta_train
    from weatherforecast_stgcn_maml_tpu_torch.parallel.mesh import make_mesh_2d
    from weatherforecast_stgcn_maml_tpu_torch.parallel.meta_dp import make_parallel_meta_step
    from weatherforecast_stgcn_maml_tpu_torch.parallel.meta_gspmd import (
        make_parallel_meta_step_2d,
        pinned_configs,
    )
    from weatherforecast_stgcn_maml_tpu_torch.parallel.meta_sp import (
        make_shardmap_meta_step_2d,
    )
    from weatherforecast_stgcn_maml_tpu_torch.train.maml import (
        MamlState,
        init_meta_state,
        make_chained_meta_step,
    )
    from weatherforecast_stgcn_maml_tpu_torch.train.optimizers import MetaOptimizer

    from weatherforecast_stgcn_maml_tpu_torch.models import hybrid
    from weatherforecast_stgcn_maml_tpu_torch.parallel import spatial

    res = {"gspmd": {}, "gspmd_dropout": {}, "chained_2d": {}}
    # The wavefront's calls on each route: the node-local forward (the
    # GSPMD step) and the model (the dp step).
    wavefronts = {"gspmd": [], "dp": []}
    for module, name in ((spatial, "gspmd"), (hybrid, "dp")):
        module.lstm_wavefront = (lambda fn, calls: lambda *a, **k: calls.append(1) or fn(*a, **k))(
            module.lstm_wavefront, wavefronts[name])
    for case, family, meta_kw in GSPMD_CASES:
        tasks, state = _load_inputs(out_dir, meta_kw["meta_batch"])
        mc = tcfg.ModelConfig(**dict(MODEL, family=family))
        s, m = make_parallel_meta_step_2d(mc, tcfg.MetaConfig(**meta_kw), mesh)(
            state(mc), tasks, None)
        res["gspmd"][case] = (m["per_task_loss"].numpy(), _params(s))

    dp4 = make_mesh_2d(4, 1, torch.device("cpu"), axis_names=("dp",))
    tasks, _ = _load_inputs(out_dir, 4)
    for case, family, model_kw, meta_kw in DROPOUT_CASES:
        mc = tcfg.ModelConfig(**dict(MODEL, family=family, gcn_dropout=0.3, lstm_dropout=0.3,
                                     lstm_layers=2, **model_kw))
        meta = tcfg.MetaConfig(**dict(META, grad_accum=1, query_train_mode=True, **meta_kw))
        start = init_meta_state(torch.Generator().manual_seed(0), mc, meta)
        out = {}
        for name, make, mesh_ in (("gspmd", make_parallel_meta_step_2d, mesh),
                                  ("dp", make_parallel_meta_step, dp4)):
            calls = wavefronts[name]
            calls.clear()
            st = MamlState(copy.deepcopy(start.params), start.opt_state, 0)
            s, m = make(*pinned_configs(mc, meta), mesh_)(st, tasks, (5,))
            out[name] = (m["per_task_loss"].numpy(), _params(s), len(calls))
        res["gspmd_dropout"][case] = out

    # Two chained epochs against two single steps, dropout on (stgcn on the
    # GSPMD step, the hybrid on the shardmap step).
    for name, family, make in (("gspmd", "stgcn", make_parallel_meta_step_2d),
                               ("shardmap", "hybrid", make_shardmap_meta_step_2d)):
        mc = tcfg.ModelConfig(**dict(MODEL, family=family, gcn_dropout=0.3, lstm_dropout=0.3))
        meta = tcfg.MetaConfig(**META)
        step = make(mc, meta, mesh)
        start = init_meta_state(torch.Generator().manual_seed(0), mc, meta)
        runs = {}
        for how in ("chained", "single"):
            st = MamlState(copy.deepcopy(start.params), start.opt_state, 0)
            if how == "chained":
                st, m = make_chained_meta_step(step, lambda e: (9, e))(st, tasks, CHAIN,
                                                                      range(2))
                losses = m["per_task_loss"]
            else:
                losses = []
                for e, idx in enumerate(CHAIN):
                    st, m = step(st, Task(*(f[idx] for f in tasks)), (9, e))
                    losses.append(m["per_task_loss"])
                losses = torch.stack(losses)
            runs[how] = (losses, _params(st), st.step)
        res["chained_2d"][name] = runs

    # The engine, float64, dropout on: stgcn on dp 2 x sp 2 (`sp_impl`
    # auto, two epochs in one chunk) and on dp 4 (epoch by epoch).
    regions = [synthetic_region_for_box((10.0 + i, 12.25 + i, 20.0, 22.25), num_timesteps=32,
                                        seed=i) for i in range(4)]
    small = dict(family="stgcn", hidden_channels=8, gcn_layers=2, window=6, horizon=2,
                 koppen_dim=4, compute_dtype="float64")
    overrides = [f"model.{k}={v}" for k, v in small.items()] + [
        "meta.meta_batch=4", "meta.grad_accum=1", "meta.inner_epochs=1",
        "meta.inner_batches=2", "meta.num_epochs=2"]
    lines = []
    for name, mesh_, extra in (("grid", mesh, ["mesh.spatial_devices=2",
                                               "meta.epochs_per_dispatch=2"]),
                               ("dp4", dp4, [])):
        cfg = tcfg.apply_overrides(tcfg.ExperimentConfig(), overrides + extra + [
            f"out_dir={os.path.join(out_dir, 'engine', name)}"])
        meta_train.run_meta_training(cfg, regions, mesh=mesh_, log_cb=lines.append)
    engine = {"lines": lines}
    for name in ("grid", "dp4"):
        meta_dir = os.path.join(out_dir, "engine", name, "meta")
        with open(os.path.join(meta_dir, "meta_log.jsonl")) as f:
            engine[name] = {"log": [json.loads(line) for line in f],
                            "files": sorted(os.listdir(meta_dir))}
        for ckpt in ("ckpt_last", "ckpt_final"):
            engine[name][ckpt] = torch.load(os.path.join(meta_dir, ckpt, "params.pt"))
    res["engine"] = engine
    return res


def _worker(case, rank, world, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    try:
        res = {"grid": _grid_rank, "dp": _dp_rank}[case](out_dir, rank)
        torch.save(res, os.path.join(out_dir, f"{case}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# JAX references (this process)
# ---------------------------------------------------------------------------


def _jax_tasks_and_state(mc, meta):
    """The four tasks (on the port's host route: `tests/_host_route.py`) and the float64
    initial state, as JAX arrays (call under x64)."""
    import jax
    import jax.numpy as jnp

    from tests._host_route import restore_host_routes, use_same_host_route
    from weatherforecast_stgcn_maml_tpu.config import DataConfig
    from weatherforecast_stgcn_maml_tpu.data.synthetic import synthetic_region_for_box
    from weatherforecast_stgcn_maml_tpu.train.maml import MamlState, init_meta_state
    from weatherforecast_stgcn_maml_tpu.train.optimizers import meta_optimizer
    from weatherforecast_stgcn_maml_tpu.train.tasks import build_meta_tasks, stack_tasks

    regions = [synthetic_region_for_box((10.0 + i, 12.25 + i, 20.0, 22.25), num_timesteps=32,
                                        seed=i) for i in range(4)]
    use_same_host_route()
    try:
        built = build_meta_tasks(regions, mc, meta, DataConfig())
    finally:
        restore_host_routes()

    def f64(a):
        a = np.asarray(a)
        return jnp.asarray(a, jnp.float64) if a.dtype == np.float32 else jnp.asarray(a)

    tasks = jax.tree.map(f64, stack_tasks([b.task for b in built]))
    params = jax.tree.map(f64, init_meta_state(jax.random.key(0), mc, meta).params)
    tx, _ = meta_optimizer(meta)
    return tasks, MamlState(params, tx.init(params), jnp.zeros((), jnp.int32))


def _write_inputs(out_dir):
    import jax

    from weatherforecast_stgcn_maml_tpu import config as jcfg
    from weatherforecast_stgcn_maml_tpu_torch.utils.convert import state_dict_from_params

    with jax.enable_x64(True):
        tasks, state = _jax_tasks_and_state(jcfg.ModelConfig(**MODEL), jcfg.MetaConfig(**META))
        fields = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in tasks._asdict().items()}
        fields["koppen"] = fields["koppen"].long()
        params = state_dict_from_params(jax.tree.map(np.asarray, state.params), np.float64)
        stgcn = state_dict_from_params(
            jax.tree.map(np.asarray, _jax_stgcn_state(jcfg.MetaConfig(**META)).params),
            np.float64)
    assert int(fields["node_mask"][0].sum()) == 100 and fields["node_mask"].shape[1] == 128
    torch.save({"tasks": fields, "params": params, "params_stgcn": stgcn},
               os.path.join(out_dir, "inputs.pt"))


def _jax_stgcn_state(meta):
    """The stgcn family's float64 initial state (call under x64)."""
    import jax
    import jax.numpy as jnp

    from weatherforecast_stgcn_maml_tpu import config as jcfg
    from weatherforecast_stgcn_maml_tpu.train.maml import MamlState, init_meta_state
    from weatherforecast_stgcn_maml_tpu.train.optimizers import meta_optimizer

    mc = jcfg.ModelConfig(**dict(MODEL, family="stgcn"))
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                          init_meta_state(jax.random.key(0), mc, meta).params)
    tx, _ = meta_optimizer(meta)
    return MamlState(params, tx.init(params), jnp.zeros((), jnp.int32))


def _jax_references():
    """{case: (per-task losses, parameters)} of one float64 JAX meta step:
    "dp" second order on dp 2, "grid" second order on dp 2 x sp 2, "vbatch"
    first order on dp 2 (two tasks a device)."""
    import jax

    from weatherforecast_stgcn_maml_tpu import config as jcfg
    from weatherforecast_stgcn_maml_tpu.ops import fused_gcn_shard
    from weatherforecast_stgcn_maml_tpu.parallel import mesh as jmesh
    from weatherforecast_stgcn_maml_tpu.parallel.meta_dp import make_parallel_meta_step as jdp
    import jax.numpy as jnp

    from weatherforecast_stgcn_maml_tpu.parallel.meta_dp import make_parallel_meta_step_2d as jdp2d
    from weatherforecast_stgcn_maml_tpu.parallel.meta_sp import make_shardmap_meta_step_2d as jsp
    from weatherforecast_stgcn_maml_tpu.train.maml import make_jit_chained_meta_step
    from weatherforecast_stgcn_maml_tpu_torch.utils.convert import state_dict_from_params

    mc = jcfg.ModelConfig(**MODEL)
    refs = {}
    with jax.enable_x64(True), fused_gcn_shard.force_reference():
        tasks, state = _jax_tasks_and_state(mc, jcfg.MetaConfig(**META))
        dp = jmesh.make_mesh(jcfg.MeshConfig(num_devices=2))
        grid = jmesh.make_mesh_2d(2, 2)
        for case, meta_kw, make, mesh, place in (
                ("dp", META_DP, jdp, dp, jmesh.shard_task_batch),
                ("vbatch", META_VBATCH, jdp, dp, jmesh.shard_task_batch),
                ("grid", META_GRID, jsp, grid, jmesh.shard_task_batch_2d)):
            meta = jcfg.MetaConfig(**meta_kw, so_impl="hvp") if meta_kw.get(
                "second_order") else jcfg.MetaConfig(**meta_kw)
            batch = jax.tree.map(lambda f: f[:meta.meta_batch], tasks)
            s, m = make(mc, meta, mesh, donate_state=False)(
                state, place(batch, mesh), jax.random.key(7))
            refs[case] = (np.asarray(m["per_task_loss"]),
                          state_dict_from_params(jax.tree.map(np.asarray, s.params),
                                                 np.float64))
        # The GSPMD step (`make_parallel_meta_step_2d`) on the 2 x 2 mesh.
        for case, family, meta_kw in GSPMD_CASES:
            meta = jcfg.MetaConfig(**meta_kw, so_impl="hvp") if meta_kw.get(
                "second_order") else jcfg.MetaConfig(**meta_kw)
            start = state if family == "hybrid" else _jax_stgcn_state(meta)
            batch = jax.tree.map(lambda f: f[:meta.meta_batch], tasks)
            s, m = jdp2d(jcfg.ModelConfig(**dict(MODEL, family=family)), meta, grid,
                         donate_state=False)(start, jmesh.shard_task_batch_2d(batch, grid),
                                             jax.random.key(7))
            refs["gspmd-" + case] = (np.asarray(m["per_task_loss"]),
                                     state_dict_from_params(jax.tree.map(np.asarray, s.params),
                                                            np.float64))
        # Two chained epochs on dp 2 (the chained step donates its state).
        meta = jcfg.MetaConfig(**META_VBATCH, epochs_per_dispatch=2)
        s, m = make_jit_chained_meta_step(mc, meta, mesh=dp)(
            jax.tree.map(jnp.copy, state), tasks, np.asarray(CHAIN, np.int32),
            jax.random.key(11), np.arange(2, dtype=np.int32))
        refs["chained"] = (np.asarray(m["per_task_loss"]),
                           state_dict_from_params(jax.tree.map(np.asarray, s.params),
                                                  np.float64))
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Launch the 2-rank and 4-rank workers, compute the JAX references
    while they run, and return (results per case and rank, references)."""
    out_dir = str(tmp_path_factory.mktemp("mesh_so"))
    _write_inputs(out_dir)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = []
    for case, world in WORLDS.items():
        port = distributed.free_port()
        procs += [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), case, str(r), str(world), str(port),
             out_dir], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
    refs = _jax_references()
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-4000:]
    results = {
        case: [torch.load(os.path.join(out_dir, f"{case}_rank{r}.pt"), weights_only=False)
               for r in range(world)]
        for case, world in WORLDS.items()
    }
    return results, refs


def _assert_params(got, ref, **tol):
    for name, p in got.items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), err_msg=name, **tol)


@pytest.mark.parametrize("case", ["dp", "grid"])
@pytest.mark.parametrize("impl", ["xla", "fhvp"])
def test_so_mesh_step_matches_jax_float64(ranks, case, impl):
    """Second order on dp 2 and on dp 2 x sp 2 (real nodes on both sp
    shards) against JAX's second-order mesh steps: per-task losses and
    parameters after the AdamW updates, rtol 1e-8; every rank's parameters
    bitwise equal."""
    results, refs = ranks
    ref_losses, ref_params = refs[case]
    first = results[case][0]["so"][impl]
    for res in results[case]:
        losses, params = res["so"][impl]
        np.testing.assert_allclose(losses, ref_losses, **TOL_JAX)
        for name, p in params.items():
            torch.testing.assert_close(p, first[1][name], rtol=0, atol=0)
    _assert_params(first[1], ref_params, **TOL_JAX_PARAMS)


@pytest.mark.parametrize("case", ["dp", "grid"])
@pytest.mark.parametrize("impl", ["hvp", "rof"])
def test_so_mesh_hessian_transposes_match_xla(ranks, case, impl):
    """The "hvp" and "rof" Hessian transposes against the port's "xla"
    mesh step on the same mesh (1e-9), and against JAX's second-order mesh
    step (rtol 1e-8, as the "xla" and "fhvp" steps)."""
    results, refs = ranks
    ref_losses, ref_params = refs[case]
    for res in results[case]:
        losses, params = res["so"][impl]
        np.testing.assert_allclose(losses, res["so"]["xla"][0], rtol=1e-9, atol=1e-12)
        _assert_params(params, res["so"]["xla"][1], rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(losses, ref_losses, **TOL_JAX)
        _assert_params(params, ref_params, **TOL_JAX_PARAMS)


def test_lockstep_mesh_step_matches_serial_with_dropout(ranks):
    """Under `_VBATCH` each rank's two tasks run in lockstep (one call of
    `lockstep_grad_sums` an update, V = 2), each drawing from the generator
    its serial run draws from: the same step as the serial mesh step with
    dropout on (1e-10); the serial step never runs in lockstep."""
    results, _ = ranks
    for res in results["dp"]:
        lock, serial = res["vbatch"]["lockstep"], res["vbatch"]["serial"]
        assert lock[2] == [2] and serial[2] == []
        np.testing.assert_allclose(lock[0], serial[0], rtol=1e-10, atol=1e-12)
        _assert_params(lock[1], serial[1], rtol=1e-10, atol=1e-12)


def test_lockstep_mesh_step_matches_jax_float64(ranks):
    """At dropout 0 on the plain stack (`lstm_kernel="xla"`) the lockstep dp
    step against JAX's dp meta step (1e-8)."""
    results, refs = ranks
    ref_losses, ref_params = refs["vbatch"]
    for res in results["dp"]:
        losses, params, calls = res["vbatch"]["plain"]
        assert calls == [2]
        np.testing.assert_allclose(losses, ref_losses, **TOL_JAX)
        _assert_params(params, ref_params, **TOL_JAX_PARAMS)


@pytest.mark.parametrize("case", [c for c, _, _ in GSPMD_CASES])
def test_gspmd_step_matches_jax_float64(ranks, case):
    """The GSPMD dp 2 x sp 2 step (stgcn first and second order; the hybrid
    as under a forced `mesh.sp_impl=gspmd`) against JAX's
    `make_parallel_meta_step_2d`, dropout 0: per-task losses (rtol 1e-8)
    and parameters; every rank's parameters bitwise equal."""
    results, refs = ranks
    ref_losses, ref_params = refs["gspmd-" + case]
    first = results["grid"][0]["gspmd"][case]
    for res in results["grid"]:
        losses, params = res["gspmd"][case]
        np.testing.assert_allclose(losses, ref_losses, **TOL_JAX)
        for name, p in params.items():
            torch.testing.assert_close(p, first[1][name], rtol=0, atol=0)
    _assert_params(first[1], ref_params, **TOL_JAX_PARAMS)


@pytest.mark.parametrize("case", [c for c, *_ in DROPOUT_CASES])
def test_gspmd_step_matches_dp_step_with_dropout(ranks, case):
    """Dropout on at every site (stgcn after every conv; the hybrid's GCN,
    two LSTM layers and head; query windows in train mode): the GSPMD step
    on dp 2 x sp 2 equals the dp step on dp 4 with the same key (1e-10),
    each task's full-N masks drawn from its dp stream and cut to the rank's
    rows. The wavefront cases run the wavefront on both steps (a rank's
    calls: 3 forwards a task, or one a Hessian transpose), the others
    never."""
    results, _ = ranks
    wavefront = "wavefront" in case
    for res in results["grid"]:
        got, ref = (res["gspmd_dropout"][case][k] for k in ("gspmd", "dp"))
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-10, atol=1e-12)
        _assert_params(got[1], ref[1], rtol=1e-10, atol=1e-12)
        # A GSPMD rank runs 2 tasks, a dp 4 rank one.
        want = (6, 3) if case == "hybrid-wavefront" else (4, 2) if wavefront else (0, 0)
        assert (got[2], ref[2]) == want, case


def test_shardmap_lockstep_step_matches_serial_with_dropout(ranks):
    """dp 2 x sp 2 under `_VBATCH`: each rank's two tasks run in lockstep
    at its 64 node rows (one `lockstep_grad_sums` call an update, V = 2;
    rows 16-17 and 9 on a card), the stacked inner gradients summed over
    sp before each task's clip: the same step as the serial shardmap step
    with dropout on at every site and the same key (float64, 1e-10), and
    every rank's parameters bitwise equal. The serial step never runs in
    lockstep."""
    results, _ = ranks
    first = results["grid"][0]["shardmap"]["lockstep"]
    for res in results["grid"]:
        lock, serial = res["shardmap"]["lockstep"], res["shardmap"]["serial"]
        assert lock[2] == [2] and serial[2] == []
        np.testing.assert_allclose(lock[0], serial[0], rtol=1e-10, atol=1e-12)
        _assert_params(lock[1], serial[1], rtol=1e-10, atol=1e-12)
        for name, p in lock[1].items():
            torch.testing.assert_close(p, first[1][name], rtol=0, atol=0)


def test_shardmap_step_ignores_the_wavefront_flags(ranks):
    """The shardmap step's LSTM is the node-local forward's, as in the JAX
    package: with `model.lstm_wavefront` and `meta.so_wavefront` (second
    order, hvp, dropout on) it runs without raising and takes bitwise the
    step it takes without them."""
    results, _ = ranks
    for res in results["grid"]:
        got, ref = res["shardmap"]["so_wavefront"], res["shardmap"]["so"]
        np.testing.assert_array_equal(got[0], ref[0])
        _assert_params(got[1], ref[1], rtol=0, atol=0)


def test_chained_dp_step_matches_jax_float64(ranks):
    """Two chained epochs on dp 2 (the batches cut from the pool by index)
    against JAX's chained dp step, dropout 0: losses stacked [2, 4]."""
    results, refs = ranks
    ref_losses, ref_params = refs["chained"]
    for res in results["dp"]:
        losses, params = res["chained"]
        assert losses.shape == (2, 4)
        np.testing.assert_allclose(losses, ref_losses, **TOL_JAX)
        _assert_params(params, ref_params, **TOL_JAX_PARAMS)


@pytest.mark.parametrize("route", ["gspmd", "shardmap"])
def test_chained_2d_step_is_two_single_steps(ranks, route):
    """Two chained epochs of each dp x sp step (the GSPMD step on stgcn, the
    shardmap step on the hybrid; dropout on) bitwise equal to two single
    steps fed the same indices and epoch keys."""
    results, _ = ranks
    for res in results["grid"]:
        chained, single = (res["chained_2d"][route][k] for k in ("chained", "single"))
        torch.testing.assert_close(chained[0], single[0], rtol=0, atol=0)
        assert chained[2] == single[2] == 4
        for name, p in chained[1].items():
            torch.testing.assert_close(p, single[1][name], rtol=0, atol=0)


def test_engine_on_gspmd_mesh_matches_dp_mesh(ranks):
    """`run_meta_training` of the stgcn family, float64, dropout on: on dp 2
    x sp 2 (`sp_impl=auto`, which the log names as the GSPMD step; two
    epochs in one chunk) and on dp 4 epoch by epoch, the whole pool a batch
    so both sample the same indices: the same logs and files, losses and
    the last and final checkpoints within 1e-10."""
    results, _ = ranks
    for res in results["grid"]:
        engine = res["engine"]
        grid, dp4 = engine["grid"], engine["dp4"]
        assert grid["files"] == dp4["files"]
        assert [r["task_indices"] for r in grid["log"]] == [r["task_indices"] for r in dp4["log"]]
        assert [r.get("dispatch_epochs") for r in grid["log"]] == [2, 2]
        for key in ("meta_loss", "per_task_loss"):
            np.testing.assert_allclose([r[key] for r in grid["log"]],
                                       [r[key] for r in dp4["log"]], rtol=1e-10, atol=1e-12)
        for ckpt in ("ckpt_last", "ckpt_final"):
            _assert_params(grid[ckpt], dp4[ckpt], rtol=1e-10, atol=1e-12)
    lines = results["grid"][0]["engine"]["lines"]
    assert any("GSPMD step" in line for line in lines), lines
    assert any("2 epochs/dispatch" in line for line in lines), lines


def test_sharded_encoder_jvp_and_double_backward_match_unsharded(ranks):
    """sp 4: torch.func.jvp of the node-sharded encoder (its gathers' jvp)
    and its double backward (the gathers' reduce-scatter backward kept in
    the graph) against the unsharded encoder, float64 1e-10."""
    results, _ = ranks
    for res in results["grid"]:
        assert res["jvp"] < 1e-10, res["jvp"]
        assert res["double_backward"] < 1e-10 * max(1.0, res["double_backward_scale"]), res


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
