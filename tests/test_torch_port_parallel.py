"""The port's parallel paths (parallel/, `meta-train --mesh`) against the
JAX package, on the CPU.

In this process: meshes over a process group of one, the task placement on
a mesh description, the distributed initialisation's refusals, the
engine's choice of dp x sp step (`mesh.sp_impl` by family), and the
refusals of the mesh steps and the engine.

Across OS processes joined by gloo (this file's `__main__` block is the
rank; each rank runs several cases and writes its results, which the tests
read; the JAX references run here meanwhile):

  * 4 ranks, a dp 2 x sp 2 mesh: one float64 first-order meta step on four
    10 x 10-node regions padded to 128 nodes (real nodes on both sp
    shards, the case that catches a partial inner gradient), dropout 0,
    against JAX's `make_shardmap_meta_step_2d` on a 2 x 2 CPU mesh (rtol
    1e-9; parameters bitwise equal across ranks); a dropout-on float32 step
    that stays finite and moves the parameters; on an sp 4 mesh, the
    node-sharded forward and training gradients against JAX's
    `make_spatial_forward` / `make_spatial_train_step` (float64); the
    sandwich encoder's gathers and layer chain (its plain versions) against
    the unsharded encoder, forward and summed gradients (float64).
  * 2 ranks, a dp 2 mesh: one float64 meta step against JAX's
    `make_parallel_meta_step`; `run_meta_training` for 2 epochs (the same
    task indices on both ranks, one set of checkpoints) and a resumed run
    equal to the straight one.

Tolerances: 1e-9 relative on float64 steps (the same operations summed in
another order, through a few dozen SGD and Adam steps).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from weatherforecast_stgcn_maml_tpu_torch import config as tcfg
from weatherforecast_stgcn_maml_tpu_torch.engines import meta_train
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm_stack
from weatherforecast_stgcn_maml_tpu_torch.parallel import distributed
from weatherforecast_stgcn_maml_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    make_mesh_2d,
    resolve_sp_impl,
    shard_task_batch,
    shard_task_batch_2d,
)
from weatherforecast_stgcn_maml_tpu_torch.parallel.meta_dp import make_parallel_meta_step
from weatherforecast_stgcn_maml_tpu_torch.parallel.meta_gspmd import make_parallel_meta_step_2d
from weatherforecast_stgcn_maml_tpu_torch.parallel.meta_sp import make_shardmap_meta_step_2d
from weatherforecast_stgcn_maml_tpu_torch.train import maml
from weatherforecast_stgcn_maml_tpu_torch.train.tasks import Task

torch.set_num_threads(1)  # small tensors; more threads oversubscribe side-by-side workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(hidden_channels=8, gcn_layers=2, lstm_hidden=8, lstm_layers=1, window=6,
             horizon=2, koppen_dim=4, gcn_dropout=0.0, lstm_dropout=0.0,
             compute_dtype="float64", lstm_kernel="xla")
META = dict(meta_batch=4, grad_accum=2, inner_epochs=1, inner_batches=2,
            query_train_mode=False)
SMALL = dict(hidden_channels=16, gcn_layers=2, lstm_hidden=8, lstm_layers=2, window=6,
             horizon=3, koppen_dim=4)
TOL = dict(rtol=1e-9, atol=1e-12)


def _fake_mesh(dp, sp, rank):
    """A mesh description with no groups: placement and refusals only."""
    names = ("dp", "sp") if sp > 1 else ("dp",)
    return Mesh(names, dp, sp, rank, torch.device("cpu"), None, None, None)


# ---------------------------------------------------------------------------
# The rank worker (run as a script)
# ---------------------------------------------------------------------------


def _load_inputs(out_dir):
    from weatherforecast_stgcn_maml_tpu_torch.models.registry import init_model
    from weatherforecast_stgcn_maml_tpu_torch.train.maml import MamlState
    from weatherforecast_stgcn_maml_tpu_torch.train.optimizers import MetaOptimizer

    saved = torch.load(os.path.join(out_dir, "inputs.pt"))
    tasks = Task(**saved["tasks"])

    def state(mc):
        model = init_model(torch.Generator().manual_seed(0), mc).double()
        model.load_state_dict(saved["params"])
        return MamlState(model, MetaOptimizer.init(dict(model.named_parameters())), 0)

    return tasks, state


def _step_result(state, metrics):
    return {"per_task": metrics["per_task_loss"].numpy(),
            "params": {k: v.detach().clone() for k, v in state.params.state_dict().items()}}


def _mesh_and_single_steps(make_step, mesh, out_dir):
    """One float64 meta step on `mesh` and, for comparison, the port's
    single-device step (train/maml.py) on the same inputs."""
    from weatherforecast_stgcn_maml_tpu_torch.train.maml import make_meta_step

    tasks, state = _load_inputs(out_dir)
    mc, meta = tcfg.ModelConfig(**MODEL), tcfg.MetaConfig(**META)
    return {"step": _step_result(*make_step(mc, meta, mesh)(state(mc), tasks, None)),
            "single": _step_result(*make_meta_step(mc, meta)(state(mc), tasks, None))}


def _grid_rank(out_dir, rank):
    """dp 2 x sp 2: the float64 meta step, a dropout step, the sp 4 forward
    and train step, and the sandwich encoder glue."""
    from weatherforecast_stgcn_maml_tpu_torch.models.stgcn import init_encoder
    from weatherforecast_stgcn_maml_tpu_torch.ops.fused_gcn import gcn_stack_plain
    from weatherforecast_stgcn_maml_tpu_torch.ops.fused_gcn_shard import gcn_shard_encoder
    from weatherforecast_stgcn_maml_tpu_torch.parallel.mesh import all_reduce_tensors
    from weatherforecast_stgcn_maml_tpu_torch.models.losses import masked_mse
    from weatherforecast_stgcn_maml_tpu_torch.parallel.spatial import (
        _spatial_encoder,
        make_spatial_forward,
        make_spatial_train_step,
        spatial_mse,
    )
    from weatherforecast_stgcn_maml_tpu_torch.train.maml import init_meta_state
    from weatherforecast_stgcn_maml_tpu_torch.train.supervised import SupervisedState

    tasks, state = _load_inputs(out_dir)
    mc, meta = tcfg.ModelConfig(**MODEL), tcfg.MetaConfig(**META)
    mesh = make_mesh(tcfg.MeshConfig(spatial_devices=2), torch.device("cpu"))
    assert (mesh.dp, mesh.sp, mesh.dp_index, mesh.sp_index) == (2, 2, rank // 2, rank % 2)
    res = _mesh_and_single_steps(make_shardmap_meta_step_2d, mesh, out_dir)

    mc_d = dataclasses.replace(mc, compute_dtype="float32", lstm_layers=2, gcn_dropout=0.3,
                               lstm_dropout=0.3, lstm_kernel="auto")
    meta_d = dataclasses.replace(meta, meta_batch=2, grad_accum=1)
    st = init_meta_state(torch.Generator().manual_seed(0), mc_d, meta_d)
    before = {k: v.clone() for k, v in st.params.state_dict().items()}
    tasks32 = Task(*(f[:2].float() if f.is_floating_point() else f[:2] for f in tasks))
    st, m = make_shardmap_meta_step_2d(mc_d, meta_d, mesh)(st, tasks32, (3,))
    res["dropout"] = {"loss": float(m["meta_loss"]), "before": before,
                      "after": {k: v.clone() for k, v in st.params.state_dict().items()}}

    # sp 4: the forward and one training step on task 0's first window.
    sp4 = make_mesh_2d(1, 4, torch.device("cpu"))
    t0 = Task(*(f[0] for f in tasks))
    model = state(mc).params
    res["forward"] = make_spatial_forward(mc, sp4)(
        model, t0.a_hat, t0.support_x[0], t0.koppen).numpy()

    class Sgd:  # p <- p - lr * g: the update then shows the gradient
        def update(self, grads, opt_state, params, lr):
            for k, p in params.items():
                p.data.sub_(lr * grads[k])

    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    _, loss = make_spatial_train_step(mc, sp4, Sgd())(
        SupervisedState(model, None), t0.support_x[0], t0.support_y[0], t0.a_hat,
        t0.node_mask, t0.koppen, 1.0, None)
    res["train"] = {"loss": float(loss),
                    "grads": {k: (p0[k] - p).detach().numpy() for k, p in model.named_parameters()}}
    noise = np.random.default_rng(4)
    preds, targets = (torch.from_numpy(noise.normal(size=(3, 128, 12))) for _ in range(2))
    node_mask = (torch.arange(128) < 90).double()
    res["mse"] = (float(spatial_mse(sp4)(preds, targets, node_mask)),
                  float(masked_mse(preds, targets, node_mask)))

    # The sandwich encoder (gathers, layer chain, masks on this rank's rows)
    # against the unsharded encoder; summed gradients over the sp group.
    cfg = tcfg.ModelConfig(hidden_channels=8, gcn_layers=3, gcn_dropout=0.3,
                           compute_dtype="float64")
    n, w, keep = 128, 5, 0.7
    draw = np.random.default_rng(0)
    layers = init_encoder(torch.Generator().manual_seed(1), cfg).double().layers
    x = torch.from_numpy(draw.normal(size=(w, n, cfg.in_channels)))
    a = torch.from_numpy(draw.uniform(size=(n, n)) / n)
    masks = torch.from_numpy((draw.uniform(size=(2, w, n, 8)) < keep).astype(np.int8))
    ct = torch.from_numpy(draw.normal(size=(w, n, 8)))
    rows = slice(mesh.sp_index * n // 2, (mesh.sp_index + 1) * n // 2)
    params = [p for layer in layers for p in (layer.w, layer.b)]

    def node_major(t):
        return t[..., rows, :].transpose(-3, -2).contiguous()

    enc = {}
    for route in ("sandwich", "layerwise"):
        xl = node_major(x).requires_grad_(True)
        args = (a[rows].contiguous(), xl)
        if route == "sandwich":
            h = gcn_shard_encoder(layers, *args, mesh.sp_group, masks=node_major(masks),
                                  keep=keep, compute_dtype=torch.float64)
        else:
            h = _spatial_encoder(layers, *args, cfg, mesh.sp_group, node_major(masks))
        grads = torch.autograd.grad((h * node_major(ct)).sum(), [xl, *params])
        enc[route] = (h.detach(), grads[0], all_reduce_tensors(list(grads[1:]), mesh.sp_group))
    xg = x.clone().requires_grad_(True)
    h = gcn_stack_plain(layers, a, xg, torch.float64, masks, keep)
    grads = torch.autograd.grad((h * ct).sum(), [xg, *params])
    ref = (node_major(h.detach()), node_major(grads[0]), grads[1:])
    res["encoder"] = {
        route: max(float((g - r).abs().max()) for g, r in zip(
            [got[0], got[1], *got[2]], [ref[0], ref[1], *ref[2]]))
        for route, got in enc.items()}
    return res


def _dp_rank(out_dir, rank):
    """dp 2: the float64 meta step, then the engine on two ranks."""
    from weatherforecast_stgcn_maml_tpu_torch.data.synthetic import synthetic_region_for_box

    mesh = make_mesh(tcfg.MeshConfig(), torch.device("cpu"))
    assert (mesh.axis_names, mesh.dp, mesh.sp) == (("dp",), 2, 1)
    res = _mesh_and_single_steps(make_parallel_meta_step, mesh, out_dir)

    sampled = []

    class Recording(meta_train.DifficultySampler):
        def sample(self):
            idx = super().sample()
            sampled[-1].append(np.asarray(idx).tolist())
            return idx

    meta_train.DifficultySampler = Recording
    regions = [synthetic_region_for_box((10.0 + 2 * i, 11.0 + 2 * i, 20.0, 21.0),
                                        num_timesteps=40, seed=i) for i in range(4)]
    overrides = [f"model.{k}={v}" for k, v in SMALL.items()] + [
        "meta.inner_epochs=1", "meta.inner_batches=2"]
    for out, epochs, resume in (("a", 2, False), ("b", 1, False), ("b", 2, True)):
        sampled.append([])
        cfg = tcfg.apply_overrides(tcfg.ExperimentConfig(), overrides + [
            f"out_dir={os.path.join(out_dir, out)}", f"meta.num_epochs={epochs}"])
        meta_train.run_meta_training(cfg, regions, mesh=mesh, resume=resume,
                                     log_cb=lambda *a: None)
    res["sampled"] = sampled
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


def _jax_cfgs():
    from weatherforecast_stgcn_maml_tpu import config as jcfg

    return jcfg.ModelConfig(**MODEL), jcfg.MetaConfig(**META)


def _jax_tasks_and_state():
    """The four 10 x 10-node tasks (built on the JAX package's numpy host
    route) and the float64 initial state, as JAX arrays (call under x64)."""
    import jax
    import jax.numpy as jnp

    from tests._host_route import restore_host_routes, use_same_host_route
    from weatherforecast_stgcn_maml_tpu.config import DataConfig
    from weatherforecast_stgcn_maml_tpu.data.synthetic import synthetic_region_for_box
    from weatherforecast_stgcn_maml_tpu.train.maml import MamlState, init_meta_state
    from weatherforecast_stgcn_maml_tpu.train.optimizers import meta_optimizer
    from weatherforecast_stgcn_maml_tpu.train.tasks import build_meta_tasks, stack_tasks

    mc, meta = _jax_cfgs()
    regions = [synthetic_region_for_box((10.0 + i, 12.25 + i, 20.0, 22.25), num_timesteps=32,
                                        seed=i) for i in range(meta.meta_batch)]
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

    from weatherforecast_stgcn_maml_tpu_torch.utils.convert import state_dict_from_params

    with jax.enable_x64(True):
        tasks, state = _jax_tasks_and_state()
        fields = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in tasks._asdict().items()}
        fields["koppen"] = fields["koppen"].long()
        params = state_dict_from_params(jax.tree.map(np.asarray, state.params), np.float64)
    assert int(fields["node_mask"][0].sum()) == 100 and fields["node_mask"].shape[1] == 128
    torch.save({"tasks": fields, "params": params}, os.path.join(out_dir, "inputs.pt"))


def _jax_references():
    import jax
    import jax.numpy as jnp
    import optax

    from weatherforecast_stgcn_maml_tpu.config import MeshConfig
    from weatherforecast_stgcn_maml_tpu.ops import fused_gcn_shard
    from weatherforecast_stgcn_maml_tpu.parallel import mesh as jmesh
    from weatherforecast_stgcn_maml_tpu.parallel.meta_dp import make_parallel_meta_step as jdp
    from weatherforecast_stgcn_maml_tpu.parallel.meta_sp import make_shardmap_meta_step_2d as jsp
    from weatherforecast_stgcn_maml_tpu.parallel.spatial import (
        make_spatial_forward,
        make_spatial_train_step,
    )
    from weatherforecast_stgcn_maml_tpu_torch.utils.convert import state_dict_from_params

    def sd(tree):
        return state_dict_from_params(jax.tree.map(np.asarray, tree), np.float64)

    mc, meta = _jax_cfgs()
    refs = {}
    with jax.enable_x64(True), fused_gcn_shard.force_reference():
        tasks, state = _jax_tasks_and_state()
        grid = jmesh.make_mesh_2d(2, 2)
        s, m = jsp(mc, meta, grid, donate_state=False)(
            state, jmesh.shard_task_batch_2d(tasks, grid), jax.random.key(7))
        refs["grid"] = (np.asarray(m["per_task_loss"]), sd(s.params))
        dp = jmesh.make_mesh(MeshConfig(num_devices=2))
        s, m = jdp(mc, meta, dp, donate_state=False)(
            state, jmesh.shard_task_batch(tasks, dp), jax.random.key(7))
        refs["dp"] = (np.asarray(m["per_task_loss"]), sd(s.params))
        sp4 = jmesh.make_mesh(MeshConfig(data_axis="sp", num_devices=4))
        t0 = jax.tree.map(lambda f: f[0], tasks)
        args = (t0.a_hat, t0.support_x[0])
        refs["forward"] = np.asarray(make_spatial_forward(mc, sp4)(state.params, *args, t0.koppen))
        tx = optax.identity()
        p2, _, loss = make_spatial_train_step(mc, sp4, tx)(
            state.params, tx.init(state.params), *args, t0.support_y[0], t0.koppen,
            t0.node_mask, 1.0, jax.random.key(5))
        refs["train"] = (float(loss), sd(jax.tree.map(lambda a, b: a - b, state.params, p2)))
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Launch the 4-rank and 2-rank workers, compute the JAX references
    while they run, and return (results per case and rank, references)."""
    out_dir = str(tmp_path_factory.mktemp("ranks"))
    _write_inputs(out_dir)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = []
    for case, world in (("grid", 4), ("dp", 2)):
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
        for case, world in (("grid", 4), ("dp", 2))
    }
    return results, refs, out_dir


def _check_step(ranks_res, ref):
    """Per-task losses and parameters against JAX; the parameters bitwise
    equal on every rank and equal to the port's single-device step to the
    last bits. The parameters' atol: the two packages' float32 learning-rate
    schedules differ in the last bit of cos (numpy vs XLA), one float32 ulp
    (2^-23 relative) of lr = 1e-3 per AdamW update, 1.2e-10 after these two
    (measured); everything else is held at rtol 1e-9."""
    ref_losses, ref_params = ref
    for res in ranks_res:
        np.testing.assert_allclose(res["step"]["per_task"], ref_losses, **TOL)
    got = ranks_res[0]["step"]["params"]
    for name, p in got.items():
        np.testing.assert_allclose(p.numpy(), ref_params[name].numpy(), err_msg=name,
                                   rtol=1e-9, atol=3e-10)
        np.testing.assert_allclose(p.numpy(), ranks_res[0]["single"]["params"][name].numpy(),
                                   err_msg=name, rtol=1e-12, atol=1e-15)
        for other in ranks_res[1:]:  # every rank took the same update
            torch.testing.assert_close(other["step"]["params"][name], p, rtol=0, atol=0)


def test_grid_meta_step_matches_jax_shardmap_float64(ranks):
    results, refs, _ = ranks
    _check_step(results["grid"], refs["grid"])


def test_dp_meta_step_matches_jax_float64(ranks):
    results, refs, _ = ranks
    _check_step(results["dp"], refs["dp"])


def test_spatial_forward_and_train_step_match_jax(ranks):
    """sp 4 (32 rows each): every rank's forward rows and the summed
    training gradient (the same on every rank) against JAX's; the sharded
    masked MSE against the port's unsharded one."""
    results, refs, _ = ranks
    for r, res in enumerate(results["grid"]):
        np.testing.assert_allclose(*res["mse"], rtol=1e-12)
        np.testing.assert_allclose(res["forward"], refs["forward"][:, 32 * r:32 * (r + 1)],
                                   **TOL)
        ref_loss, ref_grads = refs["train"]
        np.testing.assert_allclose(res["train"]["loss"], ref_loss, **TOL)
        for name, g in res["train"]["grads"].items():
            np.testing.assert_allclose(g, ref_grads[name].numpy(), err_msg=name, **TOL)


def test_dropout_step_stays_finite_and_moves(ranks):
    results, _, _ = ranks
    first = results["grid"][0]["dropout"]
    assert np.isfinite(first["loss"])
    assert any(not torch.equal(first["before"][k], v) for k, v in first["after"].items())
    for res in results["grid"][1:]:
        assert res["dropout"]["loss"] == first["loss"]
        for k, v in res["dropout"]["after"].items():
            torch.testing.assert_close(v, first["after"][k], rtol=0, atol=0)


def test_sandwich_encoder_glue_matches_unsharded(ranks):
    """Both node-sharded encoder routes (the sandwich route's gathers and
    layer chain; the layerwise route) against the unsharded encoder: the
    rank's rows of the output and input gradient, the parameter gradients
    summed over sp. float64."""
    results, _, _ = ranks
    for res in results["grid"]:
        assert res["encoder"]["sandwich"] < 1e-12, res["encoder"]
        assert res["encoder"]["layerwise"] < 1e-12, res["encoder"]


def test_meta_training_on_two_ranks(ranks):
    """Same task indices on both ranks; rank 0 alone wrote one set of logs
    and checkpoints; resumed = straight."""
    results, _, out_dir = ranks
    sampled = [res["sampled"] for res in results["dp"]]
    assert sampled[0] == sampled[1]
    straight, first, resumed = sampled[0]
    assert len(straight) == 2 and first + resumed == straight
    for out in ("a", "b"):
        meta_dir = os.path.join(out_dir, out, "meta")
        assert sorted(os.listdir(meta_dir)) == [
            "ckpt_best", "ckpt_final", "ckpt_last", "meta_log.csv", "meta_log.jsonl"]
        assert len(open(os.path.join(meta_dir, "meta_log.csv")).read().splitlines()) == 3

    def log(out):
        with open(os.path.join(out_dir, out, "meta", "meta_log.jsonl")) as f:
            return [json.loads(line) for line in f]

    for key in ("meta_loss", "task_indices", "per_task_loss"):
        assert [r[key] for r in log("b")] == [r[key] for r in log("a")], key
    a = torch.load(os.path.join(out_dir, "a", "meta", "ckpt_final", "params.pt"))
    b = torch.load(os.path.join(out_dir, "b", "meta", "ckpt_final", "params.pt"))
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# In process
# ---------------------------------------------------------------------------


@pytest.fixture()
def world_of_one():
    """A gloo process group of one rank in this process."""
    assert distributed.ensure_process_group("gloo")
    yield
    dist.destroy_process_group()


def test_meshes_over_a_world_of_one(world_of_one):
    mesh = make_mesh(tcfg.MeshConfig(), torch.device("cpu"))
    assert (mesh.axis_names, mesh.dp, mesh.sp, mesh.rank, mesh.size) == (("dp",), 1, 1, 0, 1)
    assert distributed.global_mesh(device=torch.device("cpu")).axis_names == ("dp",)
    grid = make_mesh_2d(1, 1, torch.device("cpu"))
    assert grid.axis_names == ("dp", "sp") and (grid.dp_index, grid.sp_index) == (0, 0)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        make_mesh(tcfg.MeshConfig(num_devices=2))
    with pytest.raises(ValueError, match="divisible by spatial_devices"):
        make_mesh(tcfg.MeshConfig(spatial_devices=2))
    with pytest.raises(ValueError, match="requested 2x1 devices"):
        make_mesh_2d(2, 1, torch.device("cpu"))


def test_resolve_sp_impl():
    hybrid = tcfg.ModelConfig()
    assert tcfg.MeshConfig().sp_impl == "auto"
    assert resolve_sp_impl("auto", hybrid) == "shardmap"
    assert resolve_sp_impl("auto", dataclasses.replace(hybrid, family="stgcn")) == "gspmd"
    for explicit in ("gspmd", "shardmap"):
        assert resolve_sp_impl(explicit, hybrid) == explicit


def test_task_placement_cuts_tasks_and_node_rows():
    rng = np.random.default_rng(0)
    b, n = 4, 8
    full = Task(
        support_x=torch.from_numpy(rng.normal(size=(b, 2, 3, n, 5))),
        support_y=torch.from_numpy(rng.normal(size=(b, 2, 2, n, 12))),
        query_x=torch.from_numpy(rng.normal(size=(b, 1, 3, n, 5))),
        query_y=torch.from_numpy(rng.normal(size=(b, 1, 2, n, 12))),
        koppen=torch.arange(b), a_hat=torch.from_numpy(rng.normal(size=(b, n, n))),
        node_mask=torch.from_numpy(rng.uniform(size=(b, n))),
    )
    for rank in range(4):
        mesh = _fake_mesh(2, 2, rank)
        d, s = rank // 2, rank % 2
        got = shard_task_batch_2d(Task(*(f[2:] for f in full)), mesh)
        tasks, rows = slice(2 + d, 3 + d), slice(4 * s, 4 * s + 4)
        np.testing.assert_array_equal(got.support_x, full.support_x[tasks][..., rows, :])
        np.testing.assert_array_equal(got.query_y, full.query_y[tasks][..., rows, :])
        np.testing.assert_array_equal(got.a_hat, full.a_hat[tasks][:, rows])
        np.testing.assert_array_equal(got.node_mask, full.node_mask[tasks][:, rows])
        np.testing.assert_array_equal(got.koppen, full.koppen[tasks])
        dp_only = shard_task_batch(full, _fake_mesh(2, 1, d))
        np.testing.assert_array_equal(dp_only.support_x, full.support_x[2 * d:2 * d + 2])
    with pytest.raises(ValueError, match="dp ranks"):
        shard_task_batch(full, _fake_mesh(3, 1, 0))
    with pytest.raises(ValueError, match="padded nodes"):
        shard_task_batch_2d(full, _fake_mesh(1, 3, 0))


@pytest.mark.parametrize("env", [
    {"COORDINATOR_ADDRESS": "localhost:1234"},
    {"NUM_PROCESSES": "2", "PROCESS_ID": "0"},
    {"MASTER_ADDR": "localhost", "WORLD_SIZE": "2"},
])
def test_partial_topology_raises(monkeypatch, env):
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR",
              "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="partial multi-process configuration"):
        distributed.initialize()


def test_mesh_steps_refuse_what_they_do_not_run(monkeypatch):
    mc, meta = tcfg.ModelConfig(**MODEL), tcfg.MetaConfig(**META)
    with pytest.raises(ValueError, match="dp mesh axis"):  # 2 tasks per update over 4
        make_shardmap_meta_step_2d(mc, meta, _fake_mesh(4, 2, 0))
    with pytest.raises(ValueError, match="hybrid"):
        make_shardmap_meta_step_2d(dataclasses.replace(mc, family="stgcn"), meta,
                                   _fake_mesh(2, 2, 0))
    with pytest.raises(ValueError, match="mesh size"):
        make_parallel_meta_step(mc, meta, _fake_mesh(4, 1, 0))
    # Under `_VBATCH` both steps build: each runs a rank's tasks in lockstep.
    monkeypatch.setattr(fused_lstm_stack, "_VBATCH", True)
    make_shardmap_meta_step_2d(mc, meta, _fake_mesh(2, 2, 0))
    make_parallel_meta_step(mc, meta, _fake_mesh(2, 1, 0))


def test_engine_picks_the_dp_x_sp_step(monkeypatch):
    """`mesh.sp_impl` resolved for the family: "auto" takes the shardmap
    step for the hybrid and the GSPMD step for stgcn; a 1-D mesh takes
    neither; an unknown value raises. Under `_VBATCH` the GSPMD step builds
    too (its dp axis must divide the tasks an update)."""
    grid = _fake_mesh(1, 2, 0)

    def cfg(*overrides):
        return tcfg.apply_overrides(tcfg.ExperimentConfig(), list(overrides))

    assert meta_train._check_mesh(cfg(), _fake_mesh(2, 1, 0)) is None
    assert meta_train._check_mesh(cfg(), grid) == "shardmap"
    assert meta_train._check_mesh(cfg("model.family=stgcn"), grid) == "gspmd"
    assert meta_train._check_mesh(cfg("mesh.sp_impl=gspmd"), grid) == "gspmd"
    with pytest.raises(ValueError, match="sp_impl"):
        meta_train._check_mesh(cfg("mesh.sp_impl=xla"), grid)
    mc, meta = tcfg.ModelConfig(**MODEL), tcfg.MetaConfig(**META)
    with pytest.raises(ValueError, match="dp mesh axis"):  # 2 tasks per update over 4
        make_parallel_meta_step_2d(mc, meta, _fake_mesh(4, 2, 0))
    monkeypatch.setattr(fused_lstm_stack, "_VBATCH", True)
    assert meta_train._check_mesh(cfg("mesh.sp_impl=gspmd"), grid) == "gspmd"
    make_parallel_meta_step_2d(mc, meta, _fake_mesh(2, 2, 0))


@pytest.mark.parametrize("override,match", [
    ([], "_VBATCH"),  # with ops.fused_lstm_stack._VBATCH set
])
def test_engine_takes_vbatch_on_the_dp_x_sp_mesh(monkeypatch, override, match):
    """Under `_VBATCH` the engine's dp x sp mesh takes the shardmap step,
    which runs a rank's tasks in lockstep where a plan holds them at its
    node rows (`lockstep_route` on the rank's share of the batch: V = 2
    tasks of 64 rows on dp 2 x sp 2 here), else one after another,
    counted."""
    if match == "_VBATCH":
        monkeypatch.setattr(fused_lstm_stack, "_VBATCH", True)
    cfg = tcfg.apply_overrides(tcfg.ExperimentConfig(), override)
    grid = _fake_mesh(2, 2, 1)
    assert meta_train._check_mesh(cfg, grid) == "shardmap"
    make_shardmap_meta_step_2d(cfg.model, cfg.meta, grid)
    batch = Task(*(torch.zeros((4, *shape)) for shape in (
        (2, 24, 128, 16), (2, 8, 128, 12), (1, 24, 128, 16), (1, 8, 128, 12), (),
        (128, 128), (128,))))
    mine = shard_task_batch_2d(batch, grid)
    assert mine.support_x.shape[:1] + mine.support_x.shape[3:4] == (2, 64)
    assert maml.lockstep_route(cfg.model, cfg.meta, mine)
    before = maml.lockstep_route.serial_fallbacks
    wide = dataclasses.replace(cfg.model, lstm_hidden=448)  # no plan at float32 H 448
    assert not maml.lockstep_route(wide, cfg.meta, mine)
    assert maml.lockstep_route.serial_fallbacks == before + 1


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
