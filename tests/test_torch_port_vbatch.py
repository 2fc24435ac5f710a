"""The two flag-selected LSTM-stack routes of the port against the JAX
package, on the CPU: the task-batched first-order meta step (`_VBATCH`,
kernel rows 16-17 with row 9) and the unmerged-gates stack
(`_MERGED_GATES=False`, rows 14-15).

  * rows 16-17: the port's plain version (`lstm_stack_tasks_plain`, its
    gradients by autograd) against JAX's `_fwd_pallas_mv` / `_bwd_pallas_mv`
    bodies in the Pallas interpreter, reached as JAX reaches them: jax.vmap
    of jax.grad over per-task weights with injected int8 masks and
    `_VBATCH` on (V = 2 and 3);
  * rows 14-15: `split_forward_plain` against `_fwd_pallas` (the residual
    contract: h_all, c_all, h_last) and `split_backward_plain` from JAX's
    residuals against `_bwd_pallas`, masks on and off;
  * the task-batched hybrid forward against V calls of `apply_hybrid`
    (float64, the same masks);
  * the lockstep FO meta step in float64 against JAX `make_meta_step`
    (dropout 0, JAX's tasks on the port's host route), with the fused and
    the per-leaf inner update; the lockstep route against the port's serial
    route with the same injected masks; one float32 meta-gradient against
    JAX's with `_VBATCH` on in the interpreter (rows 16-17 inside JAX's
    whole meta step);
  * refusals, and the routes with no merged stack launching neither row 16
    nor row 17.

Tolerances: float32 rtol 1e-4 / atol 1e-5 on rows 16-17 (JAX's own, for a
reduction over thousands of terms in another order); 1e-5 on row 14's
outputs and 1e-4 on row 15's gradients; the float32 meta-gradient rtol 2e-4
/ atol 1e-6 (JAX's own for its meta-gradient through the stack kernel);
float64 1e-12 on the forward (the same operations in another order) and
1e-8 on the meta step, as tests/test_torch_port_maml.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from weatherforecast_stgcn_maml_tpu import config as jcfg
from tests._host_route import restore_host_routes, use_same_host_route
from weatherforecast_stgcn_maml_tpu.data.synthetic import synthetic_region_for_box as jax_box
from weatherforecast_stgcn_maml_tpu.models.lstm import init_lstm as jax_init_lstm
from weatherforecast_stgcn_maml_tpu.ops import fused_lstm_stack as jax_fls
from weatherforecast_stgcn_maml_tpu.train import maml as jax_maml
from weatherforecast_stgcn_maml_tpu.train import optimizers as jax_opt
from weatherforecast_stgcn_maml_tpu.train.tasks import build_meta_tasks as jax_build_meta_tasks
from weatherforecast_stgcn_maml_tpu.train.tasks import stack_tasks as jax_stack_tasks
from weatherforecast_stgcn_maml_tpu_torch import config as tcfg
from weatherforecast_stgcn_maml_tpu_torch.data.synthetic import synthetic_region_for_box
from weatherforecast_stgcn_maml_tpu_torch.engines import meta_train
from weatherforecast_stgcn_maml_tpu_torch.models import hybrid
from weatherforecast_stgcn_maml_tpu_torch.models.lstm import split_lstm_biases
from weatherforecast_stgcn_maml_tpu_torch.models.registry import apply_model, init_model
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm_stack as fls
from weatherforecast_stgcn_maml_tpu_torch.parallel import meta_dp, meta_sp
from weatherforecast_stgcn_maml_tpu_torch.train import maml
from weatherforecast_stgcn_maml_tpu_torch.train.tasks import Task, build_meta_tasks, stack_tasks
from weatherforecast_stgcn_maml_tpu_torch.utils.convert import (
    params_from_state_dict,
    state_dict_from_params,
)

torch.set_num_threads(1)  # small tensors; more threads oversubscribe side-by-side workers

T, B, C, H, L = 5, 16, 24, 8, 3  # JAX tests/test_lstm_stack.py's widths
MODEL = dict(hidden_channels=16, gcn_layers=2, lstm_hidden=8, lstm_layers=2, window=6,
             horizon=3, koppen_dim=4, gcn_dropout=0.0, lstm_dropout=0.0,
             compute_dtype="float64")


@pytest.fixture()
def same_host_route():
    """Both packages on one host route (`tests/_host_route.py`)."""
    use_same_host_route()
    yield
    restore_host_routes()


@pytest.fixture()
def vbatch(monkeypatch):
    """`_VBATCH` on in both packages, as JAX's tests pin it."""
    monkeypatch.setattr(jax_fls, "_VBATCH", True)
    monkeypatch.setattr(fls, "_VBATCH", True)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _masks(rng, shape, rate):
    return (rng.uniform(size=shape) >= rate).astype(np.int8)


def _wcat(layers):
    """numpy (wcat0, wcatr, b2d) of one JAX LSTM tree."""
    cat = [np.concatenate([p["wx"], p["wh"]]) for p in layers]
    return cat[0], np.stack(cat[1:]), np.stack([p["b"] for p in layers])


@pytest.mark.parametrize("nv", [2, 3])
def test_tasks_plain_matches_mv_bodies(vbatch, monkeypatch, nv):
    """Rows 16-17: per-task weights and injected masks; the forward and
    every per-task gradient (x and each weight) against jax.vmap of
    jax.grad, which `_VBATCH` routes to `_fwd_pallas_mv` / `_bwd_pallas_mv`
    (counted, so the test fails if JAX stops taking them)."""
    calls = {"fwd": 0, "bwd": 0}
    for name, key in (("_fwd_pallas_mv", "fwd"), ("_bwd_pallas_mv", "bwd")):
        real = getattr(jax_fls, name)

        def counted(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)

        monkeypatch.setattr(jax_fls, name, counted)
    rng = np.random.default_rng(nv)
    params = [_np(jax_init_lstm(jax.random.key(30 + v), C, H, L)) for v in range(nv)]
    stacked = jax.tree.map(lambda *a: np.stack(a), *params)
    x = rng.normal(size=(nv, B, T, C)).astype(np.float32)
    masks = _masks(rng, (nv, L - 1, T, B, H), 0.3)
    ct = rng.normal(size=(nv, B, H)).astype(np.float32)

    def per_task(p, xv, m, c):
        def loss(p, xv):
            out = jax_fls.lstm_stack_last_all(p, xv, dropout_rate=0.3, train=True, masks=m)
            return jnp.sum(out * c), out

        (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(p, xv)
        return out, grads

    with jax_fls.force_interpret():
        ref_out, (ref_gp, ref_gx) = jax.vmap(per_task)(
            jax.tree.map(jnp.asarray, stacked), jnp.asarray(x), jnp.asarray(masks),
            jnp.asarray(ct))
    assert calls == {"fwd": 1, "bwd": 1}

    w0, wr, b2d = (np.stack(a) for a in zip(*(_wcat(p["layers"]) for p in params)))
    leaves = [_t(a).requires_grad_(True) for a in (x, w0, wr, b2d)]
    out = fls.lstm_stack_train_tasks(*leaves, masks=_t(masks, torch.int8), keep=0.7)
    gx, gw0, gwr, gb = torch.autograd.grad(out, leaves, _t(ct))
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), **tol)
    np.testing.assert_allclose(gx.numpy(), np.asarray(ref_gx), **tol)
    # Every gradient leaf carries the task axis first.
    ref_w0 = np.concatenate([ref_gp["layers"][0]["wx"], ref_gp["layers"][0]["wh"]], axis=1)
    ref_wr = np.stack([np.concatenate([p["wx"], p["wh"]], axis=1)
                       for p in ref_gp["layers"][1:]], axis=1)
    ref_b = np.stack([p["b"] for p in ref_gp["layers"]], axis=1)
    np.testing.assert_allclose(gw0.numpy(), ref_w0, **tol)
    np.testing.assert_allclose(gwr.numpy(), ref_wr, **tol)
    np.testing.assert_allclose(gb.numpy(), ref_b, **tol)


@pytest.mark.parametrize("with_masks", [True, False])
def test_split_plain_matches_unmerged_bodies(with_masks):
    """Rows 14-15: the forward's residuals and last h against `_fwd_pallas`,
    then the backward from JAX's own residuals against `_bwd_pallas`, both
    in the interpreter; then the port's training entry (`merged=False`,
    the Function over the plain versions on the CPU) against autograd of
    the merged plain stack."""
    rng = np.random.default_rng(5)
    layers = _np(jax_init_lstm(jax.random.key(8), C, H, L))["layers"]
    wx0 = layers[0]["wx"]
    wxr = np.stack([p["wx"] for p in layers[1:]])
    wh = np.stack([p["wh"] for p in layers])
    b2d = np.stack([p["b"] for p in layers])
    x = rng.normal(size=(T, B, C)).astype(np.float32)
    masks = _masks(rng, (L - 1, T, B, H), 0.3) if with_masks else None
    keep = 0.7 if with_masks else 1.0
    g = rng.normal(size=(B, H)).astype(np.float32)
    j = [jnp.asarray(a) for a in (x, wx0, wxr, wh, b2d)]
    jm = None if masks is None else jnp.asarray(masks)
    ref = jax_fls._fwd_pallas(*j, jm, jnp.float32, True, keep)
    ref_b = jax_fls._bwd_pallas(jnp.asarray(g), j[0], ref[0], ref[1], *j[1:], jm, jnp.float32,
                                True, keep)
    w = [_t(a) for a in (x, wx0, wxr, wh, b2d)]
    tm = None if masks is None else _t(masks, torch.int8)
    h_last, h_all, c_all = fls.split_forward_plain(*w, tm, keep)
    for got, r in zip((h_all, c_all, h_last), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
    got_b = fls.split_backward_plain(_t(g), w[0], _t(ref[0]), _t(ref[1]), *w[1:], tm, keep)
    for got, r in zip(got_b, ref_b):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)

    from weatherforecast_stgcn_maml_tpu_torch.models.lstm import init_lstm

    lstm = init_lstm(torch.Generator().manual_seed(3), C, H, L)
    xb = torch.from_numpy(x.transpose(1, 0, 2).copy()).requires_grad_(True)
    params = [xb] + [p for layer in lstm.layers for p in (layer.wx, layer.wh, layer.b)]
    outs = [fls.lstm_stack_train(lstm.layers, xb, masks=tm, keep=keep, merged=merged)
            for merged in (False, True)]
    ct = torch.from_numpy(g)
    grads = [torch.autograd.grad(o, params, ct) for o in outs]
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-5)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_eval_entry_reads_merged_gates_at_call_time(monkeypatch):
    """`_MERGED_GATES=False` sends `lstm_stack_last_all` and
    `lstm_stack_train` to the unmerged stack, read at call time."""
    from weatherforecast_stgcn_maml_tpu_torch.models.lstm import init_lstm

    lstm = init_lstm(torch.Generator().manual_seed(3), C, H, L)
    x = torch.randn((B, T, C), generator=torch.Generator().manual_seed(4))
    seen = []
    real = fls.lstm_stack_split
    monkeypatch.setattr(fls, "lstm_stack_split",
                        lambda *a, **k: seen.append(k.get("train", True)) or real(*a, **k))
    with torch.no_grad():
        merged = fls.lstm_stack_last_all(lstm.layers, x)
        monkeypatch.setattr(fls, "_MERGED_GATES", False)
        split = fls.lstm_stack_last_all(lstm.layers, x)
        fls.lstm_stack_train(lstm.layers, x)
        fls.lstm_stack_last_all(lstm.layers, x, merged=True)
    assert seen == [False, True]
    torch.testing.assert_close(split, merged, rtol=1e-5, atol=1e-6)


def _stacked(models):
    """{name: [V, ...]} of V models' parameters."""
    named = [dict(m.named_parameters()) for m in models]
    return {k: torch.stack([n[k] for n in named]) for k in named[0]}


@pytest.mark.parametrize("split_biases", [False, True])
def test_hybrid_tasks_matches_serial_float64(split_biases):
    """The task-batched train forward equals V calls of `apply_hybrid`
    (train mode) with the same masks, at V distinct parameter sets."""
    cfg = tcfg.ModelConfig(**{**MODEL, "gcn_dropout": 0.2, "lstm_dropout": 0.3})
    nv, n = 3, 12
    models = [init_model(torch.Generator().manual_seed(v), cfg).double() for v in range(nv)]
    if split_biases:
        for m in models:
            split_lstm_biases(m.lstm)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(nv, cfg.window, n, cfg.feature_channels)))
    a_hat = torch.from_numpy(rng.uniform(size=(nv, n, n)) / n)
    koppen = torch.tensor([3, 0, 7])
    gen = torch.Generator().manual_seed(2)
    masks = [hybrid.hybrid_masks(cfg, gen, cfg.window, n, "cpu") for _ in range(nv)]
    stacked = {k: torch.stack([m[k] for m in masks]) for k in masks[0]}
    got = hybrid.apply_hybrid_tasks(_stacked(models), a_hat, x, koppen, cfg, masks=stacked)
    for v in range(nv):
        ref = hybrid.apply_hybrid(models[v], a_hat[v], x[v], koppen[v], cfg, train=True,
                                  masks=masks[v])
        np.testing.assert_allclose(got[v].detach().numpy(), ref.detach().numpy(),
                                   rtol=1e-12, atol=1e-12)


def _regions(port, count=2):
    make = synthetic_region_for_box if port else jax_box
    return [make((10.0 + i, 10.5 + i, 20.0, 20.5), num_timesteps=40, seed=i)
            for i in range(count)]


def _jax_f64(tree):
    return jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a), jnp.float64)
        if np.asarray(a).dtype == np.float32 else jnp.asarray(a), tree)


@pytest.mark.parametrize("fused", [True, False])
def test_lockstep_meta_step_matches_jax_float64(same_host_route, vbatch, monkeypatch, fused):
    """Two tasks in one micro-batch (V = 2), 2 x 2 inner steps, dropout 0,
    two meta steps: the port's lockstep route (counted) against JAX
    `make_meta_step`, with the fused and the per-leaf inner update."""
    meta_kw = dict(meta_batch=2, grad_accum=1, inner_epochs=2, inner_batches=2,
                   fused_inner_update=fused)
    mc, meta = jcfg.ModelConfig(**MODEL), jcfg.MetaConfig(**meta_kw)
    tmc, tmeta = tcfg.ModelConfig(**MODEL), tcfg.MetaConfig(**meta_kw)
    with jax.enable_x64(True):
        tasks = _jax_f64(jax_stack_tasks(
            [b.task for b in jax_build_meta_tasks(_regions(False), mc, meta, jcfg.DataConfig())]))
        tx, _ = jax_opt.meta_optimizer(meta)
        params = _jax_f64(jax_maml.init_model(jax.random.key(0), mc))
        state = jax_maml.MamlState(params, tx.init(params), jnp.zeros((), jnp.int32))
        step = jax.jit(jax_maml.make_meta_step(mc, meta))
        ref = []
        for e in range(2):
            state, m = step(state, tasks, jax.random.key(e))
            ref.append((state_dict_from_params(_np(state.params), np.float64), _np(m)))

    port_tasks = stack_tasks([b.task for b in build_meta_tasks(
        _regions(True), tmc, tmeta, tcfg.DataConfig())])
    port_tasks = type(port_tasks)(*(f.double() if f.is_floating_point() else f
                                    for f in port_tasks))
    calls = []
    real = maml.lockstep_batch_grad
    monkeypatch.setattr(maml, "lockstep_batch_grad",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    model = init_model(torch.Generator().manual_seed(0), tmc).double()
    model.load_state_dict(state_dict_from_params(_np(params), np.float64))
    port_state = maml.MamlState(model, maml.MetaOptimizer.init(dict(model.named_parameters())), 0)
    meta_step = maml.make_meta_step(tmc, tmeta)
    tol = dict(rtol=1e-8, atol=1e-8)
    for ref_params, ref_metrics in ref:
        port_state, metrics = meta_step(port_state, port_tasks, None)
        np.testing.assert_allclose(metrics["per_task_loss"].numpy(),
                                   ref_metrics["per_task_loss"], **tol)
        for name, p in port_state.params.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref_params[name].numpy(),
                                       err_msg=name, **tol)
    assert len(calls) == 2


def test_lockstep_matches_serial_with_same_masks(monkeypatch):
    """Dropout on (float64): the lockstep route and the serial route fed the
    same masks (each task's k-th forward takes mask set k of its own,
    whatever order the two routes draw in) give the same per-task losses
    and meta-gradient."""
    cfg = tcfg.ModelConfig(**{**MODEL, "gcn_dropout": 0.2, "lstm_dropout": 0.3})
    meta = tcfg.MetaConfig(meta_batch=2, grad_accum=1, inner_epochs=1, inner_batches=2)
    tasks = stack_tasks([b.task for b in build_meta_tasks(
        _regions(True), cfg, meta, tcfg.DataConfig())])
    tasks = Task(*(f.double() if f.is_floating_point() else f for f in tasks))
    nv, n = tasks.support_x.shape[0], tasks.support_x.shape[-2]
    forwards = meta.inner_epochs * tasks.support_x.shape[1] + 1
    gen = torch.Generator().manual_seed(5)
    table = [[hybrid.hybrid_masks(cfg, gen, cfg.window, n, "cpu") for _ in range(forwards)]
             for _ in range(nv)]
    model = init_model(torch.Generator().manual_seed(1), cfg).double()

    serial_calls = iter([(v, k) for v in range(nv) for k in range(forwards)])

    def serial_apply(params, a_hat, x, koppen, c, *, train, generator=None, masks=None):
        v, k = next(serial_calls)
        return apply_model(params, a_hat, x, koppen, c, train=train, masks=table[v][k])

    monkeypatch.setattr(maml, "apply_model", serial_apply)
    serial = maml.task_batch_grad(model, tasks, gen, cfg, meta)
    monkeypatch.setattr(fls, "_VBATCH", True)
    # The lockstep route draws one window's masks a task, task by task
    # within each step.
    lock_calls = iter([(k, v) for k in range(forwards) for v in range(nv)])

    def lockstep_draw(c, generator, x):
        k, v = next(lock_calls)
        return table[v][k]

    monkeypatch.setattr(maml, "draw_masks", lockstep_draw)
    lock = maml.task_batch_grad(model, tasks, gen, cfg, meta)
    assert next(lock_calls, None) is None and next(serial_calls, None) is None
    np.testing.assert_allclose(lock[0].numpy(), serial[0].numpy(), rtol=1e-12)
    for k, g in serial[1].items():
        np.testing.assert_allclose(lock[1][k].numpy(), g.numpy(), rtol=1e-10, atol=1e-13,
                                   err_msg=k)


def test_f32_meta_gradient_with_vbatch_matches_jax(vbatch, tiny_model_cfg):
    """One float32 FO meta-gradient (2 tasks, 1 x 2 inner steps, dropout 0)
    against JAX's with `_VBATCH` on in the interpreter: JAX's task vmap
    runs rows 16-17's Pallas bodies inside its whole meta step; the port
    runs its lockstep route."""
    jmc = dataclasses.replace(tiny_model_cfg, gcn_dropout=0.0, lstm_dropout=0.0,
                              lstm_kernel="pallas_stack", use_pallas_gcn=False)
    fields = {f.name for f in dataclasses.fields(tcfg.ModelConfig)}
    tmc = tcfg.ModelConfig(**{k: v for k, v in dataclasses.asdict(jmc).items() if k in fields})
    meta_kw = dict(second_order=False, inner_epochs=1, inner_batches=2, meta_batch=2,
                   grad_accum=1)
    jmeta, tmeta = jcfg.MetaConfig(**meta_kw), tcfg.MetaConfig(**meta_kw)
    nv, n = 2, 8
    rng = np.random.default_rng(7)
    mk = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    fields_np = dict(
        support_x=mk(nv, 2, jmc.window, n, jmc.feature_channels),
        support_y=mk(nv, 2, jmc.horizon, n, 12),
        query_x=mk(nv, 1, jmc.window, n, jmc.feature_channels),
        query_y=mk(nv, 1, jmc.horizon, n, 12),
        koppen=np.array([3, 5], np.int32),
        a_hat=np.stack([np.eye(n, dtype=np.float32)] * nv),
        node_mask=np.ones((nv, n), np.float32),
    )
    params = jax_maml.init_meta_state(jax.random.key(0), jmc, jmeta).params
    jtasks = jax_maml.Task(**{k: jnp.asarray(v) for k, v in fields_np.items()})
    rngs = jax.random.split(jax.random.key(2), nv)

    def mean_loss(p):
        return jax.vmap(lambda t, r: jax_maml.adapt_and_query_loss(p, t, r, jmc, jmeta))(
            jtasks, rngs).mean()

    with jax_fls.force_interpret():
        ref = state_dict_from_params(_np(jax.grad(mean_loss)(params)))
    model = init_model(torch.Generator().manual_seed(0), tmc)
    model.load_state_dict(state_dict_from_params(_np(params)))
    ttasks = Task(**{k: torch.from_numpy(v) for k, v in fields_np.items()})
    ttasks = ttasks._replace(koppen=ttasks.koppen.long())
    assert maml.lockstep_route(tmc, tmeta)
    _, got = maml.task_batch_grad(model, ttasks, None, tmc, tmeta)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), rtol=2e-4, atol=1e-6,
                                   err_msg=name)


def test_vbatch_taken_on_both_meshes(vbatch):
    """Under `_VBATCH` the engine on a dp x sp mesh takes the shardmap step
    and both mesh steps build: each runs a rank's tasks in lockstep
    (`lockstep_route`), the dp x sp one at the rank's node rows."""
    mc, meta = tcfg.ModelConfig(**MODEL), tcfg.MetaConfig()
    cfg = tcfg.ExperimentConfig(model=mc, meta=meta)
    assert meta_train._check_mesh(
        cfg, type("GridMesh", (), {"axis_names": ("dp", "sp")})()) == "shardmap"
    meta_sp.make_shardmap_meta_step_2d(mc, meta, type("OneRankMesh", (),
                                                      {"dp": 1, "sp_group": None})())
    assert meta_train._check_mesh(cfg, type("DpMesh", (), {"axis_names": ("dp",)})()) is None
    meta_dp.make_parallel_meta_step(mc, meta, type("OneRankMesh", (), {"dp": 1, "sp": 1,
                                                                        "size": 1})())
    assert maml.lockstep_route(mc, meta)


@pytest.mark.parametrize("override,meta_override", [
    (dict(family="stgcn"), {}),
    (dict(lstm_kernel="pallas"), {}),
    (dict(use_pallas_lstm=True), {}),
    (dict(lstm_dropout=0.3), dict(second_order=True)),
    (dict(lstm_dropout=0.3), "unmerged"),
    (dict(lstm_wavefront=True), {}),
])
def test_routes_without_merged_stack_launch_neither_row_16_nor_17(
        vbatch, monkeypatch, override, meta_override):
    """The routes with no merged stack (the wavefront among them) keep the
    serial route under `_VBATCH`: the task-batched stack (rows 16-17) is never called; the
    default route calls it once a forward (the control)."""
    if meta_override == "unmerged":
        monkeypatch.setattr(fls, "_MERGED_GATES", False)
        meta_override = {}
    calls = []
    real = hybrid.lstm_stack_train_tasks
    monkeypatch.setattr(hybrid, "lstm_stack_train_tasks",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    meta = tcfg.MetaConfig(meta_batch=2, grad_accum=1, inner_epochs=1, inner_batches=1,
                           **meta_override)
    base = {**MODEL, "compute_dtype": "float32"}
    tasks = stack_tasks([b.task for b in build_meta_tasks(
        _regions(True), tcfg.ModelConfig(**base), meta, tcfg.DataConfig())])
    for cfg, want in ((tcfg.ModelConfig(**{**base, **override}), 0),
                      (tcfg.ModelConfig(**base), 2)):
        if want and (meta.second_order or not fls._MERGED_GATES):
            continue
        calls.clear()
        model = init_model(torch.Generator().manual_seed(0), cfg)
        losses, grads = maml.task_batch_grad(model, tasks, torch.Generator().manual_seed(1),
                                             cfg, meta)
        assert len(calls) == want and maml.lockstep_route(cfg, meta) == bool(want)
        assert torch.isfinite(losses).all()


def test_convert_keeps_the_task_axis():
    """A JAX task-stacked tree (leading V axis, as jax.vmap sees it)
    converts leaf by leaf to the port's stacked leaves and back."""
    mc = jcfg.ModelConfig(**MODEL)
    trees = [_np(jax_maml.init_model(jax.random.key(v), mc)) for v in range(3)]
    stacked = jax.tree.map(lambda *a: np.stack(a), *trees)
    sd = state_dict_from_params(stacked)
    for v in range(3):
        single = state_dict_from_params(trees[v])
        for k, t in single.items():
            torch.testing.assert_close(sd[k][v], t, rtol=0, atol=0)
    back = params_from_state_dict(sd)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(stacked)):
        np.testing.assert_array_equal(a, b)
