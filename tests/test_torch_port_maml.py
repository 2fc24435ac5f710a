"""The port's first-order MAML pieces against the JAX package, on the CPU:
the whole-tree clip + SGD update (rows 8-9) against the Pallas bodies in
the interpreter, the meta optimizer (clip, schedule, AdamW), task building,
the difficulty sampler, and one whole FO meta step in float64 against
`make_meta_step`, with the per-leaf and the fused inner update (also from a
JAX mid-run optimizer state brought over by
`utils/convert.opt_state_from_optax`); the chained meta step against k
single steps (bitwise).

Tolerances: float64 1e-8 (rtol = atol) on the meta step (the same
operations in another summation order), 1e-12 on the optimizer alone, and
float32 1e-6 on the float32 schedule and the clip + SGD update (a last-bit
difference of cos/log, of the norm's summation order).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from weatherforecast_stgcn_maml_tpu import config as jcfg
from tests._host_route import restore_host_routes, use_same_host_route
from weatherforecast_stgcn_maml_tpu.data.synthetic import synthetic_region_for_box as jax_box
from weatherforecast_stgcn_maml_tpu.ops import fused_sgd as jax_fused_sgd
from weatherforecast_stgcn_maml_tpu.train import maml as jax_maml
from weatherforecast_stgcn_maml_tpu.train import optimizers as jax_opt
from weatherforecast_stgcn_maml_tpu.train.sampling import DifficultySampler as JaxSampler
from weatherforecast_stgcn_maml_tpu.train.tasks import build_meta_tasks as jax_build_meta_tasks
from weatherforecast_stgcn_maml_tpu.train.tasks import stack_tasks as jax_stack_tasks
from weatherforecast_stgcn_maml_tpu_torch import config as tcfg
from weatherforecast_stgcn_maml_tpu_torch.data.synthetic import synthetic_region_for_box
from weatherforecast_stgcn_maml_tpu_torch.models.registry import init_model
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_sgd
from weatherforecast_stgcn_maml_tpu_torch.train import maml, optimizers
from weatherforecast_stgcn_maml_tpu_torch.train.sampling import DifficultySampler
from weatherforecast_stgcn_maml_tpu_torch.train.tasks import (
    build_meta_tasks,
    select_tasks,
    stack_tasks,
)
from weatherforecast_stgcn_maml_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_opt_state,
    save_checkpoint,
)
from weatherforecast_stgcn_maml_tpu_torch.utils.convert import (
    opt_state_from_optax,
    params_from_state_dict,
    state_dict_from_params,
)

torch.set_num_threads(1)  # small tensors; more threads oversubscribe side-by-side workers

MODEL = dict(hidden_channels=16, gcn_layers=2, lstm_hidden=8, lstm_layers=2, window=6,
             horizon=3, koppen_dim=4, gcn_dropout=0.0, lstm_dropout=0.0,
             compute_dtype="float64")
META = dict(meta_batch=2, grad_accum=2, inner_epochs=2, inner_batches=2,
            fused_inner_update=False)


@pytest.fixture()
def same_host_route():
    """Both packages on one host route (`tests/_host_route.py`)."""
    use_same_host_route()
    yield
    restore_host_routes()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _grad_tree(seed, scale):
    rng = np.random.default_rng(seed)
    params = _np(jax_maml.init_model(jax.random.key(0), jcfg.ModelConfig(**MODEL)))
    return jax.tree.map(lambda a: rng.normal(size=a.shape) * scale, params)


@pytest.mark.parametrize("scale", [1e-3, 1.0])
def test_clip_global_norm_matches_jax(scale):
    """Below max_norm (untouched) and above it (scaled by max/(norm+1e-6))."""
    grads = _grad_tree(1, scale)
    with jax.enable_x64(True):
        ref, ref_norm = jax_opt.clip_global_norm_tree(jax.tree.map(jnp.asarray, grads), 1.0)
        ref = state_dict_from_params(_np(ref), np.float64)
    got, norm = optimizers.clip_global_norm_tree(state_dict_from_params(grads, np.float64), 1.0)
    np.testing.assert_allclose(float(norm), float(ref_norm), rtol=1e-12)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-12, err_msg=k)


@pytest.mark.parametrize("tasks", [1, 3])
@pytest.mark.parametrize("scale", [1e-3, 10.0])
def test_clip_sgd_update_matches_pallas_body(tasks, scale):
    """Rows 8-9: the port's whole-tree clip + SGD (its plain version, what
    the CPU runs) against JAX's `clip_sgd_update` in the Pallas interpreter,
    unbatched (row 8's body) and under jax.vmap over a task axis (row 9's
    body, each task clipped by its own norm); norms below and above 1.0.
    Float32."""
    rng = np.random.default_rng(3)
    params = _np(jax_maml.init_model(jax.random.key(0), jcfg.ModelConfig(**MODEL)))
    names = sorted(state_dict_from_params(params), key=optimizers.leaf_order)
    leaves = jax.tree.leaves(params)  # the same order as `names`
    shape = (tasks,) if tasks > 1 else ()
    p = [rng.normal(size=shape + a.shape).astype(np.float32) for a in leaves]
    # Task v's gradients scaled by 1 + v: with 3 tasks, clipping differs per task.
    g = [(rng.normal(size=shape + a.shape) * scale
          * (1 + np.arange(tasks)).reshape(shape + (1,) * a.ndim)).astype(np.float32)
         for a in leaves]

    def jax_update(pp, gg):
        return jax_fused_sgd.clip_sgd_update(pp, gg, 0.01, 1.0)

    with jax_fused_sgd.force_interpret():
        fn = jax.vmap(jax_update) if tasks > 1 else jax_update
        ref = fn([jnp.asarray(a) for a in p], [jnp.asarray(a) for a in g])
    got = [torch.from_numpy(a.copy()) for a in p]
    fused_sgd.clip_sgd_update(got, [torch.from_numpy(a) for a in g], 0.01, 1.0,
                              batched=tasks > 1)
    assert len(names) == len(got)
    for name, a, r in zip(names, got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-6, atol=1e-7, err_msg=name)


def test_clip_sgd_update_refuses_what_it_does_not_take():
    p = [torch.zeros(3)]
    with pytest.raises(ValueError, match="gradient"):
        fused_sgd.clip_sgd_update(p, [torch.zeros(4)], 0.1, 1.0)
    with pytest.raises(TypeError, match="Python numbers"):
        fused_sgd.clip_sgd_update(p, [torch.zeros(3)], torch.tensor(0.1), 1.0)
    with pytest.raises(RuntimeError, match="first-order"):
        fused_sgd.clip_sgd_update(p, [torch.zeros(3, requires_grad=True)], 0.1, 1.0)
    with pytest.raises(ValueError, match="task axis"):
        fused_sgd.clip_sgd_update([torch.zeros(3), torch.zeros(2, 3)],
                                  [torch.zeros(3), torch.zeros(2, 3)], 0.1, 1.0, batched=True)


@pytest.mark.parametrize("t_mult", [1, 2])
def test_cosine_warm_restarts_matches_jax(t_mult):
    port = optimizers.cosine_warm_restarts(1e-3, 10, t_mult, 1e-6, steps_per_epoch=2)
    ref = jax_opt.cosine_warm_restarts(1e-3, 10, t_mult, 1e-6, steps_per_epoch=2)
    steps = np.arange(0, 200)
    np.testing.assert_allclose([port(int(s)) for s in steps],
                               [float(ref(s)) for s in steps], rtol=1e-6)


def test_meta_optimizer_matches_optax_float64():
    """Three clip + AdamW updates against optax's chain."""
    cfg = jcfg.MetaConfig()
    params = _grad_tree(2, 0.1)
    with jax.enable_x64(True):
        tx, _ = jax_opt.meta_optimizer(cfg)
        p = jax.tree.map(jnp.asarray, params)
        state = tx.init(p)
        for i in range(3):
            updates, state = tx.update(jax.tree.map(jnp.asarray, _grad_tree(10 + i, 0.5)),
                                       state, p)
            p = optax.apply_updates(p, updates)
        ref = state_dict_from_params(_np(p), np.float64)
    opt = optimizers.MetaOptimizer(tcfg.MetaConfig())
    got = state_dict_from_params(params, np.float64)
    st = opt.init(got)
    for i in range(3):
        st = opt.update(state_dict_from_params(_grad_tree(10 + i, 0.5), np.float64), st, got)
    assert st.count == 3
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-12, atol=1e-15, err_msg=k)


def _regions(port):
    make = synthetic_region_for_box if port else jax_box
    return [make((10.0 + i, 10.5 + i, 20.0, 20.5), num_timesteps=40, seed=i) for i in range(2)]


def test_build_meta_tasks_matches_jax(same_host_route):
    mc, meta = jcfg.ModelConfig(**MODEL), jcfg.MetaConfig(**META)
    ref = jax_build_meta_tasks(_regions(False), mc, meta, jcfg.DataConfig())
    got = build_meta_tasks(_regions(True), tcfg.ModelConfig(**MODEL), tcfg.MetaConfig(**META),
                           tcfg.DataConfig())
    assert [b.region_name for b in got] == [b.region_name for b in ref]
    for g, r in zip(got, ref):
        for name in r.task._fields:
            np.testing.assert_array_equal(getattr(g.task, name).numpy(),
                                          np.asarray(getattr(r.task, name)), err_msg=name)
        np.testing.assert_array_equal(g.stats.mean, r.stats.mean)


def test_difficulty_sampler_draws_as_jax():
    port, ref = DifficultySampler(7, 3, seed=5), JaxSampler(7, 3, seed=5)
    losses = np.random.default_rng(0)
    for _ in range(6):
        idx = port.sample()
        np.testing.assert_array_equal(idx, ref.sample())
        per = losses.random(3)
        port.update(idx, per)
        ref.update(idx, per)
    np.testing.assert_array_equal(port.difficulty, ref.difficulty)


def _jax_f64(tree):
    return jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a), jnp.float64)
        if np.asarray(a).dtype == np.float32 else jnp.asarray(a), tree)


def _adam_state(opt_state):
    return next(s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def _check_step(got_state, got_metrics, ref_state, ref_metrics):
    tol = dict(rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(got_metrics["per_task_loss"].numpy(),
                               np.asarray(ref_metrics["per_task_loss"]), **tol)
    np.testing.assert_allclose(float(got_metrics["meta_loss"]),
                               float(ref_metrics["meta_loss"]), **tol)
    np.testing.assert_allclose(got_metrics["learning_rate"],
                               float(ref_metrics["learning_rate"]), **tol)
    assert got_state.step == int(ref_state.step)
    ref = state_dict_from_params(_np(ref_state.params), np.float64)
    for name, p in got_state.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), err_msg=name, **tol)


def test_fo_meta_step_matches_jax_float64(same_host_route):
    """Two tasks, grad-accum 2 (two AdamW updates), 2 x 2 inner steps,
    dropout 0, the per-leaf clip + SGD; then one more step from JAX's
    mid-run state."""
    _check_meta_steps(META)


def test_fo_meta_step_fused_update_matches_jax_float64(same_host_route):
    """The same with `fused_inner_update` on, the default, on both sides:
    the port's whole-tree clip + SGD (its plain version on the CPU)."""
    _check_meta_steps({**META, "fused_inner_update": True})


def _check_meta_steps(meta_kw):
    mc, meta = jcfg.ModelConfig(**MODEL), jcfg.MetaConfig(**meta_kw)
    tmc, tmeta = tcfg.ModelConfig(**MODEL), tcfg.MetaConfig(**meta_kw)
    with jax.enable_x64(True):
        tasks = _jax_f64(jax_stack_tasks(
            [b.task for b in jax_build_meta_tasks(_regions(False), mc, meta, jcfg.DataConfig())]))
        tx, _ = jax_opt.meta_optimizer(meta)
        params = _jax_f64(jax_maml.init_model(jax.random.key(0), mc))
        ref_state = jax_maml.MamlState(params, tx.init(params), jnp.zeros((), jnp.int32))
        step = jax.jit(jax_maml.make_meta_step(mc, meta))
        ref_states = [ref_state]
        ref_metrics = []
        for e in range(2):
            s, m = step(ref_states[-1], tasks, jax.random.key(e))
            ref_states.append(s)
            ref_metrics.append(m)
        snapshots = [(state_dict_from_params(_np(s.params), np.float64),
                      opt_state_from_optax(_np(_adam_state(s.opt_state)), np.float64),
                      int(s.step)) for s in ref_states[:2]]

    port_tasks = stack_tasks([b.task for b in build_meta_tasks(
        _regions(True), tmc, tmeta, tcfg.DataConfig())])
    port_tasks = type(port_tasks)(*(f.double() if f.is_floating_point() else f
                                    for f in port_tasks))
    meta_step = maml.make_meta_step(tmc, tmeta)
    for e, (params_sd, opt_state, n) in enumerate(snapshots):
        model = init_model(torch.Generator().manual_seed(0), tmc).double()
        model.load_state_dict(params_sd)
        state = maml.MamlState(model, opt_state, n)
        state, metrics = meta_step(state, port_tasks, None)
        _check_step(state, metrics, ref_states[e + 1], ref_metrics[e])


@pytest.mark.parametrize("family", ["hybrid", "stgcn"])
def test_chained_meta_step_is_k_single_steps(family):
    """A chained call of three epochs is bitwise three single steps fed the
    same indices and each epoch's generator (dropout on at every site, the
    fused inner update's plain version): metrics stacked on a leading [3]
    axis, the same parameters and step count; `fetch_metrics` brings the
    three epochs' losses over in one copy."""
    mc = tcfg.ModelConfig(**{**MODEL, "family": family, "gcn_dropout": 0.3,
                             "lstm_dropout": 0.3})
    meta = tcfg.MetaConfig(**{**META, "inner_epochs": 1, "fused_inner_update": True})
    pool = stack_tasks([b.task for b in build_meta_tasks(_regions(True), mc, meta,
                                                         tcfg.DataConfig())])
    pool = type(pool)(*(f.double() if f.is_floating_point() else f for f in pool))
    idx_k = np.array([[0, 1], [1, 0], [1, 1]])

    def gen(epoch):
        return torch.Generator().manual_seed(100 + epoch)

    step = maml.make_meta_step(mc, meta)
    seq = maml.init_meta_state(torch.Generator().manual_seed(0), mc, meta)
    losses = []
    for e in range(3):
        seq, m = step(seq, select_tasks(pool, idx_k[e]), gen(e))
        losses.append(m["per_task_loss"])
    chained = maml.init_meta_state(torch.Generator().manual_seed(0), mc, meta)
    chained, mk = maml.make_chained_meta_step(step, gen)(chained, pool, idx_k, range(3))
    assert mk["per_task_loss"].shape == (3, 2) and chained.step == seq.step == 6
    torch.testing.assert_close(mk["per_task_loss"], torch.stack(losses), rtol=0, atol=0)
    for (name, a), b in zip(chained.params.named_parameters(), seq.params.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    fetches = maml.fetch_metrics.fetches
    loss_k, per_task_k, lr_k = maml.fetch_metrics(mk)
    assert maml.fetch_metrics.fetches == fetches + 1
    np.testing.assert_array_equal(per_task_k, torch.stack(losses).numpy())
    np.testing.assert_array_equal(loss_k, per_task_k.mean(axis=1))
    assert lr_k.shape == (3,) and per_task_k.dtype == np.float64


def _meta_step_once(model_kw, meta_kw):
    """One meta step of two tasks at MODEL with dropout 0.2 at every site,
    seeded weights and a seeded generator: (per-task losses, the
    parameters after it)."""
    mc = tcfg.ModelConfig(**{**MODEL, "gcn_dropout": 0.2, "lstm_dropout": 0.2, **model_kw})
    meta = tcfg.MetaConfig(**{**META, "inner_epochs": 1, **meta_kw})
    regions = [synthetic_region_for_box((10.0 + i, 10.5 + i, 20.0, 20.5), num_timesteps=40,
                                        seed=i) for i in range(2)]
    tasks = stack_tasks([b.task for b in build_meta_tasks(regions, mc, meta,
                                                          tcfg.DataConfig())])
    tasks = type(tasks)(*(f.double() if f.is_floating_point() else f for f in tasks))
    state = maml.init_meta_state(torch.Generator().manual_seed(0), mc, meta)
    state, m = maml.make_meta_step(mc, meta)(state, tasks, torch.Generator().manual_seed(4))
    return m["per_task_loss"], dict(state.params.named_parameters())


def _assert_same_step(got, ref):
    torch.testing.assert_close(got[0], ref[0], rtol=1e-10, atol=1e-12)
    for name, p in got[1].items():
        torch.testing.assert_close(p, ref[1][name], rtol=1e-10, atol=1e-12, msg=name)


@pytest.mark.parametrize("override", [
    dict(second_order=True, so_impl="hvp", so_wavefront=True),
])
def test_so_wavefront_meta_step_matches_layerwise(override):
    """`meta.so_wavefront` (second order, hvp, dropout 0.2, two LSTM
    layers): the wavefront in the Hessian transposes takes the meta step
    the layerwise Hessian transposes take on the same masks (float64,
    1e-10)."""
    _assert_same_step(_meta_step_once({}, override),
                      _meta_step_once({}, {**override, "so_wavefront": False}))


@pytest.mark.parametrize("override", [dict(lstm_wavefront=True)])
def test_lstm_wavefront_meta_step_matches_layerwise(override):
    """`model.lstm_wavefront` (first order, dropout 0.2, two LSTM layers):
    the meta step the plain layerwise stack takes on the same masks
    (float64, 1e-10)."""
    _assert_same_step(_meta_step_once(override, {}),
                      _meta_step_once(dict(lstm_kernel="xla"), {}))


def test_meta_config_ignores_jax_only_knobs():
    """rng_impl and inner_unroll have no meaning in torch, and the so_*
    fields act only under second_order (off here): they parse and
    round-trip, and the meta step builds whatever they say."""
    cfg = tcfg.apply_overrides(tcfg.ExperimentConfig(), [
        "meta.rng_impl=threefry2x32", "meta.inner_unroll=4", "meta.so_impl=xla",
        "meta.so_remat=dots", "meta.so_wavefront=true", "meta.fused_inner_update=false",
    ])
    assert tcfg.experiment_from_dict(tcfg.to_dict(cfg)) == cfg
    maml.make_meta_step(cfg.model, cfg.meta)


def test_checkpoint_round_trips_optimizer_state(tmp_path):
    model = init_model(torch.Generator().manual_seed(0), tcfg.ModelConfig(**MODEL))
    st = optimizers.MetaOptimizer.init(dict(model.named_parameters()))
    st = optimizers.AdamState(7, {k: v + 1 for k, v in st.mu.items()}, st.nu)
    save_checkpoint(str(tmp_path / "c"), model.state_dict(), {"step": 7},
                    opt_state=st._asdict())
    params, meta = load_checkpoint(str(tmp_path / "c"))
    opt = load_opt_state(str(tmp_path / "c"))
    assert meta == {"step": 7} and opt["count"] == 7
    for k, v in st.mu.items():
        torch.testing.assert_close(opt["mu"][k], v.detach())
    assert params_from_state_dict(params).keys() == {"encoder", "lstm", "head", "koppen"}
    assert load_opt_state(str(tmp_path)) is None
