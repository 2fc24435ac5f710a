"""The port's LSTM kernel routes and the single GCN layer against the JAX
package, on the CPU.

  * the per-layer recurrence (kernel rows 18-19, `lstm_scan.lstm_recurrence`
    with `model.lstm_kernel="pallas"`), the eval stack (row 20,
    `fused_lstm.fused_lstm_last_hidden` with `model.use_pallas_lstm`) and
    the single GCN layer (row 3, `fused_gcn.fused_gcn_layer`): the port's
    plain versions against the Pallas bodies in the interpreter (float32)
    and their gradients against JAX autodiff (float64);
  * the whole hybrid on each route, eval and train mode, against JAX's
    `apply_hybrid` in float64 with JAX's dropout masks injected, and the
    route each takes;
  * a float64 FO meta step with `lstm_kernel="pallas"` against JAX's
    `make_meta_step`, and the SO meta-gradient on both routes for so_impl
    xla and fhvp against JAX (the second-order routes pin the plain LSTM:
    without `use_pallas_lstm=False` in `plain_route`, row 20's first-order
    Function would be differentiated twice and the xla case would raise);
  * `cli forecast -o model.use_pallas_lstm=true` and `cli meta-train -o
    model.lstm_kernel=pallas` in a fresh process that never imports jax.

On a CPU tensor the wrappers run their plain versions; the CUDA kernels are
held against those by tests/test_torch_port_cuda.py and chip_smoke.py.
Tolerances: float32 1e-5 (rtol = atol; summation order), float64 1e-10 on
single operators and the model, 1e-8 on a meta step or meta-gradient
through an inner loop (the same operations in another order).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from weatherforecast_stgcn_maml_tpu import config as jcfg
from tests._host_route import restore_host_routes, use_same_host_route
from weatherforecast_stgcn_maml_tpu.data.synthetic import synthetic_region_for_box as jax_box
from weatherforecast_stgcn_maml_tpu.graph import build_region_graph as jax_graph
from weatherforecast_stgcn_maml_tpu.models.hybrid import apply_hybrid as jax_apply_hybrid
from weatherforecast_stgcn_maml_tpu.models.lstm import init_lstm as jax_init_lstm
from weatherforecast_stgcn_maml_tpu.models.registry import init_model as jax_init_model
from weatherforecast_stgcn_maml_tpu.ops import fused_gcn as jax_fgcn
from weatherforecast_stgcn_maml_tpu.ops import fused_lstm as jax_flstm
from weatherforecast_stgcn_maml_tpu.ops import lstm_scan as jax_scan
from weatherforecast_stgcn_maml_tpu.train import maml as jax_maml
from weatherforecast_stgcn_maml_tpu.train import optimizers as jax_opt
from weatherforecast_stgcn_maml_tpu.train.tasks import build_meta_tasks as jax_build_meta_tasks
from weatherforecast_stgcn_maml_tpu.train.tasks import stack_tasks as jax_stack_tasks
from weatherforecast_stgcn_maml_tpu_torch import config as tcfg
from weatherforecast_stgcn_maml_tpu_torch.data.synthetic import synthetic_region_for_box
from weatherforecast_stgcn_maml_tpu_torch.models import hybrid as port_hybrid
from weatherforecast_stgcn_maml_tpu_torch.models.common import Dense
from weatherforecast_stgcn_maml_tpu_torch.models.lstm import init_lstm
from weatherforecast_stgcn_maml_tpu_torch.models.registry import apply_model, init_model
from weatherforecast_stgcn_maml_tpu_torch.ops import lstm_scan
from weatherforecast_stgcn_maml_tpu_torch.ops.fused_gcn import fused_gcn_layer
from weatherforecast_stgcn_maml_tpu_torch.ops.fused_lstm import fused_lstm_last_hidden
from weatherforecast_stgcn_maml_tpu_torch.train import maml
from weatherforecast_stgcn_maml_tpu_torch.train.so_fused import plain_route
from weatherforecast_stgcn_maml_tpu_torch.train.tasks import build_meta_tasks, stack_tasks, task_at
from weatherforecast_stgcn_maml_tpu_torch.utils.convert import state_dict_from_params

torch.set_num_threads(1)  # small tensors; more threads oversubscribe side-by-side workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = dict(rtol=1e-5, atol=1e-5)
F64 = dict(rtol=1e-10, atol=1e-12)
STEP = dict(rtol=1e-8, atol=1e-8)
SMALL = dict(hidden_channels=16, gcn_layers=2, lstm_hidden=8, lstm_layers=3, window=6,
             horizon=3, koppen_dim=4, compute_dtype="float64")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_f64(tree):
    return jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a), jnp.float64)
        if np.asarray(a).dtype == np.float32 else jnp.asarray(a), tree)


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# Rows 18-19: the per-layer recurrence
# ---------------------------------------------------------------------------


def _recurrence_grads(fn, xp, wh, ct):
    xp = xp.clone().requires_grad_(True)
    wh = wh.clone().requires_grad_(True)
    h_all = fn(xp, wh)
    return (h_all.detach().numpy(),
            *(g.numpy() for g in torch.autograd.grad(h_all, [xp, wh], ct)))


@pytest.mark.parametrize("hidden", [16, 128])
def test_recurrence_plain_matches_pallas_body(hidden):
    """lstm_recurrence_plain and its autograd against JAX's
    lstm_recurrence(kernel="pallas", interpret=True): the Pallas forward
    (h_all) and its custom VJP (the backward kernel's dgates = dxp, then
    dwh), float32."""
    t_len, b = 5, 8
    xp, wh = _normal(1, (t_len, b, 4 * hidden)), _normal(2, (hidden, 4 * hidden), 0.2)
    ct = _normal(3, (t_len, b, hidden))

    def jax_loss(xp_, wh_):
        h = jax_scan.lstm_recurrence(xp_, wh_, kernel="pallas", interpret=True)
        return jnp.sum(h * ct), h

    (_, ref), (ref_dxp, ref_dwh) = jax.value_and_grad(jax_loss, (0, 1), has_aux=True)(
        jnp.asarray(xp), jnp.asarray(wh))
    got = _recurrence_grads(lambda a, w: lstm_scan.lstm_recurrence(a, w), torch.from_numpy(xp),
                            torch.from_numpy(wh), torch.from_numpy(ct))
    for g, r in zip(got, (ref, ref_dxp, ref_dwh)):
        np.testing.assert_allclose(g, np.asarray(r), **F32)


def test_recurrence_plain_matches_xla_scan_float64():
    """The same against lstm_recurrence_xla under jax.grad, float64."""
    t_len, b, hidden = 6, 7, 12
    xp = np.random.default_rng(4).normal(size=(t_len, b, 4 * hidden))
    wh = np.random.default_rng(5).normal(size=(hidden, 4 * hidden)) * 0.3
    ct = np.random.default_rng(6).normal(size=(t_len, b, hidden))
    with jax.enable_x64(True):
        def jax_loss(xp_, wh_):
            h = jax_scan.lstm_recurrence_xla(xp_, wh_, compute_dtype=jnp.float64)
            return jnp.sum(h * ct), h

        (_, ref), grads = jax.value_and_grad(jax_loss, (0, 1), has_aux=True)(
            jnp.asarray(xp), jnp.asarray(wh))
        ref = [np.asarray(ref), *(np.asarray(g) for g in grads)]
    got = _recurrence_grads(
        lambda a, w: lstm_scan.lstm_recurrence(a, w, compute_dtype=torch.float64),
        torch.from_numpy(xp), torch.from_numpy(wh), torch.from_numpy(ct))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, **F64)


def test_recurrence_refuses_what_the_kernel_does_not_take():
    """On a tensor that is neither on the CPU nor on a card the wrapper
    raises instead of running the plain version."""
    xp = torch.zeros((2, 3, 16), device="meta")
    with pytest.raises(TypeError, match="no LSTM recurrence kernel"):
        lstm_scan.lstm_recurrence(xp, torch.zeros((4, 16), device="meta"))


# ---------------------------------------------------------------------------
# Row 20: the eval stack
# ---------------------------------------------------------------------------


def _lstm_pair(seed, c_in, hidden, layers, dtype=np.float32):
    jp = jax.tree.map(lambda a: np.asarray(a, dtype),
                      jax_init_lstm(jax.random.key(seed), c_in, hidden, layers))
    port = init_lstm(torch.Generator().manual_seed(0), c_in, hidden, layers)
    port = port.to(torch.float64) if dtype == np.float64 else port
    port.load_state_dict(state_dict_from_params(jp, dtype))
    return jp, port


def test_fused_lstm_plain_matches_pallas_body():
    """fused_lstm_last_hidden (its plain version on the CPU) against the
    Pallas body `_kernel` through `_pallas_forward` in the TPU interpreter,
    [16, 6, 128] with 2 layers of 128, float32."""
    jp, port = _lstm_pair(3, 128, 128, 2)
    x = _normal(7, (16, 6, 128))
    with pltpu.force_tpu_interpret_mode():
        ref = jax_flstm._pallas_forward(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                                        jnp.float32)
    with torch.no_grad():
        got = fused_lstm_last_hidden(port.layers, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


def test_fused_lstm_grad_matches_jax_float64():
    """Its backward (the plain layerwise route, differentiated) against
    jax.grad of JAX's fused_lstm_last_hidden (a custom VJP over its XLA
    route), float64, 3 layers."""
    c_in, hidden = 10, 8
    jp, port = _lstm_pair(4, c_in, hidden, 3, np.float64)
    x = np.random.default_rng(8).normal(size=(9, 5, c_in))
    ct = np.random.default_rng(9).normal(size=(9, hidden))
    with jax.enable_x64(True):
        def loss(p, xx):
            out = jax_flstm.fused_lstm_last_hidden(p, xx, compute_dtype=jnp.float64)
            return jnp.sum(out * ct), out

        (_, ref), (gp, gx) = jax.value_and_grad(loss, (0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
        ref_sd = state_dict_from_params(_np(gp), np.float64)
        gx = np.asarray(gx)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = fused_lstm_last_hidden(port.layers, xt, compute_dtype=torch.float64)
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **F64)
    np.testing.assert_allclose(xt.grad.numpy(), gx, **F64)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_sd[name].numpy(), err_msg=name, **F64)


# ---------------------------------------------------------------------------
# Row 3: the single GCN layer
# ---------------------------------------------------------------------------


def _a_hat():
    lats = np.arange(10.0, 11.0 + 1e-9, 0.25)
    lons = np.arange(20.0, 21.0 + 1e-9, 0.25)
    return jax_graph(lats, lons).a_hat  # 25 nodes padded to 128


def test_gcn_layer_plain_matches_pallas_body():
    """fused_gcn_layer (its plain version on the CPU) against the Pallas body
    `_kernel` through `_pallas_forward` in the TPU interpreter, h [2, 3, 128,
    16] -> 24 channels, float32."""
    a_hat = _a_hat()
    h, w, b = _normal(10, (2, 3, 128, 16)), _normal(11, (16, 24), 0.3), _normal(12, (24,))
    with pltpu.force_tpu_interpret_mode():
        ref = jax_fgcn._pallas_forward(jnp.asarray(w), jnp.asarray(b), jnp.asarray(a_hat),
                                       jnp.asarray(h), jnp.float32)
    layer = Dense(torch.from_numpy(w), torch.from_numpy(b))
    with torch.no_grad():
        got = fused_gcn_layer(layer, torch.from_numpy(a_hat), torch.from_numpy(h))
    assert got.shape == (2, 3, 128, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


def test_gcn_layer_grads_match_jax_float64():
    """dW, db and dh against jax.grad of JAX's fused_gcn_layer (its custom
    VJP: the relu gate, A_hat^T g, dh = (A_hat^T g) W^T, dW = h^T (A_hat^T
    g), db = sum g), float64."""
    a_hat = _a_hat()
    rng = np.random.default_rng(13)
    h, w, b = rng.normal(size=(5, 128, 16)), rng.normal(size=(16, 24)) * 0.3, rng.normal(size=24)
    ct = rng.normal(size=(5, 128, 24))
    with jax.enable_x64(True):
        def loss(p, hh):
            out = jax_fgcn.fused_gcn_layer(p, jnp.asarray(a_hat, jnp.float64), hh,
                                           compute_dtype=jnp.float64)
            return jnp.sum(out * ct), out

        (_, ref), (gp, gh) = jax.value_and_grad(loss, (0, 1), has_aux=True)(
            {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(h))
        ref_g = {"w": np.asarray(gp["w"]), "b": np.asarray(gp["b"]), "h": np.asarray(gh)}
    layer = Dense(torch.from_numpy(w), torch.from_numpy(b))
    ht = torch.from_numpy(h).requires_grad_(True)
    out = fused_gcn_layer(layer, torch.from_numpy(a_hat).double(), ht,
                          compute_dtype=torch.float64)
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **F64)
    for name, got in (("w", layer.w.grad), ("b", layer.b.grad), ("h", ht.grad)):
        np.testing.assert_allclose(got.numpy(), ref_g[name], err_msg=name, **F64)


# ---------------------------------------------------------------------------
# The hybrid on each route
# ---------------------------------------------------------------------------


def _jax_masks(mc, rng, w, n):
    """The hybrid's masks JAX's XLA route draws from `rng`, as int8."""
    def draw(key, shape, rate):
        return np.asarray(jax.random.bernoulli(key, 1.0 - rate, shape)).astype(np.int8)

    enc_rng, lstm_rng, head_rng = jax.random.split(rng, 3)
    masks = {"encoder": np.stack([
        draw(jax.random.fold_in(enc_rng, l), (w, n, mc.hidden_channels), mc.gcn_dropout)
        for l in range(mc.gcn_layers - 1)])}
    if mc.lstm_dropout > 0:
        masks["lstm"] = np.stack([
            draw(jax.random.fold_in(lstm_rng, l), (w, n, mc.lstm_hidden), mc.lstm_dropout)
            for l in range(mc.lstm_layers - 1)])
        masks["head"] = draw(head_rng, (n, mc.lstm_hidden), mc.lstm_dropout)
    return masks


ROUTES = {  # (config, train, the route the port must take: row 20 or not)
    "use_pallas_lstm eval": (dict(use_pallas_lstm=True), False, True),
    "use_pallas_lstm train dropout 0": (dict(use_pallas_lstm=True, lstm_dropout=0.0), True, True),
    "use_pallas_lstm train dropout 0.2": (dict(use_pallas_lstm=True, lstm_dropout=0.2), True,
                                          False),
    "lstm_kernel pallas eval": (dict(lstm_kernel="pallas"), False, False),
    "lstm_kernel pallas train": (dict(lstm_kernel="pallas", lstm_dropout=0.2), True, False),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_hybrid_route_matches_jax_float64(route, monkeypatch):
    """The whole hybrid (forward and every gradient) against JAX's
    apply_hybrid with the same flags, float64, JAX's masks injected; row 20
    is taken exactly where JAX takes it (`use_pallas_lstm` and (eval or
    lstm_dropout == 0))."""
    flags, train, row20 = ROUTES[route]
    # The plain encoder: the eval GCN stack (row 1) has no backward.
    kw = dict(SMALL, gcn_dropout=0.2, use_pallas_gcn=False, **flags)
    mc = jcfg.ModelConfig(**kw)
    a_hat = _a_hat()
    x = np.random.default_rng(14).normal(size=(6, 128, 16))
    ct = np.random.default_rng(15).normal(size=(3, 128, 12))
    rng = jax.random.key(6)
    with jax.enable_x64(True):
        jp = _jax_f64(jax_init_model(jax.random.key(1), mc))

        def loss(p):
            out = jax_apply_hybrid(p, jnp.asarray(a_hat, jnp.float64), jnp.asarray(x),
                                   jnp.int32(3), mc, train=train, rng=rng if train else None)
            return jnp.sum(out * ct), out

        (_, ref), ref_g = jax.value_and_grad(loss, has_aux=True)(jp)
        ref_sd = state_dict_from_params(_np(ref_g), np.float64)
        masks = _jax_masks(mc, rng, 6, 128) if train else None
        params_sd = state_dict_from_params(_np(jp), np.float64)

    calls = []
    monkeypatch.setattr(port_hybrid, "fused_lstm_last_hidden",
                        lambda *a, **k: calls.append(1) or fused_lstm_last_hidden(*a, **k))
    tmc = tcfg.ModelConfig(**kw)
    model = init_model(torch.Generator().manual_seed(0), tmc).double()
    model.load_state_dict(params_sd)
    out = apply_model(model, torch.from_numpy(a_hat).double(), torch.from_numpy(x), 3, tmc,
                      train=train,
                      masks=None if masks is None else {k: torch.from_numpy(v)
                                                        for k, v in masks.items()})
    (out * torch.from_numpy(ct)).sum().backward()
    assert bool(calls) == row20
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **F64)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_sd[name].numpy(), err_msg=name, **F64)


def test_lstm_wavefront_serves_as_the_layerwise_stack():
    """`model.lstm_wavefront` in eval mode (forecast, validate) runs the
    wavefront LSTM whatever `lstm_kernel` says: the same forecast as the
    plain layerwise stack, float64, 1e-12."""
    tmc = tcfg.ModelConfig(**SMALL, lstm_wavefront=True, lstm_kernel="pallas")
    model = init_model(torch.Generator().manual_seed(0), tmc).double()
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(6, 128, 16)))
    a_hat = torch.from_numpy(_a_hat()).double()
    with torch.no_grad():
        got = apply_model(model, a_hat, x, 2, tmc)
        ref = apply_model(model, a_hat, x, 2, dataclasses.replace(tmc, lstm_wavefront=False,
                                                                  lstm_kernel="xla"))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12, atol=1e-14)


def test_plain_route_pins_every_lstm_kernel():
    """The second-order routes' twice-differentiable config: no fused GCN,
    the plain LSTM stack, and not the row-20 stack."""
    cfg = plain_route(tcfg.ModelConfig(use_pallas_lstm=True, lstm_kernel="pallas"))
    assert (cfg.use_pallas_gcn, cfg.lstm_kernel, cfg.use_pallas_lstm) == (False, "xla", False)


# ---------------------------------------------------------------------------
# Meta-training on the routes
# ---------------------------------------------------------------------------


MODEL = dict(hidden_channels=8, gcn_layers=2, lstm_hidden=8, lstm_layers=2, window=6,
             horizon=2, koppen_dim=4, gcn_dropout=0.0, lstm_dropout=0.0,
             compute_dtype="float64")
META = dict(meta_batch=2, grad_accum=2, inner_epochs=1, inner_batches=2, query_batches=1)


@pytest.fixture()
def same_host_route():
    """Both packages on one host route (`tests/_host_route.py`)."""
    use_same_host_route()
    yield
    restore_host_routes()


def _regions(port, n):
    make = synthetic_region_for_box if port else jax_box
    return [make((10.0 + i, 10.5 + i, 20.0, 20.5), num_timesteps=40, seed=i) for i in range(n)]


def _setup(model_kw, meta_kw, n_tasks):
    kw, meta_kw = dict(MODEL, **model_kw), dict(META, **meta_kw)
    mc, meta = jcfg.ModelConfig(**kw), jcfg.MetaConfig(**meta_kw)
    with jax.enable_x64(True):
        tasks = _jax_f64(jax_stack_tasks([b.task for b in jax_build_meta_tasks(
            _regions(False, n_tasks), mc, meta, jcfg.DataConfig())]))
        params = _jax_f64(jax_maml.init_model(jax.random.key(0), mc))
    tmc, tmeta = tcfg.ModelConfig(**kw), tcfg.MetaConfig(**meta_kw)
    ptasks = stack_tasks([b.task for b in build_meta_tasks(
        _regions(True, n_tasks), tmc, tmeta, tcfg.DataConfig())])
    ptasks = type(ptasks)(*(f.double() if f.is_floating_point() else f for f in ptasks))
    model = init_model(torch.Generator().manual_seed(0), tmc).double()
    model.load_state_dict(state_dict_from_params(_np(params), np.float64))
    return (mc, meta, tasks, params), (tmc, tmeta, ptasks, model)


def test_fo_meta_step_on_the_recurrence_route_matches_jax_float64(same_host_route):
    """One FO meta step (2 tasks, grad-accum 2, the fused inner update) with
    lstm_kernel="pallas" on both sides, against JAX's make_meta_step."""
    (mc, meta, tasks, params), (tmc, tmeta, ptasks, model) = _setup(
        dict(lstm_kernel="pallas"), dict(fused_inner_update=True), 2)
    with jax.enable_x64(True):
        tx, _ = jax_opt.meta_optimizer(meta)
        state = jax_maml.MamlState(params, tx.init(params), jnp.zeros((), jnp.int32))
        ref_state, ref_m = jax.jit(jax_maml.make_meta_step(mc, meta))(
            state, tasks, jax.random.key(0))
        ref = state_dict_from_params(_np(ref_state.params), np.float64)
    state = maml.MamlState(model, maml.MetaOptimizer.init(dict(model.named_parameters())), 0)
    state, metrics = maml.make_meta_step(tmc, tmeta)(state, ptasks, None)
    np.testing.assert_allclose(metrics["per_task_loss"].numpy(),
                               np.asarray(ref_m["per_task_loss"]), **STEP)
    assert state.step == int(ref_state.step) == 2
    for name, p in state.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), err_msg=name, **STEP)


@pytest.mark.parametrize("impl", ["xla", "fhvp"])
@pytest.mark.parametrize("route", [dict(lstm_kernel="pallas"), dict(use_pallas_lstm=True)])
def test_so_meta_gradient_on_the_routes_matches_jax_float64(same_host_route, route, impl):
    """One task's SO meta-gradient (2 inner steps, dropout 0) against
    jax.grad of JAX's adapt_and_query_loss with second_order=True. JAX
    reroutes the twice-differentiated parts to its XLA routes
    (train/maml.py:155-172); the port's plain_route does the same, and
    without its use_pallas_lstm pin row 20's first-order Function would be
    differentiated twice here."""
    (mc, meta, tasks, params), (tmc, tmeta, ptasks, model) = _setup(
        route, dict(second_order=True, so_impl=impl), 1)
    with jax.enable_x64(True):
        task = jax.tree.map(lambda a: a[0], tasks)
        loss_ref, g_ref = jax.jit(jax.value_and_grad(
            lambda p: jax_maml.adapt_and_query_loss(p, task, jax.random.key(2), mc, meta)
        ))(params)
        g_ref = state_dict_from_params(_np(g_ref), np.float64)
    loss = maml.adapt_and_query_loss(model, task_at(ptasks, 0), None, tmc, tmeta)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(loss.item(), float(loss_ref), **STEP)
    for (name, _), g in zip(model.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), g_ref[name].numpy(), err_msg=name, **STEP)


def test_so_meta_gradient_refuses_row20_under_double_backward():
    """Row 20's Function is first order: the plain route is what keeps it
    out of the Hessian transpose."""
    lstm = init_lstm(torch.Generator().manual_seed(0), 6, 4, 2).double()
    x = torch.randn((3, 5, 6), dtype=torch.float64, requires_grad=True)
    out = fused_lstm_last_hidden(lstm.layers, x, compute_dtype=torch.float64)
    (gx,) = torch.autograd.grad(out.sum(), x, create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(gx.sum(), list(lstm.parameters()))


# ---------------------------------------------------------------------------
# The CLI, without jax
# ---------------------------------------------------------------------------


def test_cli_routes_leave_jax_unimported(tmp_path):
    """`cli meta-train -o model.lstm_kernel=pallas` then `cli forecast -o
    model.use_pallas_lstm=true` (and validate) at a small width, in a fresh
    process: both run, the forecast is finite, and neither imports jax."""
    small = ["model.hidden_channels=16", "model.gcn_layers=2", "model.lstm_hidden=8",
             "model.lstm_layers=2", "model.window=6", "model.horizon=3", "model.koppen_dim=4",
             "meta.inner_epochs=1", "meta.inner_batches=2", "data.synthetic_timesteps=40",
             f"out_dir={tmp_path}"]
    args = [a for o in small for a in ("-o", o)]
    code = (
        "import json, math, sys\n"
        "from weatherforecast_stgcn_maml_tpu_torch import cli\n"
        "from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm, lstm_scan\n"
        f"args = {args!r}\n"
        "assert cli.main(['meta-train', '--device', 'cpu', *args, '-o', 'meta.num_epochs=1',"
        " '-o', 'model.lstm_kernel=pallas']) == 0\n"
        "assert cli.main(['forecast', '--region', 'Moscow', '--device', 'cpu', *args,"
        " '-o', 'model.use_pallas_lstm=true']) == 0\n"
        "assert cli.main(['validate', '--region', 'Moscow', '--device', 'cpu', '--no-plots',"
        " *args, '-o', 'model.use_pallas_lstm=true']) == 0\n"
        f"fc = json.load(open({str(tmp_path / 'forecasts' / 'Moscow.json')!r}))\n"
        "assert all(math.isfinite(v) for row in fc['mean_forecast'] for v in row)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'jaxlib', "
        "'weatherforecast_stgcn_maml_tpu.')) for m in sys.modules), 'jax imported'\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
