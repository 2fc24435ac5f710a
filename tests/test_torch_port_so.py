"""The port's second-order MAML against the JAX package, on the CPU.

  * the plain versions of kernel rows 10-11 (`hvp_fwd_plain`,
    `hvp_bwd_plain`) against the Pallas bodies of the R-operator kernels in
    the interpreter (jax.jvp of `hvp_stack_ops`), masks on and off, and
    against jax.jvp of JAX's autodiff in float64;
  * `make_grad_loss_fused` and its torch.func.jvp (the fhvp Hessian
    transpose) against jax.grad / jax.jvp(jax.grad) of the support loss,
    float64, JAX's dropout masks injected;
  * the SO meta-gradient for every `so_impl` and both families, and one SO
    meta step, against JAX in float64; a central-difference check; the
    refusals; `cli meta-train -o meta.second_order=true` leaving jax
    unimported.

On a CPU tensor the stack ops run their plain versions; the CUDA kernels are
held against those by tests/test_torch_port_cuda.py and chip_smoke.py.
Tolerances: float32 against the Pallas bodies, the JAX package's own
(row 10 primal 1e-5 / tangent 1e-4, row 11 1e-4 / 1e-3: summation order,
compounded once more by the tangent of a backward); float64 1e-10 on single
operators and 1e-8 on a meta-gradient through an inner loop (the same
operations in another order).
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

from weatherforecast_stgcn_maml_tpu import config as jcfg
from tests._host_route import restore_host_routes, use_same_host_route
from weatherforecast_stgcn_maml_tpu.data.synthetic import synthetic_region_for_box as jax_box
from weatherforecast_stgcn_maml_tpu.models.losses import masked_mse as jax_mse
from weatherforecast_stgcn_maml_tpu.models.registry import apply_model as jax_apply_model
from weatherforecast_stgcn_maml_tpu.ops import fused_lstm_hvp as jax_fh
from weatherforecast_stgcn_maml_tpu.train import maml as jax_maml
from weatherforecast_stgcn_maml_tpu.train import optimizers as jax_opt
from weatherforecast_stgcn_maml_tpu.train.tasks import build_meta_tasks as jax_build_meta_tasks
from weatherforecast_stgcn_maml_tpu.train.tasks import stack_tasks as jax_stack_tasks
from weatherforecast_stgcn_maml_tpu_torch import config as tcfg
from weatherforecast_stgcn_maml_tpu_torch.data.synthetic import synthetic_region_for_box
from weatherforecast_stgcn_maml_tpu_torch.models import hybrid as port_hybrid
from weatherforecast_stgcn_maml_tpu_torch.models.lstm import lstm_wavefront
from weatherforecast_stgcn_maml_tpu_torch.models.registry import init_model
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm_hvp as fh
from weatherforecast_stgcn_maml_tpu_torch.train import maml
from weatherforecast_stgcn_maml_tpu_torch.train.so_fused import make_grad_loss_fused
from weatherforecast_stgcn_maml_tpu_torch.train.tasks import build_meta_tasks, stack_tasks, task_at
from weatherforecast_stgcn_maml_tpu_torch.utils.convert import state_dict_from_params

torch.set_num_threads(1)  # small tensors; more threads oversubscribe side-by-side workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, B, C, H = 5, 16, 24, 8
KEEP = 0.75
MODEL = dict(hidden_channels=8, gcn_layers=2, lstm_hidden=8, lstm_layers=2, window=6,
             horizon=2, koppen_dim=4, gcn_dropout=0.0, lstm_dropout=0.0,
             compute_dtype="float64")
META = dict(meta_batch=2, grad_accum=2, inner_epochs=1, inner_batches=2, query_batches=1,
            second_order=True)


# ---------------------------------------------------------------------------
# Rows 10-11: the plain R-operator against the Pallas bodies and autodiff
# ---------------------------------------------------------------------------


def _stack_inputs(seed, layers, with_masks, dtype=np.float32):
    """Primals and tangents of the stack, numpy; wcat_r stacked as JAX's."""
    rng = np.random.default_rng(seed)

    def arr(shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(dtype)

    wr = (max(layers - 1, 1), 2 * H, 4 * H)
    p = dict(x=arr((T, B, C)), w0=arr((C + H, 4 * H), 0.3), wr=arr(wr, 0.3),
             b=arr((layers, 4 * H), 0.1))
    t = dict(x=arr((T, B, C)), w0=arr((C + H, 4 * H), 0.3), wr=arr(wr, 0.3),
             b=arr((layers, 4 * H), 0.1))
    g, tg = arr((B, H)), arr((B, H))
    masks = None
    if with_masks and layers > 1:
        masks = (rng.uniform(size=(layers - 1, T, B, H)) < KEEP).astype(np.int8)
    return p, t, g, tg, masks


def _port_r_ops(p, t, g, tg, masks, layers, dtype):
    """hvp_fwd_plain then hvp_bwd_plain: (forward outputs, their tangents,
    backward outputs [dx, dw0, dw1.., db], their tangents), as numpy."""
    tt = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    wcat = [tt(p["w0"])] + [tt(p["wr"][l]) for l in range(layers - 1)]
    twcat = [tt(t["w0"])] + [tt(t["wr"][l]) for l in range(layers - 1)]
    m = None if masks is None else tt(masks)
    keep = KEEP if masks is not None else 1.0
    (h_last, h_all, c_all, gates, th_last, th_all, tc_all, tgates) = fh.hvp_fwd_plain(
        tt(p["x"]), wcat, tt(p["b"]), m, keep, dtype, tt(t["x"]), twcat, tt(t["b"]))
    dx, dw, db, _, _, _, tdx, tdw, tdb = fh.hvp_bwd_plain(
        tt(g), tt(p["x"]), h_all, c_all, gates, wcat, m, keep, dtype,
        tt(tg), tt(t["x"]), th_all, tc_all, tgates, twcat)
    np_ = lambda xs: [a.numpy() for a in xs]  # noqa: E731
    return (np_([h_last, h_all, c_all]), np_([th_last, th_all, tc_all]),
            np_([dx, *dw, db]), np_([tdx, *tdw, tdb]))


def _split_jax_bwd(outs, layers):
    """JAX's (dx, dwcat0, dwcatr, db) as [dx, dw0, dw1.., db]."""
    dx, dw0, dwr, db = outs
    return [dx, dw0, *[dwr[l] for l in range(layers - 1)], db]


def _close(got, ref, rtol, atol):
    for i, (a, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(r), rtol=rtol, atol=atol,
                                   err_msg=str(i))


@pytest.mark.parametrize("layers,with_masks", [(3, True), (3, False), (1, False)])
def test_hvp_plain_matches_pallas_bodies(layers, with_masks):
    """(a) Rows 10-11's plain versions against `_hvpfwd_kernel_m` /
    `_hvpbwd_kernel_m` in the Pallas interpreter (jax.jvp of the custom_jvp
    stack ops), float32; layers 1 covers the backward's single-layer case."""
    p, t, g, tg, masks = _stack_inputs(0, layers, with_masks)
    keep = KEEP if masks is not None else 1.0
    fwd_op, bwd_op = jax_fh.hvp_stack_ops("float32", True, keep, masks is not None)
    extra = () if masks is None else (jnp.asarray(masks),)
    j = lambda d: tuple(jnp.asarray(d[k]) for k in ("x", "w0", "wr", "b"))  # noqa: E731
    with jax_fh.force_interpret():
        (h_last, h_all, c_all), (th_last, th_all, tc_all) = jax.jvp(
            lambda *a: fwd_op(*a, *extra), j(p), j(t))
        bprim = (jnp.asarray(g), j(p)[0], h_all, c_all, *j(p)[1:])
        btan = (jnp.asarray(tg), j(t)[0], th_all, tc_all, *j(t)[1:])
        bout, btout = jax.jvp(lambda *a: bwd_op(*a, *extra), bprim, btan)
    fwd, tfwd, bwd, tbwd = _port_r_ops(p, t, g, tg, masks, layers, torch.float32)
    _close(fwd, [h_last, h_all, c_all], 1e-5, 1e-5)
    _close(tfwd, [th_last, th_all, tc_all], 1e-4, 1e-4)
    _close(bwd, _split_jax_bwd(bout, layers), 1e-4, 1e-4)
    _close(tbwd, _split_jax_bwd(btout, layers), 1e-3, 1e-3)


def _jax_ref_stack(x, w0, wr, b2d, masks, layers):
    """JAX's merged-gates stack in plain jnp: (h_last, h_all, c_all)."""
    hidden = b2d.shape[1] // 4
    inp, hs_all, cs_all = x, [], []
    for l in range(layers):
        w = w0 if l == 0 else wr[l - 1]
        h = jnp.zeros((x.shape[1], hidden), x.dtype)
        c = jnp.zeros_like(h)
        hs, cs = [], []
        for s in range(x.shape[0]):
            gates = jnp.concatenate([inp[s], h], axis=1) @ w + b2d[l]
            i, f, o = (jax.nn.sigmoid(gates[:, k * hidden:(k + 1) * hidden]) for k in (0, 1, 3))
            c = f * c + i * jnp.tanh(gates[:, 2 * hidden:3 * hidden])
            h = o * jnp.tanh(c)
            hs.append(h)
            cs.append(c)
        hs_all.append(jnp.stack(hs))
        cs_all.append(jnp.stack(cs))
        inp = hs_all[-1]
        if l < layers - 1 and masks is not None:
            inp = inp * (masks[l].astype(x.dtype) * (1.0 / KEEP))
    return hs_all[-1][-1], jnp.stack(hs_all), jnp.stack(cs_all)


@pytest.mark.parametrize("layers,with_masks", [(3, True), (1, False)])
def test_hvp_plain_matches_autodiff_float64(layers, with_masks):
    """(b) The same against jax.jvp of JAX's own autodiff, float64: the
    forward's tangent, and the tangent of the VJP of h_last."""
    p, t, g, tg, masks = _stack_inputs(1, layers, with_masks, np.float64)
    m = None if masks is None else jnp.asarray(masks)
    with jax.enable_x64(True):
        j = lambda d: tuple(jnp.asarray(d[k]) for k in ("x", "w0", "wr", "b"))  # noqa: E731
        fwd = lambda *a: _jax_ref_stack(*a, m, layers)  # noqa: E731

        def grads(g_, *a):
            return jax.vjp(lambda *aa: fwd(*aa)[0], *a)[1](g_)

        out, tout = jax.jit(lambda a, b: jax.jvp(fwd, a, b))(j(p), j(t))
        bout, btout = jax.jit(lambda a, b: jax.jvp(grads, a, b))(
            (jnp.asarray(g), *j(p)), (jnp.asarray(tg), *j(t)))
        ref = [np.asarray(a) for a in (*out, *tout)]
        bref = [_split_jax_bwd([np.asarray(a) for a in o], layers) for o in (bout, btout)]
    fwd_got, tfwd_got, bwd_got, tbwd_got = _port_r_ops(p, t, g, tg, masks, layers, torch.float64)
    _close(fwd_got + tfwd_got, ref, 1e-10, 1e-12)
    _close(bwd_got, bref[0], 1e-10, 1e-12)
    _close(tbwd_got, bref[1], 1e-10, 1e-12)


# ---------------------------------------------------------------------------
# The fused gradient and its Hessian-vector product
# ---------------------------------------------------------------------------


@pytest.fixture()
def same_host_route():
    """Both packages on one host route (`tests/_host_route.py`)."""
    use_same_host_route()
    yield
    restore_host_routes()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_f64(tree):
    return jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a), jnp.float64)
        if np.asarray(a).dtype == np.float32 else jnp.asarray(a), tree)


def _regions(port, n=1):
    make = synthetic_region_for_box if port else jax_box
    return [make((10.0 + i, 10.5 + i, 20.0, 20.5), num_timesteps=40, seed=i) for i in range(n)]


def _jax_masks(mc, rng, w, n):
    """The hybrid's masks JAX's XLA route draws from `rng`, as int8."""
    def draw(key, shape, rate):
        return np.asarray(jax.random.bernoulli(key, 1.0 - rate, shape)).astype(np.int8)

    enc_rng, lstm_rng, head_rng = jax.random.split(rng, 3)
    return {
        "encoder": np.stack([draw(jax.random.fold_in(enc_rng, l), (w, n, mc.hidden_channels),
                                  mc.gcn_dropout) for l in range(mc.gcn_layers - 1)]),
        "lstm": np.stack([draw(jax.random.fold_in(lstm_rng, l), (w, n, mc.lstm_hidden),
                               mc.lstm_dropout) for l in range(mc.lstm_layers - 1)]),
        "head": draw(head_rng, (n, mc.lstm_hidden), mc.lstm_dropout),
    }


def _model(mc, params_sd):
    model = init_model(torch.Generator().manual_seed(0), mc).double()
    model.load_state_dict(params_sd)
    return model


def test_grad_loss_fused_and_its_hvp_match_jax_float64(same_host_route):
    """(c) make_grad_loss_fused (the plain stack ops on the CPU, through the
    same composition the card runs on its kernels) and torch.func.jvp of it
    against jax.grad / jax.jvp(jax.grad) of JAX's support loss, dropout on,
    JAX's masks injected; lstm_layers 3 so that two masks are live."""
    kw = dict(MODEL, lstm_layers=3, gcn_dropout=0.2, lstm_dropout=0.25)
    mc = jcfg.ModelConfig(**kw)
    rng = jax.random.key(7)
    with jax.enable_x64(True):
        task = _jax_f64(jax_build_meta_tasks(_regions(False), mc, jcfg.MetaConfig(**META),
                                             jcfg.DataConfig())[0].task)
        params = _jax_f64(jax_maml.init_model(jax.random.key(1), mc))
        aux = (task.support_x[0], task.support_y[0], task.a_hat, task.koppen, task.node_mask)

        def loss(p):
            preds = jax_apply_model(p, aux[2], aux[0], aux[3], mc, train=True, rng=rng)
            return jax_mse(preds, aux[1], aux[4])

        ct = jax.tree.map(lambda a: jnp.asarray(
            np.random.default_rng(3).normal(size=a.shape), jnp.float64), params)
        g_ref, hv_ref = jax.jit(lambda a, b: jax.jvp(jax.grad(loss), (a,), (b,)))(params, ct)
        g_ref = state_dict_from_params(_np(g_ref), np.float64)
        hv_ref = state_dict_from_params(_np(hv_ref), np.float64)
        w, n = aux[0].shape[:2]
        masks = {k: torch.from_numpy(v) for k, v in _jax_masks(mc, rng, w, n).items()}
        q = state_dict_from_params(_np(params), np.float64)
        t = state_dict_from_params(_np(ct), np.float64)
        taux = tuple(torch.from_numpy(np.array(a)) for a in aux)
    tmc = tcfg.ModelConfig(**kw)
    grad_loss = make_grad_loss_fused(_model(tmc, q), tmc)
    g_got = grad_loss(q, taux, masks)
    _, hv_got = torch.func.jvp(lambda p: grad_loss(p, taux, masks), (q,), (t,))
    for name in q:
        np.testing.assert_allclose(g_got[name].numpy(), g_ref[name].numpy(), rtol=1e-10,
                                   atol=1e-12, err_msg=name)
        np.testing.assert_allclose(hv_got[name].numpy(), hv_ref[name].numpy(), rtol=1e-10,
                                   atol=1e-12, err_msg=name)


# ---------------------------------------------------------------------------
# The SO meta-gradient and meta step
# ---------------------------------------------------------------------------


def _so_setup(family, n_tasks=1, meta_kw=None):
    meta_kw = dict(META, **(meta_kw or {}))
    kw = dict(MODEL, family=family)
    mc, meta = jcfg.ModelConfig(**kw), jcfg.MetaConfig(**meta_kw)
    with jax.enable_x64(True):
        tasks = _jax_f64(jax_stack_tasks([b.task for b in jax_build_meta_tasks(
            _regions(False, n_tasks), mc, meta, jcfg.DataConfig())]))
        params = _jax_f64(jax_maml.init_model(jax.random.key(0), mc))
    port_tasks = stack_tasks([b.task for b in build_meta_tasks(
        _regions(True, n_tasks), tcfg.ModelConfig(**kw), tcfg.MetaConfig(**meta_kw),
        tcfg.DataConfig())])
    port_tasks = type(port_tasks)(*(f.double() if f.is_floating_point() else f
                                    for f in port_tasks))
    return (mc, meta, tasks, params), (tcfg.ModelConfig(**kw), tcfg.MetaConfig(**meta_kw),
                                       port_tasks, state_dict_from_params(_np(params), np.float64))


@pytest.fixture(scope="module")
def so_reference():
    """`ref(family)`: (JAX's loss and SO meta-gradient of one task, 2 inner
    steps, dropout 0; the port's side of `_so_setup`), JAX's computed once
    a family, with `so_impl="hvp"` (every so_impl computes the same exact
    meta-gradient, as the JAX package's own tests hold; "hvp" compiles
    fastest on the CPU), on the port's host route (`tests/_host_route.py`)."""
    cache = {}

    def ref(family):
        if family not in cache:
            use_same_host_route()
            try:
                (mc, meta, tasks, params), port = _so_setup(family)
                meta = dataclasses.replace(meta, so_impl="hvp")
                with jax.enable_x64(True):
                    task = jax.tree.map(lambda a: a[0], tasks)
                    loss_ref, g_ref = jax.value_and_grad(
                        lambda p: jax_maml.adapt_and_query_loss(p, task, jax.random.key(2),
                                                                mc, meta))(params)
                    g_ref = state_dict_from_params(_np(g_ref), np.float64)
            finally:
                restore_host_routes()
            cache[family] = (float(loss_ref), g_ref, port)
        return cache[family]

    return ref


@pytest.mark.parametrize("family", ["hybrid", "stgcn"])
@pytest.mark.parametrize("impl", ["xla", "hvp", "rof", "fhvp"])
def test_so_meta_gradient_matches_jax_float64(so_reference, family, impl):
    """(d) One task's SO meta-gradient (2 inner steps, dropout 0) on each
    so_impl against jax.grad of JAX's adapt_and_query_loss with
    second_order=True (`so_reference`)."""
    loss_ref, g_ref, (tmc, tmeta, ptasks, sd) = so_reference(family)
    tmeta = dataclasses.replace(tmeta, so_impl=impl)
    model = _model(tmc, sd)
    loss = maml.adapt_and_query_loss(model, task_at(ptasks, 0), None, tmc, tmeta)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-8, atol=1e-8)
    for (name, _), g in zip(model.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), g_ref[name].numpy(), rtol=1e-8, atol=1e-8,
                                   err_msg=name)


@pytest.mark.parametrize("impl", ["hvp", "rof"])
def test_so_wavefront_meta_gradient_matches_jax_float64(so_reference, monkeypatch, impl):
    """(d) With `meta.so_wavefront` the hvp and rof Hessian transposes run the
    wavefront LSTM (once an inner step) and the inner gradients keep the
    model's route: the same exact meta-gradient against JAX's
    (`so_reference`, 1e-8)."""
    loss_ref, g_ref, (tmc, tmeta, ptasks, sd) = so_reference("hybrid")
    tmeta = dataclasses.replace(tmeta, so_impl=impl, so_wavefront=True)
    calls = []
    monkeypatch.setattr(port_hybrid, "lstm_wavefront",
                        lambda *a, **k: calls.append(1) or lstm_wavefront(*a, **k))
    model = _model(tmc, sd)
    loss = maml.adapt_and_query_loss(model, task_at(ptasks, 0), None, tmc, tmeta)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert len(calls) == tmeta.inner_epochs * tmeta.inner_batches
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-8, atol=1e-8)
    for (name, _), g in zip(model.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), g_ref[name].numpy(), rtol=1e-8, atol=1e-8,
                                   err_msg=name)


def test_so_meta_step_matches_jax_float64(same_host_route):
    """(e) One SO meta step (fhvp, 2 tasks, grad-accum 2: two AdamW updates)
    against JAX's make_meta_step."""
    (mc, meta, tasks, params), (tmc, tmeta, ptasks, sd) = _so_setup("hybrid", n_tasks=2)
    with jax.enable_x64(True):
        tx, _ = jax_opt.meta_optimizer(meta)
        state = jax_maml.MamlState(params, tx.init(params), jnp.zeros((), jnp.int32))
        ref_state, ref_m = jax.jit(jax_maml.make_meta_step(mc, meta))(
            state, tasks, jax.random.key(0))
        ref = state_dict_from_params(_np(ref_state.params), np.float64)
    model = _model(tmc, sd)
    state = maml.MamlState(model, maml.MetaOptimizer.init(dict(model.named_parameters())), 0)
    state, metrics = maml.make_meta_step(tmc, tmeta)(state, ptasks, None)
    tol = dict(rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(metrics["per_task_loss"].numpy(),
                               np.asarray(ref_m["per_task_loss"]), **tol)
    assert state.step == int(ref_state.step) == 2
    for name, p in state.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), err_msg=name, **tol)


def test_so_meta_gradient_matches_central_differences():
    """(f) The port's own SO meta-gradient (fhvp) against central
    differences of its query loss, float64, one coordinate in three leaves."""
    _, (tmc, tmeta, ptasks, sd) = _so_setup("hybrid")
    model = _model(tmc, sd)
    task = task_at(ptasks, 0)
    loss = maml.adapt_and_query_loss(model, task, None, tmc, tmeta)
    named = list(model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    pick = np.random.default_rng(0)
    for i in (0, len(named) // 2, len(named) - 1):
        p = named[i][1]
        idx = tuple(int(pick.integers(s)) for s in p.shape)
        eps = 1e-5

        def at(delta):
            with torch.no_grad():
                p[idx] += delta
            out = float(maml.adapt_and_query_loss(model, task, None, tmc, tmeta))
            with torch.no_grad():
                p[idx] -= delta
            return out

        fd = (at(eps) - at(-eps)) / (2 * eps)
        assert np.isclose(fd, float(grads[i][idx]), rtol=2e-5, atol=1e-9), (named[i][0], fd)


@pytest.mark.parametrize("override,err", [
    (dict(so_impl="hessian"), ValueError),
    (dict(so_remat="dot"), ValueError),
    (dict(so_remat="chunk:x"), ValueError),
])
def test_so_settings_refused(override, err):
    """(g) Unknown so_impl / so_remat raise ValueError naming the field."""
    cfg = tcfg.MetaConfig(**{**META, **override})
    with pytest.raises(err, match="so_impl|so_remat|so_wavefront"):
        maml.make_meta_step(tcfg.ModelConfig(**MODEL), cfg)


@pytest.mark.parametrize("remat", ["step", "dots", "none", "sqrt", "chunk:2"])
def test_so_remat_policies_give_the_same_meta_gradient(remat):
    """Every valid policy builds, and gives the default's numbers: the inner
    gradient's Function recomputes each step inside its backward."""
    _, (tmc, tmeta, ptasks, sd) = _so_setup("hybrid")
    out = []
    for policy in ("step", remat):
        model = _model(tmc, sd)
        cfg = dataclasses.replace(tmeta, so_remat=policy)
        loss = maml.adapt_and_query_loss(model, task_at(ptasks, 0), None, tmc, cfg)
        out.append(torch.autograd.grad(loss, list(model.parameters())))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_cli_so_meta_train_leaves_jax_unimported(tmp_path):
    """(h) A small `cli meta-train --device cpu -o meta.second_order=true`
    (float32, dropout on) in a fresh process: it trains, writes finite
    losses, and never imports jax or the JAX package."""
    small = ["model.hidden_channels=16", "model.gcn_layers=2", "model.lstm_hidden=8",
             "model.lstm_layers=2", "model.window=6", "model.horizon=3", "model.koppen_dim=4",
             "meta.inner_epochs=1", "meta.inner_batches=2", "data.synthetic_timesteps=40",
             "meta.second_order=true", "meta.num_epochs=2", f"out_dir={tmp_path}"]
    code = (
        "import json, math, sys\n"
        "from weatherforecast_stgcn_maml_tpu_torch import cli\n"
        f"args = {[a for o in small for a in ('-o', o)]!r}\n"
        "assert cli.main(['meta-train', '--device', 'cpu', *args]) == 0\n"
        f"log = [json.loads(l) for l in open({str(tmp_path / 'meta' / 'meta_log.jsonl')!r})]\n"
        "assert [r['epoch'] for r in log] == [1, 2], log\n"
        "assert all(math.isfinite(v) for r in log for v in [r['meta_loss'], *r['per_task_loss']])\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'jaxlib', "
        "'weatherforecast_stgcn_maml_tpu.')) for m in sys.modules), 'jax imported'\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
