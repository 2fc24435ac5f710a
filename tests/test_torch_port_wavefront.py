"""The wavefront LSTM (`model.lstm_wavefront`, `meta.so_wavefront`) against
the JAX package, on the CPU, float64.

  * `models/lstm.lstm_wavefront` against JAX's `apply_lstm_wavefront`
    (one, two and three layers; dropout 0 and 0.3 with JAX's layerwise
    masks, `bernoulli(fold_in(rng, l), keep, (T, B, H))`, injected):
    the output (1e-12), every gradient against jax.grad (1e-10), and the
    port's own layerwise stack on the same masks (1e-12); its Hessian-
    vector products by torch.func (jvp of grad, grad of jvp) against JAX's
    (1e-10): the clamped mask indices of lanes that have not started or
    have finished must not reach the gradient either;
  * the hybrid with `lstm_wavefront` in eval and train mode against JAX's
    `apply_hybrid` (1e-10), the route taken;
  * one FO meta step with `model.lstm_wavefront` against JAX's
    `make_meta_step`, and the SO meta-gradient with `so_wavefront` (so_impl
    hvp, rof) and with `model.lstm_wavefront` (xla) against JAX (1e-8);
  * `cli meta-train`, `forecast` and `validate` with `-o
    model.lstm_wavefront=true` at a small width.

Dropout 0 wherever a meta step compares with JAX (the port cannot draw
JAX's streams); the wavefront's masks are held above.
"""

import contextlib
import io
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from weatherforecast_stgcn_maml_tpu import config as jcfg
from tests._host_route import restore_host_routes, use_same_host_route
from weatherforecast_stgcn_maml_tpu.data.synthetic import synthetic_region_for_box as jax_box
from weatherforecast_stgcn_maml_tpu.graph import build_region_graph as jax_graph
from weatherforecast_stgcn_maml_tpu.models.hybrid import apply_hybrid as jax_apply_hybrid
from weatherforecast_stgcn_maml_tpu.models.lstm import apply_lstm_wavefront
from weatherforecast_stgcn_maml_tpu.models.lstm import init_lstm as jax_init_lstm
from weatherforecast_stgcn_maml_tpu.models.registry import init_model as jax_init_model
from weatherforecast_stgcn_maml_tpu.train import maml as jax_maml
from weatherforecast_stgcn_maml_tpu.train import optimizers as jax_opt
from weatherforecast_stgcn_maml_tpu.train.tasks import build_meta_tasks as jax_build_meta_tasks
from weatherforecast_stgcn_maml_tpu.train.tasks import stack_tasks as jax_stack_tasks
from weatherforecast_stgcn_maml_tpu_torch import cli
from weatherforecast_stgcn_maml_tpu_torch import config as tcfg
from weatherforecast_stgcn_maml_tpu_torch.data.synthetic import synthetic_region_for_box
from weatherforecast_stgcn_maml_tpu_torch.models import hybrid as port_hybrid
from weatherforecast_stgcn_maml_tpu_torch.models import lstm as port_lstm
from weatherforecast_stgcn_maml_tpu_torch.models.lstm import LSTM, LSTMLayer, lstm_wavefront
from weatherforecast_stgcn_maml_tpu_torch.models.registry import apply_model, init_model
from weatherforecast_stgcn_maml_tpu_torch.ops.fused_lstm_stack import lstm_stack_plain
from weatherforecast_stgcn_maml_tpu_torch.train import maml
from weatherforecast_stgcn_maml_tpu_torch.train.tasks import build_meta_tasks, stack_tasks, task_at
from weatherforecast_stgcn_maml_tpu_torch.utils.convert import state_dict_from_params

torch.set_num_threads(1)  # small tensors; more threads oversubscribe side-by-side workers

EXACT = dict(rtol=1e-12, atol=1e-14)
F64 = dict(rtol=1e-10, atol=1e-12)
STEP = dict(rtol=1e-8, atol=1e-8)
F64_T = torch.float64


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_f64(tree):
    return jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a), jnp.float64)
        if np.asarray(a).dtype == np.float32 else jnp.asarray(a), tree)


def _port_lstm(jparams):
    return LSTM([LSTMLayer(*(torch.tensor(np.asarray(layer[k])) for k in ("wx", "wh", "b")))
                 for layer in jparams["layers"]])


# ---------------------------------------------------------------------------
# models/lstm.lstm_wavefront
# ---------------------------------------------------------------------------

T_LEN, ROWS, C_IN, HIDDEN = 6, 7, 5, 8


def _wavefront_case(n_layers, rate):
    """JAX's params, x, cotangent, rng and its layerwise masks (int8, or
    None), float64."""
    draw = np.random.default_rng(n_layers)
    x = draw.normal(size=(ROWS, T_LEN, C_IN))
    ct = draw.normal(size=(ROWS, HIDDEN))
    rng = jax.random.key(3)
    with jax.enable_x64(True):
        params = _jax_f64(jax_init_lstm(jax.random.key(n_layers), C_IN, HIDDEN, n_layers))
        masks = None
        if rate > 0 and n_layers > 1:
            masks = np.stack([np.asarray(jax.random.bernoulli(
                jax.random.fold_in(rng, l), 1.0 - rate, (T_LEN, ROWS, HIDDEN))).astype(np.int8)
                for l in range(n_layers - 1)])
    return params, x, ct, rng, masks


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("n_layers", [1, 2, 3])
def test_wavefront_matches_jax_float64(n_layers, rate):
    """Output (1e-12) and every gradient (1e-10) against JAX's
    apply_lstm_wavefront with its own masks injected; the output against
    the port's layerwise stack on the same masks (1e-12)."""
    params, x, ct, rng, masks = _wavefront_case(n_layers, rate)
    with jax.enable_x64(True):
        def loss(p, x_):
            out = apply_lstm_wavefront(p, x_, dropout_rate=rate, train=True, rng=rng,
                                       compute_dtype=jnp.float64)
            return jnp.sum(out * ct), out

        (_, ref), (ref_gp, ref_gx) = jax.value_and_grad(loss, (0, 1), has_aux=True)(
            params, jnp.asarray(x))
    lstm = _port_lstm(params)
    xt = torch.tensor(x, requires_grad=True)
    m = None if masks is None else torch.from_numpy(masks)
    keep = 1.0 - rate
    out = lstm_wavefront(lstm, xt, masks=m, keep=keep, compute_dtype=F64_T)
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **EXACT)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_gx), **F64)
    for l, (layer, ref_layer) in enumerate(zip(lstm.layers, ref_gp["layers"])):
        for k in ("wx", "wh", "b"):
            np.testing.assert_allclose(getattr(layer, k).grad.numpy(), np.asarray(ref_layer[k]),
                                       err_msg=f"layer {l} {k}", **F64)
    with torch.no_grad():
        layerwise = lstm_stack_plain(lstm.layers, xt, F64_T, m, keep)
    np.testing.assert_allclose(out.detach().numpy(), layerwise.numpy(), **EXACT)


@pytest.mark.parametrize("how", ["jvp_of_grad", "grad_of_jvp"])
def test_wavefront_hessian_vector_products_match_jax_float64(how):
    """Three layers, dropout 0.3: H·v of the wavefront loss by torch.func
    (forward over reverse, and reverse over forward) against JAX's
    jax.jvp(jax.grad) of apply_lstm_wavefront (1e-10) and against the same
    transform of the port's layerwise stack (1e-10)."""
    params, x, ct, rng, masks = _wavefront_case(3, 0.3)
    tangent = jax.tree.map(lambda a: np.random.default_rng(a.size).normal(size=a.shape),
                           _np(params))
    with jax.enable_x64(True):
        def jloss(p):
            return jnp.sum(apply_lstm_wavefront(p, jnp.asarray(x), dropout_rate=0.3, train=True,
                                                rng=rng, compute_dtype=jnp.float64) * ct)

        _, ref = jax.jvp(jax.grad(jloss), (params,), (_jax_f64(tangent),))
    names = [(l, k) for l in range(3) for k in ("wx", "wh", "b")]
    q = {f"{l}.{k}": torch.tensor(np.asarray(params["layers"][l][k])) for l, k in names}
    v = {f"{l}.{k}": torch.tensor(tangent["layers"][l][k]) for l, k in names}
    m, xt, ctt = torch.from_numpy(masks), torch.tensor(x), torch.tensor(ct)

    def loss_of(fn):
        def loss(p):
            # Plain namespaces: an nn.Parameter would cut the transforms' graph.
            lstm = SimpleNamespace(layers=[SimpleNamespace(wx=p[f"{l}.wx"], wh=p[f"{l}.wh"],
                                                           b=p[f"{l}.b"]) for l in range(3)])
            return (fn(lstm, xt) * ctt).sum()
        return loss

    def hvp(loss):
        if how == "jvp_of_grad":
            return torch.func.jvp(torch.func.grad(loss), (q,), (v,))[1]
        return torch.func.grad(lambda p: torch.func.jvp(loss, (p,), (v,))[1])(q)

    got = hvp(loss_of(lambda lstm, x_: lstm_wavefront(lstm, x_, masks=m, keep=0.7,
                                                       compute_dtype=F64_T)))
    layerwise = hvp(loss_of(lambda lstm, x_: lstm_stack_plain(lstm.layers, x_, F64_T, m, 0.7)))
    for l, k in names:
        np.testing.assert_allclose(got[f"{l}.{k}"].numpy(), np.asarray(ref["layers"][l][k]),
                                   err_msg=f"{l}.{k}", **F64)
        np.testing.assert_allclose(got[f"{l}.{k}"].numpy(), layerwise[f"{l}.{k}"].numpy(),
                                   err_msg=f"{l}.{k}", **F64)


# ---------------------------------------------------------------------------
# The hybrid on the wavefront
# ---------------------------------------------------------------------------

SMALL = dict(hidden_channels=16, gcn_layers=2, lstm_hidden=8, lstm_layers=3, window=6,
             horizon=3, koppen_dim=4, compute_dtype="float64", lstm_wavefront=True)


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


@pytest.mark.parametrize("train", [False, True])
def test_hybrid_wavefront_matches_jax_float64(train, monkeypatch):
    """The hybrid with `lstm_wavefront` (forward and every gradient) against
    JAX's apply_hybrid, float64, JAX's masks injected (dropout 0.2 at every
    site in train mode): the wavefront runs whatever `lstm_kernel` says, in
    eval mode too, and the layerwise routes never."""
    kw = dict(SMALL, gcn_dropout=0.2, lstm_dropout=0.2, use_pallas_gcn=False)
    mc = jcfg.ModelConfig(**kw)
    a_hat = jax_graph(np.arange(10.0, 11.0 + 1e-9, 0.25), np.arange(20.0, 21.0 + 1e-9, 0.25)).a_hat
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

    calls = {"wavefront": 0, "layerwise": 0}

    def spy(name, fn):
        def counted(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return counted

    monkeypatch.setattr(port_hybrid, "lstm_wavefront", spy("wavefront", lstm_wavefront))
    monkeypatch.setattr(port_hybrid, "apply_lstm", spy("layerwise", port_hybrid.apply_lstm))
    tmc = tcfg.ModelConfig(**kw)
    model = init_model(torch.Generator().manual_seed(0), tmc).double()
    model.load_state_dict(params_sd)
    out = apply_model(model, torch.from_numpy(a_hat).double(), torch.from_numpy(x), 3, tmc,
                      train=train,
                      masks=None if masks is None else {k: torch.from_numpy(v)
                                                        for k, v in masks.items()})
    (out * torch.from_numpy(ct)).sum().backward()
    assert calls == {"wavefront": 1, "layerwise": 0}
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **F64)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_sd[name].numpy(), err_msg=name, **F64)


# ---------------------------------------------------------------------------
# Meta steps and meta-gradients
# ---------------------------------------------------------------------------

MODEL = dict(hidden_channels=8, gcn_layers=2, lstm_hidden=8, lstm_layers=3, window=6,
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


def _count_wavefront(monkeypatch):
    calls = []
    monkeypatch.setattr(port_hybrid, "lstm_wavefront",
                        lambda *a, **k: calls.append(1) or lstm_wavefront(*a, **k))
    return calls


def test_fo_meta_step_with_lstm_wavefront_matches_jax_float64(same_host_route, monkeypatch):
    """One FO meta step (2 tasks, grad-accum 2, the fused inner update) with
    `model.lstm_wavefront` on both sides against JAX's make_meta_step: every
    forward runs the wavefront."""
    (mc, meta, tasks, params), (tmc, tmeta, ptasks, model) = _setup(
        dict(lstm_wavefront=True), dict(fused_inner_update=True), 2)
    with jax.enable_x64(True):
        tx, _ = jax_opt.meta_optimizer(meta)
        state = jax_maml.MamlState(params, tx.init(params), jnp.zeros((), jnp.int32))
        ref_state, ref_m = jax.jit(jax_maml.make_meta_step(mc, meta))(
            state, tasks, jax.random.key(0))
        ref = state_dict_from_params(_np(ref_state.params), np.float64)
    calls = _count_wavefront(monkeypatch)
    state = maml.MamlState(model, maml.MetaOptimizer.init(dict(model.named_parameters())), 0)
    state, metrics = maml.make_meta_step(tmc, tmeta)(state, ptasks, None)
    assert len(calls) == 2 * (2 + 1)  # a task's 2 inner steps and its query window
    np.testing.assert_allclose(metrics["per_task_loss"].numpy(),
                               np.asarray(ref_m["per_task_loss"]), **STEP)
    for name, p in state.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), err_msg=name, **STEP)


@pytest.mark.parametrize("impl,model_kw,meta_kw", [
    ("hvp", {}, dict(so_wavefront=True)),
    ("rof", {}, dict(so_wavefront=True)),
    ("xla", dict(lstm_wavefront=True), {}),
], ids=["hvp-so_wavefront", "rof-so_wavefront", "xla-lstm_wavefront"])
def test_so_meta_gradient_on_the_wavefront_matches_jax_float64(same_host_route, monkeypatch,
                                                               impl, model_kw, meta_kw):
    """One task's SO meta-gradient (2 inner steps, three LSTM layers)
    against jax.grad of JAX's adapt_and_query_loss with the same flags
    (1e-8). `so_wavefront` puts the wavefront in the hvp / rof Hessian
    transposes only (once an inner step); `model.lstm_wavefront` runs it in
    every forward, twice differentiated by autograd under "xla"."""
    (mc, meta, tasks, params), (tmc, tmeta, ptasks, model) = _setup(
        model_kw, dict(second_order=True, so_impl=impl, **meta_kw), 1)
    with jax.enable_x64(True):
        task = jax.tree.map(lambda a: a[0], tasks)
        loss_ref, g_ref = jax.jit(jax.value_and_grad(
            lambda p: jax_maml.adapt_and_query_loss(p, task, jax.random.key(2), mc, meta)
        ))(params)
        g_ref = state_dict_from_params(_np(g_ref), np.float64)
    calls = _count_wavefront(monkeypatch)
    loss = maml.adapt_and_query_loss(model, task_at(ptasks, 0), None, tmc, tmeta)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    # so_wavefront: the Hessian transposes of the 2 inner steps; the model
    # flag: 2 inner gradients and the query loss.
    assert len(calls) == (3 if model_kw else 2)
    np.testing.assert_allclose(loss.item(), float(loss_ref), **STEP)
    for (name, _), g in zip(model.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), g_ref[name].numpy(), err_msg=name, **STEP)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def _cli(*argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(list(argv))
    return rc, out.getvalue(), err.getvalue()


def test_cli_meta_train_forecast_validate_on_the_wavefront(tmp_path, monkeypatch):
    """`meta-train`, `forecast` and `validate` with `-o
    model.lstm_wavefront=true` (small width, dropout 0.2): every command
    runs, through the wavefront, and reports finite numbers."""
    calls = []
    monkeypatch.setattr(port_hybrid, "lstm_wavefront",
                        lambda *a, **k: calls.append(1) or port_lstm.lstm_wavefront(*a, **k))
    small = ["model.hidden_channels=16", "model.gcn_layers=2", "model.lstm_hidden=8",
             "model.lstm_layers=2", "model.window=6", "model.horizon=3", "model.koppen_dim=4",
             "model.lstm_wavefront=true", "meta.inner_epochs=1", "meta.inner_batches=2",
             "data.synthetic_timesteps=40", f"out_dir={tmp_path}"]
    args = [a for o in small for a in ("-o", o)]
    rc, _, _ = _cli("meta-train", "--device", "cpu", *args, "-o", "meta.num_epochs=1")
    assert rc == 0 and calls
    with open(tmp_path / "meta" / "meta_log.jsonl") as f:
        assert np.isfinite(json.loads(f.readline())["meta_loss"])
    calls.clear()
    rc, _, _ = _cli("forecast", "--region", "Moscow", "--device", "cpu", *args)
    assert rc == 0 and calls
    with open(tmp_path / "forecasts" / "Moscow.json") as f:
        assert np.isfinite(json.load(f)["mean_forecast"]).all()
    calls.clear()
    rc, out, _ = _cli("validate", "--region", "Moscow", "--device", "cpu", "--no-plots", *args)
    assert rc == 0 and calls and np.isfinite(json.loads(out)["average_mse"])
