"""The adaptation step's window batch under `_VBATCH` with `_ROWFOLD` off:
one window a task, the weights shared across the windows (kernel rows
16-17 on a card), on the CPU.

  * `run_adaptation` (two epochs of batch-2 steps) against the JAX
    package's with the same flags, float64, dropout 0 (1e-8), the
    task-batched stack called with V = 2 windows and weights broadcast with
    task stride 0;
  * one train step unfolded against the same step folded into the LSTM's
    rows (JAX's `_ROWFOLD` route), dropout on at every site, the same
    generator: float32 1e-5, float64 1e-12 (loss, every parameter after
    the update);
  * where the window batch stays folded: `_ROWFOLD` on, `_VBATCH` off, one
    window, the plain stack (`lstm_kernel="xla"`), the wavefront, and no
    plan for the windows' rows (float32 H 448, counted).
"""

import numpy as np
import pytest
import torch

import jax

from weatherforecast_stgcn_maml_tpu import config as jcfg
from tests._host_route import restore_host_routes, use_same_host_route
from weatherforecast_stgcn_maml_tpu.data.synthetic import synthetic_region_for_box as jax_box
from weatherforecast_stgcn_maml_tpu.engines import adapt as jax_adapt
from weatherforecast_stgcn_maml_tpu.models.registry import init_model as jax_init_model
from weatherforecast_stgcn_maml_tpu.ops import fused_lstm_stack as jax_fls
from weatherforecast_stgcn_maml_tpu.utils import checkpoint as jax_ckpt
from weatherforecast_stgcn_maml_tpu_torch import config as tcfg
from weatherforecast_stgcn_maml_tpu_torch.data.synthetic import synthetic_region_for_box
from weatherforecast_stgcn_maml_tpu_torch.engines import adapt
from weatherforecast_stgcn_maml_tpu_torch.models import hybrid as port_hybrid
from weatherforecast_stgcn_maml_tpu_torch.models.registry import init_model
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm_stack
from weatherforecast_stgcn_maml_tpu_torch.train.optimizers import adaptation_optimizer
from weatherforecast_stgcn_maml_tpu_torch.train.supervised import SupervisedState, make_train_step
from weatherforecast_stgcn_maml_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from weatherforecast_stgcn_maml_tpu_torch.utils.convert import state_dict_from_params

torch.set_num_threads(1)  # small tensors; more threads oversubscribe side-by-side workers

SMALL = dict(hidden_channels=16, gcn_layers=2, lstm_hidden=8, lstm_layers=3, window=6,
             horizon=3, koppen_dim=4)
BOX = (10.0, 11.0, 20.0, 21.0)  # 25 nodes, padded to 128


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture()
def tasks_calls(monkeypatch):
    """Every call of the task-batched stack from the model: (V, the
    weights' task stride)."""
    calls = []
    real = port_hybrid.lstm_stack_train_tasks

    def spy(x, wcat0, *args, **kwargs):
        calls.append((x.shape[0], wcat0.stride(0)))
        return real(x, wcat0, *args, **kwargs)

    monkeypatch.setattr(port_hybrid, "lstm_stack_train_tasks", spy)
    return calls


@pytest.fixture()
def unfolded(monkeypatch):
    monkeypatch.setattr(fused_lstm_stack, "_VBATCH", True)
    monkeypatch.setattr(fused_lstm_stack, "_ROWFOLD", False)


def _adapt_cfg(pkg, out_dir):
    return pkg.ExperimentConfig(
        model=pkg.ModelConfig(**SMALL, gcn_dropout=0.0, lstm_dropout=0.0,
                              compute_dtype="float64"),
        adapt=pkg.AdaptConfig(epochs=2, batch_size=2, max_samples=40),
        out_dir=str(out_dir),
    )


def test_unfolded_run_adaptation_matches_jax_float64(tmp_path, monkeypatch, unfolded,
                                                     tasks_calls):
    """Both packages with `_VBATCH` on and `_ROWFOLD` off (JAX's vmap over
    the windows reaches its task-batched rules; float64 runs its XLA scan):
    the epoch losses, val_mse and the adapted parameters (1e-8). Every
    2-window step runs the task-batched stack once, V = 2, its weights
    broadcast with task stride 0."""
    monkeypatch.setattr(jax_fls, "_VBATCH", True)
    monkeypatch.setattr(jax_fls, "_ROWFOLD", False)
    use_same_host_route()
    try:
        mc = jcfg.ModelConfig(**SMALL)
        params = _np(jax_init_model(jax.random.key(3), mc))
        meta = {"epoch": 0, "config": jcfg.to_dict(jcfg.ExperimentConfig(model=mc))}
        jax_path, port_path = str(tmp_path / "jax_meta"), str(tmp_path / "port_meta")
        jax_ckpt.save_checkpoint(jax_path, {"params": params}, meta)
        save_checkpoint(port_path, state_dict_from_params(params), meta)
        f64 = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
        monkeypatch.setattr(jax_adapt, "load_checkpoint",
                            lambda path, like=None: ({"params": f64}, {"epoch": 0}))
        with jax.enable_x64(True):
            ref = jax_adapt.run_adaptation(
                _adapt_cfg(jcfg, tmp_path / "jax"), BOX, "tiny", meta_ckpt=jax_path,
                region=jax_box(BOX, num_timesteps=48, seed=5, name="tiny"),
                log_cb=lambda *a: None)
            ref_params, _ = jax_ckpt.load_checkpoint(ref.ckpt_path)
            ref_sd = state_dict_from_params(_np(ref_params["params"]), np.float64)
    finally:
        restore_host_routes()
    got = adapt.run_adaptation(
        _adapt_cfg(tcfg, tmp_path / "port"), BOX, "tiny", device="cpu", meta_ckpt=port_path,
        region=synthetic_region_for_box(BOX, num_timesteps=48, seed=5, name="tiny"),
        log_cb=lambda *a: None)
    assert tasks_calls and set(tasks_calls) == {(2, 0)}
    tol = dict(rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(got.epoch_losses, ref.epoch_losses, **tol)
    np.testing.assert_allclose(got.val_mse, ref.val_mse, **tol)
    sd, _ = load_checkpoint(got.ckpt_path)
    for k, v in sd.items():
        np.testing.assert_allclose(v.numpy(), ref_sd[k].numpy(), err_msg=k, **tol)


def _train_step(dtype, folded, batch=2, **model_kw):
    """One adaptation step (the climate Adam) at dropout 0.2 on a batch of
    windows from a seeded generator: (loss, parameters after the update)."""
    mc = tcfg.ModelConfig(**{**SMALL, "gcn_dropout": 0.2, "lstm_dropout": 0.2,
                             "compute_dtype": dtype, **model_kw})
    model = init_model(torch.Generator().manual_seed(0), mc)
    if dtype == "float64":
        model = model.double()
    ftype = next(model.parameters()).dtype
    tx, lr = adaptation_optimizer("Moscow")
    state = SupervisedState(model, tx.init(dict(model.named_parameters())))
    draw = np.random.default_rng(7)
    n = 128
    x = torch.tensor(draw.normal(size=(batch, mc.window, n, 16)), dtype=ftype)
    y = torch.tensor(draw.normal(size=(batch, mc.horizon, n, 12)), dtype=ftype)
    a_hat = torch.tensor(draw.uniform(size=(n, n)) / n, dtype=ftype)
    node_mask = torch.tensor(draw.uniform(size=n) < 0.8, dtype=ftype)
    fused_lstm_stack._ROWFOLD = folded
    try:
        state, loss = make_train_step(mc, tx)(state, x, y, a_hat, node_mask, 3, lr,
                                              torch.Generator().manual_seed(5))
    finally:
        fused_lstm_stack._ROWFOLD = False
    return loss, dict(state.params.named_parameters())


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("float64", 1e-12)])
def test_unfolded_train_step_matches_folded(unfolded, tasks_calls, dtype, tol):
    """Dropout on at every site, the same generator (the masks are drawn a
    window at a time before the route is chosen, so both routes take the
    same ones): the unfolded step (rows 16-17's route, V = 2, stride-0
    weights, their gradients summed over the windows) against the folded
    one (rows 4-5's route at 2 x 128 rows), loss and every parameter after
    the update."""
    loss_u, params_u = _train_step(dtype, folded=False)
    assert tasks_calls == [(2, 0)]
    loss_f, params_f = _train_step(dtype, folded=True)
    assert tasks_calls == [(2, 0)]
    torch.testing.assert_close(loss_u, loss_f, rtol=tol, atol=tol)
    for name, p in params_u.items():
        torch.testing.assert_close(p, params_f[name], rtol=tol, atol=tol, msg=name)


@pytest.mark.parametrize("case", ["rowfold", "no _VBATCH", "one window", "lstm_kernel xla",
                                  "lstm_wavefront", "unplanned"])
def test_window_batch_stays_folded(monkeypatch, tasks_calls, case):
    """Where the window batch folds into the LSTM's rows: `_ROWFOLD` on,
    `_VBATCH` off, one window, the plain stack, the wavefront (no
    task-batched route), and where no cluster plan holds the windows' rows
    (float32 H 448: the fold then takes `auto`'s plain stack), counted in
    `window_batch_unfolded.folded_fallbacks`."""
    monkeypatch.setattr(fused_lstm_stack, "_VBATCH", case != "no _VBATCH")
    model_kw = {"lstm_kernel xla": dict(lstm_kernel="xla"),
                "lstm_wavefront": dict(lstm_wavefront=True),
                "unplanned": dict(lstm_hidden=448)}.get(case, {})
    before = port_hybrid.window_batch_unfolded.folded_fallbacks
    plain = fused_lstm_stack.lstm_stack_train.plain_routes
    loss, _ = _train_step("float32", folded=case == "rowfold",
                          batch=1 if case == "one window" else 2, **model_kw)
    assert tasks_calls == [] and np.isfinite(loss.item())
    fallbacks = port_hybrid.window_batch_unfolded.folded_fallbacks - before
    assert fallbacks == (1 if case == "unplanned" else 0)
    assert fused_lstm_stack.lstm_stack_train.plain_routes - plain == (
        1 if case == "unplanned" else 0)
