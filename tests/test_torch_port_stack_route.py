"""The LSTM stack's route under `lstm_kernel="auto"` where no cluster holds
Wh, on the CPU (16-block clusters hold it up to float32 H 396 and bfloat16
H 512; past that, float32 H 448, the recurrences' plans stream part of each
slice from L2).

  * `fused_lstm_stack.stack_planned` (the cluster plans of the training
    stack's recurrences) by width and dtype, and the route `apply_lstm`
    takes on it: `auto` in train mode runs the training kernels' entry where
    the plans hold and the plain stack where they do not, counted in
    `lstm_stack_train.plain_routes`; so does the eval forward, merged (row
    2) or not (row 14), where its recurrence has no plan (`eval_planned`);
  * the forced routes `pallas_stack` and `pallas` reach their kernels'
    entries at any width, on streamed plans past the clusters that hold Wh
    (on a card they launch them, tests/test_torch_port_cuda.py), while
    `stack_planned` stays False there;
  * `train/maml.lockstep_route` with a micro-batch of V = 2 tasks follows
    the same rule (`_VBATCH`);
  * a train step of the hybrid at hidden width 448 under `auto` (JAX's
    masks injected) against JAX's `apply_model` with `kernel="auto"`, whose
    CPU route is its XLA scan: float64 at 1e-8, and the float32 config,
    which takes the plain route by the decision, at float32's tolerance;
    and at 320, where the float32 config takes the training stack's entry;
    and the same step at 448 under the forced `pallas_stack` against JAX's
    forced `pallas_stack` route, its Pallas kernels in the interpreter (as
    JAX's tests run them on the CPU: `force_interpret`), float32 1e-5 and
    bfloat16 5e-2;
  * second order's fused gradient (`make_grad_loss_fused`) by the same
    rule: the plain loss's gradient where no plan holds Wh, as the JAX
    package takes jax.grad of its XLA loss where its R-kernels do not fit.

The CUDA entries are never reached here: a spy stands in for each.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from weatherforecast_stgcn_maml_tpu import config as jcfg
from weatherforecast_stgcn_maml_tpu.graph import build_region_graph as jax_graph
from weatherforecast_stgcn_maml_tpu.models.registry import apply_model as jax_apply_model
from weatherforecast_stgcn_maml_tpu.models.registry import init_model as jax_init_model
from weatherforecast_stgcn_maml_tpu.ops import fused_lstm_stack as jax_fls
from weatherforecast_stgcn_maml_tpu_torch import config as tcfg
from weatherforecast_stgcn_maml_tpu_torch.models import lstm as tlstm
from weatherforecast_stgcn_maml_tpu_torch.models.common import draw_mask
from weatherforecast_stgcn_maml_tpu_torch.models.registry import apply_model, draw_masks, init_model
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm_hvp
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm_stack as fls
from weatherforecast_stgcn_maml_tpu_torch.train import maml
from weatherforecast_stgcn_maml_tpu_torch.train.so_fused import (
    make_grad_loss_fused,
    plain_route,
    support_loss,
)
from weatherforecast_stgcn_maml_tpu_torch.utils.convert import state_dict_from_params

torch.set_num_threads(1)  # small tensors; more threads oversubscribe side-by-side workers

CPU = torch.device("cpu")
T, B, C, KEEP = 3, 4, 8, 0.8
# (compute dtype, hidden width, planned): float32 plans up to 392, bfloat16
# up to 512, 16-block clusters past float32 256 and bfloat16 384 (PERF.md;
# `_cluster_plan`).
WIDTHS = [(torch.float32, 128, True), (torch.float32, 256, True), (torch.float32, 448, False),
          (torch.float32, 512, False), (torch.bfloat16, 384, True), (torch.bfloat16, 640, False),
          (torch.float32, 320, True), (torch.float32, 384, True), (torch.bfloat16, 448, True),
          (torch.bfloat16, 512, True)]


def _stack(hidden, layers=2, seed=0):
    return tlstm.init_lstm(torch.Generator().manual_seed(seed), C, hidden, layers)


def _spy(monkeypatch, module, name):
    """Record the calls of module.name, still running it."""
    calls = []
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("dtype,hidden,planned", WIDTHS)
def test_auto_takes_the_plain_stack_where_no_plan_holds_wh(monkeypatch, dtype, hidden, planned):
    """`stack_planned` by width, for one task and for V = 2; `auto` in train
    mode calls the training stack's entry where it holds and the plain
    stack where not (the same numbers: a CPU tensor runs plain either way),
    counting the plain route; `_VBATCH`'s lockstep route follows the rule."""
    assert fls.stack_planned(hidden, 512, dtype, CPU) is planned
    assert fls.stack_planned(hidden, 512, dtype, CPU, tasks=2) is planned
    lstm = _stack(hidden)
    x = torch.randn((B, T, C), generator=torch.Generator().manual_seed(1))
    masks = draw_mask(torch.Generator().manual_seed(2), (1, T, B, hidden), 1 - KEEP, CPU)
    calls = _spy(monkeypatch, tlstm, "lstm_stack_train")
    before = fls.lstm_stack_train.plain_routes
    got = tlstm.apply_lstm(lstm, x, train=True, masks=masks, dropout_rate=1 - KEEP,
                           compute_dtype=dtype, kernel="auto")
    assert (calls == ["lstm_stack_train"]) is planned
    assert fls.lstm_stack_train.plain_routes == before + (not planned)
    ref = fls.lstm_stack_plain(lstm.layers, x, dtype, masks, KEEP)
    assert torch.equal(got, ref)

    monkeypatch.setattr(fls, "_VBATCH", True)
    cfg = tcfg.ModelConfig(lstm_hidden=hidden, compute_dtype=str(dtype).split(".")[1])
    tasks = SimpleNamespace(support_x=torch.zeros((2, 1, T, 512, 16)))
    assert maml.lockstep_route(cfg, tcfg.MetaConfig(), tasks) is planned
    assert maml.lockstep_route(cfg, tcfg.MetaConfig())  # the flag alone: the mesh's refusal
    plain = dataclasses.replace(cfg, lstm_kernel="xla")
    assert maml.lockstep_route(plain, tcfg.MetaConfig(), tasks)  # no kernel, no plan


def test_plans_refuse_float32_h320_and_forced_routes_reach_their_kernels(monkeypatch):
    """At float32 hidden 448 (320 before 16-block clusters, which refused
    there until streamed slices) both recurrence plans stream part of each
    slice (k_res < K) and `stack_planned` stays False; `pallas_stack` calls
    the training stack's entry and `pallas` the per-layer route, whose card
    launches take those plans, counting no plain route. V = 2 tasks still
    refuse."""
    for plan, k_rows, what in (
            (fls.forward_plan, 448, "forward recurrence holds Wh in at most 16 blocks"),
            (fls.recurrence_plan, 4 * 448, r"backward recurrence holds Wh\^T")):
        assert fls.streams(plan(448, 512, 4, fls.H100_SMS), k_rows)
        assert plan(448, B, 4, fls.H100_SMS)[3] < k_rows
        with pytest.raises(ValueError, match=what):
            plan(448, 512, 4, fls.H100_SMS, 2)
    assert not fls.stack_planned(448, B, torch.float32, CPU)
    lstm = _stack(448)
    x = torch.randn((B, T, C), generator=torch.Generator().manual_seed(1))
    stack = _spy(monkeypatch, tlstm, "lstm_stack_train")
    layerwise = _spy(monkeypatch, tlstm, "lstm_layerwise")
    before = fls.lstm_stack_train.plain_routes
    for kernel in ("pallas_stack", "pallas"):
        tlstm.apply_lstm(lstm, x, train=True, compute_dtype=torch.float32, kernel=kernel)
    assert (stack, layerwise) == (["lstm_stack_train"], ["lstm_layerwise"])
    assert fls.lstm_stack_train.plain_routes == before


@pytest.mark.parametrize("merged", [True, False])
def test_eval_forward_keeps_row2_at_any_width(monkeypatch, merged):
    """The eval forward, merged (row 2) or not (row 14,
    `_MERGED_GATES=False`), runs on the card as one schedule whose forward
    recurrence has no cluster plan at float32 hidden 448 (`eval_planned`):
    `auto` runs the plain stack there, counted, as JAX's `auto` does where
    `stack_supported` fails; no eval entry is called."""
    monkeypatch.setattr(fls, "_MERGED_GATES", merged)
    lstm = _stack(448)
    x = torch.randn((B, T, C), generator=torch.Generator().manual_seed(1))
    calls = _spy(monkeypatch, tlstm, "lstm_stack_last_all")
    before = fls.lstm_stack_train.plain_routes
    with torch.no_grad():
        got = tlstm.apply_lstm(lstm, x, compute_dtype=torch.float32, kernel="auto")
    assert calls == []
    assert fls.lstm_stack_train.plain_routes == before + 1
    assert not fls.eval_planned(C, 448, B, torch.float32, x.device)
    with torch.no_grad():
        assert torch.equal(got, fls.lstm_stack_plain(lstm.layers, x, torch.float32))


SMALL = dict(hidden_channels=16, gcn_layers=2, lstm_hidden=448, lstm_layers=2, window=4,
             horizon=2, koppen_dim=4, gcn_dropout=0.2, lstm_dropout=0.2, lstm_kernel="auto")


def _jax_masks(mc, rng, w, n):
    """The masks JAX's XLA route of the hybrid draws from `rng`, as int8."""
    keep = 1.0 - mc.gcn_dropout

    def draw(key, shape):
        return np.asarray(jax.random.bernoulli(key, keep, shape)).astype(np.int8)

    enc_rng, lstm_rng, head_rng = jax.random.split(rng, 3)
    return {
        "encoder": np.stack([draw(jax.random.fold_in(enc_rng, l), (w, n, mc.hidden_channels))
                             for l in range(mc.gcn_layers - 1)]),
        "lstm": np.stack([draw(jax.random.fold_in(lstm_rng, l), (w, n, mc.lstm_hidden))
                          for l in range(mc.lstm_layers - 1)]),
        "head": draw(head_rng, (n, mc.lstm_hidden)),
    }


@pytest.mark.parametrize("dtype,tol", [
    ("float64", dict(rtol=1e-8, atol=1e-10)),
    ("float32", dict(rtol=1e-4, atol=1e-5)),
])
def test_auto_train_step_at_h320_matches_jax(dtype, tol):
    """The hybrid's train step (output and every parameter's gradient of
    sum(out * ct)) at hidden 448 (320 before 16-block clusters) under
    `auto`, JAX's masks injected, against JAX's `apply_model`; the float32
    config takes the plain route by the decision (counted), float64 is plain
    on every route."""
    _train_step_matches_jax(dtype, tol, 448, planned=False)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 5e-2)])
def test_forced_pallas_stack_train_step_at_h448_matches_jax(dtype, tol):
    """The step at hidden 448 under the forced `pallas_stack` (the training
    stack's entry: on a card its streamed plans, here its plain pieces),
    counting no plain route, against JAX's forced `pallas_stack`, which
    runs its fused stack's Pallas kernels past `stack_supported` (here in
    the interpreter)."""
    _train_step_matches_jax(dtype, dict(rtol=tol, atol=tol), 448, planned=True,
                            kernel="pallas_stack")


@pytest.mark.parametrize("hidden", [320, 384])
def test_auto_train_step_at_16_block_widths_matches_jax(hidden):
    """The same step at float32 hidden 320 and 384, where 16-block clusters
    hold Wh: `auto` takes the training stack's entry (its plain pieces on a
    CPU tensor), counts no plain route, and matches JAX at float32's
    tolerance."""
    _train_step_matches_jax("float32", dict(rtol=1e-4, atol=1e-5), hidden, planned=True)


def _train_step_matches_jax(dtype, tol, hidden, planned, kernel="auto"):
    kw = dict(SMALL, compute_dtype=dtype, lstm_hidden=hidden, lstm_kernel=kernel)
    mc = jcfg.ModelConfig(**kw)
    npdt = np.float64 if dtype == "float64" else np.float32
    a_hat = jax_graph(np.arange(10.0, 11.0 + 1e-9, 0.25),
                      np.arange(20.0, 21.0 + 1e-9, 0.25)).a_hat  # 25 nodes padded to 128
    n = a_hat.shape[0]
    x = np.random.default_rng(7).normal(size=(4, n, 16)).astype(npdt)
    ct = np.random.default_rng(8).normal(size=(2, n, 12)).astype(npdt)
    rng = jax.random.key(5)
    with jax.enable_x64(dtype == "float64"):
        jp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), npdt),
                          jax_init_model(jax.random.key(0), mc))

        def loss(p):
            out = jax_apply_model(p, jnp.asarray(a_hat, npdt), jnp.asarray(x), jnp.int32(5), mc,
                                  train=True, rng=rng)
            return jnp.sum(out * ct), out

        with jax_fls.force_interpret():  # the Pallas kernels on the CPU, as JAX's tests run them
            (_, ref), ref_g = jax.value_and_grad(loss, has_aux=True)(jp)
        ref_sd = state_dict_from_params(jax.tree.map(np.asarray, ref_g), npdt)
        params_sd = state_dict_from_params(jax.tree.map(np.asarray, jp), npdt)
        masks = _jax_masks(mc, rng, 4, n)

    tdt = torch.float64 if dtype == "float64" else torch.float32  # bfloat16: its matmul operands
    model = init_model(torch.Generator().manual_seed(0), tcfg.ModelConfig(**kw)).to(tdt)
    model.load_state_dict(params_sd)
    before = fls.lstm_stack_train.plain_routes
    out = apply_model(model, torch.from_numpy(a_hat).to(tdt), torch.from_numpy(x), 5,
                      tcfg.ModelConfig(**kw), train=True,
                      masks={k: torch.from_numpy(v) for k, v in masks.items()})
    (out * torch.from_numpy(ct)).sum().backward()
    assert fls.lstm_stack_train.plain_routes == before + (dtype == "float32" and not planned)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **tol)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_sd[name].numpy(), err_msg=name, **tol)


@pytest.mark.parametrize("hidden,planned", [(128, True), (448, False), (320, True)])
def test_so_fused_gradient_takes_the_plain_loss_where_no_plan_holds_wh(hidden, planned):
    """`make_grad_loss_fused` (float32, `auto`): at hidden 448 the plain
    loss's gradient, bit for bit, counted as a plain route; at 128 and 320
    (a 16-block cluster) the fused composition (the plain stack ops on a CPU
    tensor), not counted, equal to it at float32's tolerance. Where the
    stack is planned, rows 10-11's tangent plans exist too."""
    if planned:
        for plan in (fused_lstm_hvp.tangent_forward_plan, fused_lstm_hvp.tangent_plan):
            assert plan(hidden, 128, 4, fls.H100_SMS)
    cfg = tcfg.ModelConfig(**dict(SMALL, lstm_hidden=hidden))
    model = init_model(torch.Generator().manual_seed(0), cfg)
    n = 128
    draw = torch.Generator().manual_seed(3)
    aux = (torch.randn((4, n, 16), generator=draw), torch.randn((2, n, 12), generator=draw),
           torch.eye(n), torch.tensor(5), torch.ones(n))
    masks = draw_masks(cfg, torch.Generator().manual_seed(4), aux[0])
    q = {k: v.detach() for k, v in model.named_parameters()}
    before = fls.lstm_stack_train.plain_routes
    got = make_grad_loss_fused(model, cfg)(q, aux, masks)
    assert fls.lstm_stack_train.plain_routes == before + (not planned)
    ref = torch.func.grad(support_loss(model, plain_route(cfg)))(q, aux, masks)
    for k in q:
        if planned:
            torch.testing.assert_close(got[k], ref[k], rtol=1e-4, atol=1e-5, msg=k)
        else:
            assert torch.equal(got[k], ref[k]), k
