"""The port's training operators and train-mode forwards against the JAX
package, on the CPU.

On a CPU tensor the port's training wrappers run their plain PyTorch
versions (autograd for the backward); the CUDA kernels (rows 4-7) are held
against those by tests/test_torch_port_cuda.py and chip_smoke.py on a card.
Here the plain versions meet the Pallas training kernels' own bodies in the
interpreter, with the same int8 dropout masks, and the whole train-mode
model meets the JAX package's XLA route in float64 with JAX's masks
injected.

Tolerances: float32 forwards rtol 1e-5 / atol 1e-6 and gradients rtol 1e-4
/ atol 1e-5 (summation order only, over up to a few thousand terms);
bfloat16 5e-2 (an operand rounding flipped by a last-bit difference);
float64 1e-10.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from weatherforecast_stgcn_maml_tpu import config as jcfg
from weatherforecast_stgcn_maml_tpu.graph import build_region_graph as jax_graph
from weatherforecast_stgcn_maml_tpu.models.losses import masked_mae as jax_mae
from weatherforecast_stgcn_maml_tpu.models.losses import masked_mse as jax_mse
from weatherforecast_stgcn_maml_tpu.models.lstm import init_lstm as jax_init_lstm
from weatherforecast_stgcn_maml_tpu.models.registry import apply_model as jax_apply_model
from weatherforecast_stgcn_maml_tpu.models.registry import init_model as jax_init_model
from weatherforecast_stgcn_maml_tpu.models.stgcn import init_encoder as jax_init_encoder
from weatherforecast_stgcn_maml_tpu.ops import fused_gcn_train as jax_fgt
from weatherforecast_stgcn_maml_tpu.ops import fused_lstm_stack as jax_fls
from weatherforecast_stgcn_maml_tpu.train.supervised import batched_forward as jax_batched_forward
from weatherforecast_stgcn_maml_tpu_torch import config as tcfg
from weatherforecast_stgcn_maml_tpu_torch.models.common import draw_mask
from weatherforecast_stgcn_maml_tpu_torch.models.hybrid import hybrid_masks
from weatherforecast_stgcn_maml_tpu_torch.models.losses import masked_mae, masked_mse
from weatherforecast_stgcn_maml_tpu_torch.models.lstm import init_lstm
from weatherforecast_stgcn_maml_tpu_torch.models.registry import apply_model, init_model
from weatherforecast_stgcn_maml_tpu_torch.models.stgcn import init_encoder, stgcn_masks
from weatherforecast_stgcn_maml_tpu_torch.ops.fused_gcn_train import gcn_stack_train
from weatherforecast_stgcn_maml_tpu_torch.ops.fused_lstm_stack import lstm_stack_train
from weatherforecast_stgcn_maml_tpu_torch.utils.convert import state_dict_from_params

torch.set_num_threads(1)  # small tensors; more threads oversubscribe side-by-side workers

FWD_TOL = {"float32": dict(rtol=1e-5, atol=1e-6), "bfloat16": dict(rtol=5e-2, atol=5e-2)}
GRAD_TOL = {"float32": dict(rtol=1e-4, atol=1e-5), "bfloat16": dict(rtol=5e-2, atol=5e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SMALL = dict(hidden_channels=16, gcn_layers=2, lstm_hidden=8, lstm_layers=2, window=6,
             horizon=3, koppen_dim=4, gcn_dropout=0.2, lstm_dropout=0.2)
KEEP = 0.8


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _a_hat():
    lats = np.arange(10.0, 11.0 + 1e-9, 0.25)
    lons = np.arange(20.0, 21.0 + 1e-9, 0.25)
    return jax_graph(lats, lons).a_hat  # 25 nodes padded to 128


def _int8_masks(seed, shape):
    return (np.random.default_rng(seed).random(shape) < KEEP).astype(np.int8)


def _cotangent(shape, seed=11):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _torch_grads(fn, x, params):
    x = x.clone().requires_grad_(True)
    out = fn(x)
    ct = torch.from_numpy(_cotangent(out.shape)).to(out.dtype)
    grads = torch.autograd.grad(out, [x, *params], ct)
    return out.detach().float().numpy(), [g.float().numpy() for g in grads]


def _allclose(got, ref, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_masks", [1, 2])
def test_gcn_train_stack_matches_pallas_body(dtype, n_masks):
    """n_masks 1: the hybrid's encoder (no dropout after the last layer);
    2: the standalone STGCN's (final dropout)."""
    jdt, tdt = DTYPES[dtype]
    mc = jcfg.ModelConfig(**SMALL)
    jp = _np(jax_init_encoder(jax.random.key(1), mc))
    enc = init_encoder(torch.Generator().manual_seed(0), tcfg.ModelConfig(**SMALL))
    enc.load_state_dict(state_dict_from_params(jp))
    a_hat = _a_hat()
    x = np.random.default_rng(0).normal(size=(6, 128, mc.in_channels)).astype(np.float32)
    masks = _int8_masks(1, (n_masks, 6, 128, 16))
    ct = _cotangent((6, 128, 16))

    w0 = jnp.asarray(jp["layers"][0]["w"])
    wr = jnp.stack([jnp.asarray(jp["layers"][1]["w"])])
    b2d = jnp.stack([jnp.asarray(layer["b"]) for layer in jp["layers"]])

    def jax_fn(x, w0, wr, b2d):
        out = jax_fgt._gcn_train_pallas(
            x, jnp.asarray(a_hat), w0, wr, b2d, jdt, True, KEEP, jnp.asarray(masks)
        )
        return out, jnp.sum(out.astype(jnp.float32) * ct.astype(out.dtype).astype(jnp.float32))

    with jax_fgt.force_interpret():
        ref = jax_fn(jnp.asarray(x), w0, wr, b2d)[0]
        ref_g = jax.grad(lambda *a: jax_fn(*a)[1], argnums=(0, 1, 2, 3))(
            jnp.asarray(x), w0, wr, b2d
        )
    params = [enc.layers[0].w, enc.layers[1].w, enc.layers[0].b, enc.layers[1].b]
    got, got_g = _torch_grads(
        lambda x: gcn_stack_train(enc.layers, torch.from_numpy(a_hat), x,
                                  masks=torch.from_numpy(masks), keep=KEEP, compute_dtype=tdt),
        torch.from_numpy(x), params,
    )
    _allclose(got, ref, FWD_TOL[dtype])
    dx, dw0, dwr, db = ref_g
    for g, r in zip(got_g, [dx, dw0, dwr[0], db[0], db[1]]):
        _allclose(g, r, GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_lstm_train_stack_matches_pallas_body(dtype, dropout):
    jdt, tdt = DTYPES[dtype]
    jp = _np(jax_init_lstm(jax.random.key(2), 16, 8, 2))
    lstm = init_lstm(torch.Generator().manual_seed(0), 16, 8, 2)
    lstm.load_state_dict(state_dict_from_params(jp))
    x = np.random.default_rng(3).normal(size=(40, 6, 16)).astype(np.float32)
    masks = _int8_masks(4, (1, 6, 40, 8)) if dropout else None
    ct = _cotangent((40, 8))

    def jax_loss(p, x):
        out = jax_fls.lstm_stack_last_all(
            p, x, dropout_rate=dropout, compute_dtype=jdt, interpret=True,
            masks=None if masks is None else jnp.asarray(masks),
        )
        return jnp.sum(out * ct), out

    (_, ref), ref_g = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x)
    )
    params = [p for layer in lstm.layers for p in (layer.wx, layer.wh, layer.b)]
    got, got_g = _torch_grads(
        lambda x: lstm_stack_train(
            lstm.layers, x, masks=None if masks is None else torch.from_numpy(masks),
            keep=1.0 - dropout, compute_dtype=tdt),
        torch.from_numpy(x), params,
    )
    _allclose(got, ref, FWD_TOL[dtype])
    ref_params = [ref_g[0]["layers"][l][k] for l in range(2) for k in ("wx", "wh", "b")]
    for g, r in zip(got_g, [ref_g[1], *ref_params]):
        _allclose(g, r, GRAD_TOL[dtype])


def _jax_masks(family, mc, rng, w, n):
    """The masks the JAX package's XLA route draws from `rng`, as int8."""
    keep = 1.0 - mc.gcn_dropout

    def draw(key, shape):
        return np.asarray(jax.random.bernoulli(key, keep, shape)).astype(np.int8)

    if family == "stgcn":
        return {"encoder": np.stack([draw(jax.random.fold_in(rng, l), (w, n, mc.hidden_channels))
                                     for l in range(mc.gcn_layers)])}
    enc_rng, lstm_rng, head_rng = jax.random.split(rng, 3)
    return {
        "encoder": np.stack([draw(jax.random.fold_in(enc_rng, l), (w, n, mc.hidden_channels))
                             for l in range(mc.gcn_layers - 1)]),
        "lstm": np.stack([draw(jax.random.fold_in(lstm_rng, l), (w, n, mc.lstm_hidden))
                          for l in range(mc.lstm_layers - 1)]),
        "head": draw(head_rng, (n, mc.lstm_hidden)),
    }


@pytest.mark.parametrize("family", ["hybrid", "stgcn"])
def test_train_forward_and_grads_match_jax_float64(family):
    """Whole model, train mode, dropout on: JAX's masks redrawn from its key
    streams and injected into the port."""
    kw = dict(SMALL, family=family, compute_dtype="float64")
    mc = jcfg.ModelConfig(**kw)
    a_hat = _a_hat()
    x = np.random.default_rng(7).normal(size=(6, 128, 16))
    ct = np.random.default_rng(8).normal(size=(3, 128, 12))
    rng = jax.random.key(5)
    with jax.enable_x64(True):
        jp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                          jax_init_model(jax.random.key(0), mc))

        def loss(p):
            out = jax_apply_model(p, jnp.asarray(a_hat, jnp.float64), jnp.asarray(x),
                                  jnp.int32(5), mc, train=True, rng=rng)
            return jnp.sum(out * ct), out

        (_, ref), ref_g = jax.value_and_grad(loss, has_aux=True)(jp)
        ref_sd = state_dict_from_params(_np(ref_g), np.float64)
        masks = _jax_masks(family, mc, rng, 6, 128)
        params_sd = state_dict_from_params(_np(jp), np.float64)

    model = init_model(torch.Generator().manual_seed(0), tcfg.ModelConfig(**kw)).double()
    model.load_state_dict(params_sd)
    out = apply_model(model, torch.from_numpy(a_hat).double(), torch.from_numpy(x), 5,
                      tcfg.ModelConfig(**kw), train=True,
                      masks={k: torch.from_numpy(v) for k, v in masks.items()})
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-10, atol=1e-12)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_sd[name].numpy(), rtol=1e-10,
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("family", ["hybrid", "stgcn"])
def test_batched_train_forward_and_grads_match_jax_float64(family):
    """A window batch in train mode (what adaptation trains on), dropout on:
    JAX vmaps the model over the windows with a key each; the port folds
    the batch into the encoder's slices and the LSTM's rows, with JAX's
    per-window masks injected."""
    kw = dict(SMALL, family=family, compute_dtype="float64")
    mc = jcfg.ModelConfig(**kw)
    a_hat = _a_hat()
    b = 3
    x = np.random.default_rng(17).normal(size=(b, 6, 128, 16))
    ct = np.random.default_rng(18).normal(size=(b, 3, 128, 12))
    rng = jax.random.key(9)
    with jax.enable_x64(True):
        jp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                          jax_init_model(jax.random.key(0), mc))

        def loss(p):
            out = jax_batched_forward(p, jnp.asarray(a_hat, jnp.float64), jnp.asarray(x),
                                      jnp.int32(4), mc, train=True, rng=rng)
            return jnp.sum(out * ct), out

        (_, ref), ref_g = jax.value_and_grad(loss, has_aux=True)(jp)
        ref_sd = state_dict_from_params(_np(ref_g), np.float64)
        per_window = [_jax_masks(family, mc, k, 6, 128) for k in jax.random.split(rng, b)]
        params_sd = state_dict_from_params(_np(jp), np.float64)
    masks = {k: torch.from_numpy(np.stack([m[k] for m in per_window])) for k in per_window[0]}

    model = init_model(torch.Generator().manual_seed(0), tcfg.ModelConfig(**kw)).double()
    model.load_state_dict(params_sd)
    out = apply_model(model, torch.from_numpy(a_hat).double(), torch.from_numpy(x), 4,
                      tcfg.ModelConfig(**kw), train=True, masks=masks)
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-10, atol=1e-12)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_sd[name].numpy(), rtol=1e-10,
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("family", ["hybrid", "stgcn"])
def test_batched_train_forward_draws_masks_per_window(family):
    """From a generator, a window batch draws each window's masks in turn;
    the folded batch forward equals each window's own forward with its
    masks, and the windows' masks differ."""
    mc = tcfg.ModelConfig(**SMALL, family=family, compute_dtype="float64")
    model = init_model(torch.Generator().manual_seed(1), mc).double()
    a_hat = torch.from_numpy(_a_hat()).double()
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 6, 128, 16)))
    got = apply_model(model, a_hat, x, 3, mc, train=True,
                      generator=torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(5)
    draw = hybrid_masks if family == "hybrid" else stgcn_masks
    per_window = [draw(mc, g, 6, 128, "cpu") for _ in range(2)]
    assert not torch.equal(per_window[0]["encoder"], per_window[1]["encoder"])
    for i, masks in enumerate(per_window):
        ref = apply_model(model, a_hat, x[i], 3, mc, train=True, masks=masks)
        np.testing.assert_allclose(got[i].detach().numpy(), ref.detach().numpy(),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("family", ["hybrid", "stgcn"])
def test_dropout_free_train_forward_is_the_eval_forward(family):
    """A train-mode forward without masks or generator computes the eval
    function (what the query loss uses when query_train_mode is off)."""
    mc = tcfg.ModelConfig(**SMALL, family=family)
    model = init_model(torch.Generator().manual_seed(1), mc)
    a_hat = torch.from_numpy(_a_hat())
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(6, 128, 16)).astype(np.float32))
    with torch.no_grad():
        ref = apply_model(model, a_hat, x, 3, mc)
    got = apply_model(model, a_hat, x, 3, mc, train=True)
    np.testing.assert_allclose(got.detach().numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)


def test_hybrid_masks_shapes_order_and_rate():
    mc = tcfg.ModelConfig(**SMALL)
    masks = hybrid_masks(mc, torch.Generator().manual_seed(0), 6, 128, "cpu")
    assert list(masks) == ["encoder", "lstm", "head"]
    assert masks["encoder"].shape == (1, 6, 128, 16) and masks["encoder"].dtype == torch.int8
    assert masks["lstm"].shape == (1, 6, 128, 8) and masks["head"].shape == (128, 8)
    big = draw_mask(torch.Generator().manual_seed(1), (200_000,), 0.2, "cpu")
    assert abs(float(big.float().mean()) - 0.8) < 5e-3
    no_dropout = tcfg.ModelConfig(**{**SMALL, "gcn_dropout": 0.0, "lstm_dropout": 0.0})
    assert hybrid_masks(no_dropout, torch.Generator(), 6, 128, "cpu") == {}


@pytest.mark.parametrize("loss", ["mse", "mae"])
def test_masked_losses_match_jax(loss):
    rng = np.random.default_rng(0)
    preds, targets = rng.normal(size=(2, 3, 128, 12)), rng.normal(size=(2, 3, 128, 12))
    node_mask = (np.arange(128) < 25).astype(np.float32)
    port, ref = {"mse": (masked_mse, jax_mse), "mae": (masked_mae, jax_mae)}[loss]
    got = port(torch.from_numpy(preds), torch.from_numpy(targets), torch.from_numpy(node_mask))
    with jax.enable_x64(True):
        want = ref(jnp.asarray(preds), jnp.asarray(targets), jnp.asarray(node_mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)
