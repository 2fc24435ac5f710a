"""The eval LSTM forward that rows 2, 14 and 20 share on a card, row 20's
train-mode schedule, the routing by shape in front of them and the
forward recurrence's plan at validate's rows, on the CPU against the JAX
package.

  * Rows 2 and 20's card schedule, row 14's layer-by-layer forward without
    residuals (`split_forward_schedule(..., residuals=False)` on
    `FWD_PLAIN_PIECES`) from the layers' own wx, wh and b, against JAX's
    `_fwd_pallas_m(..., emit_residuals=False)` (row 2's body
    `_fwd_kernel_m_lastonly_nomask` in the Pallas interpreter, merged [[Wx],
    [Wh]]) and JAX's `fused_lstm_last_hidden` (row 20; its XLA route on the
    CPU); float32 and bfloat16, one and three layers.
  * Row 20's train-mode card schedule (`split_forward_schedule` with
    residuals, then row 15's `split_backward_schedule` on `PLAIN_PIECES`, no
    masks) against jax.grad of JAX's `fused_lstm_last_hidden`: dx and every
    layer's wx, wh and b, float32 and float64.
  * The card routes' wiring with only the C call swapped for its plain
    schedule: `fused_lstm_last_hidden` (eval and train mode, the biases
    split as b_ih / b_hh), `lstm_stack_last_all` and the unmerged eval
    forward through `eval_forward`, each counted on its own entry.
  * The routing: at float32 hidden 448 (no cluster holds Wh) and 130 (not a
    multiple of 8) `lstm_kernel="auto"` and `use_pallas_lstm` run the plain
    stack in eval mode, counted, and the hybrid's forward equals JAX's
    `apply_hybrid` with the same flags (float32 1e-5, float64 1e-10).
  * `forward_plan` at validate's 1536 rows (float32: clusters of 2 blocks x
    32 rows, one wave; bfloat16 unchanged) and `eval_planned`'s answers.

Tolerances: float32 1e-5, bfloat16 5e-2, float64 1e-10 (rtol = atol on
forwards; max|diff| / max|ref| on gradients).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from weatherforecast_stgcn_maml_tpu import config as jcfg
from weatherforecast_stgcn_maml_tpu.graph import build_region_graph as jax_graph
from weatherforecast_stgcn_maml_tpu.models.hybrid import apply_hybrid as jax_apply_hybrid
from weatherforecast_stgcn_maml_tpu.models.lstm import init_lstm as jax_init_lstm
from weatherforecast_stgcn_maml_tpu.models.registry import init_model as jax_init_model
from weatherforecast_stgcn_maml_tpu.ops import fused_lstm as jax_flstm
from weatherforecast_stgcn_maml_tpu.ops import fused_lstm_stack as jax_fls
from weatherforecast_stgcn_maml_tpu_torch import config as tcfg
from weatherforecast_stgcn_maml_tpu_torch.models import hybrid as port_hybrid
from weatherforecast_stgcn_maml_tpu_torch.models import lstm as tlstm
from weatherforecast_stgcn_maml_tpu_torch.models.registry import apply_model, init_model
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm_stack as fls
from weatherforecast_stgcn_maml_tpu_torch.utils.convert import state_dict_from_params

torch.set_num_threads(1)  # small tensors; more threads oversubscribe side-by-side workers

T, B, C, H = 5, 16, 24, 8  # JAX tests/test_lstm_stack.py's widths
TOL = {"float32": 1e-5, "bfloat16": 5e-2, "float64": 1e-10}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float64": (jnp.float64, torch.float64)}


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _inputs(n_layers, seed, dtype=np.float32):
    """JAX's LSTM tree (numpy leaves) and x [B, T, C] batch-major."""
    tree = jax.tree.map(lambda a: np.array(a, dtype),
                        jax_init_lstm(jax.random.key(seed), C, H, n_layers))
    x = np.random.default_rng(seed).normal(size=(B, T, C)).astype(dtype)
    return tree, x


def _split(tree):
    """(wx0, wxr, wh, b2d) torch tensors from JAX's LSTM tree."""
    layers = tree["layers"]
    t = torch.from_numpy
    wxr = (t(np.stack([p["wx"] for p in layers[1:]])) if len(layers) > 1
           else t(np.zeros((0, H, 4 * H), layers[0]["wx"].dtype)))
    return (t(layers[0]["wx"]), wxr, t(np.stack([p["wh"] for p in layers])),
            t(np.stack([p["b"] for p in layers])))


def _port_lstm(tree, dtype=torch.float32, split_biases=False):
    n_layers = len(tree["layers"])
    lstm = tlstm.init_lstm(torch.Generator().manual_seed(0), C, H, n_layers).to(dtype)
    lstm.load_state_dict(state_dict_from_params(tree, np.dtype(str(dtype)[6:])))
    if split_biases:
        tlstm.split_lstm_biases(lstm)
        with torch.no_grad():  # b_ih + b_hh = b, neither zero
            for layer in lstm.layers:
                layer.b_hh.copy_(0.25 * layer.b_ih)
                layer.b_ih.mul_(0.75)
    return lstm


@pytest.mark.parametrize("row", [2, 20])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_layers", [1, 3])
def test_eval_schedule_matches_rows_2_and_20(row, dtype, n_layers):
    jdt, tdt = DTYPES[dtype]
    tree, x = _inputs(n_layers, 3 * n_layers + row)
    x_tbc = np.ascontiguousarray(x.transpose(1, 0, 2))
    wx0, wxr, wh, b2d = _split(tree)
    got, h_all, c_all = fls.split_forward_schedule(
        torch.from_numpy(x_tbc), wx0, wxr, wh, b2d, None, 1.0, tdt, fls.FWD_PLAIN_PIECES,
        residuals=False)
    assert got.dtype == torch.float32 and h_all is None and c_all is None
    layers = tree["layers"]
    if row == 2:
        wcat = [np.concatenate([p["wx"], p["wh"]]) for p in layers]
        jwr = (jnp.asarray(np.stack(wcat[1:])) if n_layers > 1
               else jnp.zeros((1, 2 * H, 4 * H), jnp.float32))
        with jax_fls.force_interpret():
            ref = jax_fls._fwd_pallas_m(jnp.asarray(x_tbc), jnp.asarray(wcat[0]), jwr,
                                        jnp.asarray(np.stack([p["b"] for p in layers])), None,
                                        jdt, True, 1.0, emit_residuals=False)
    else:
        ref = jax_flstm.fused_lstm_last_hidden(jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                                               compute_dtype=jdt)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32), rtol=TOL[dtype],
                               atol=TOL[dtype])


@functools.lru_cache(maxsize=None)
def _jax_case(dtype, n_layers):
    """Inputs (JAX's LSTM tree, x, a cotangent ct [B, H]) and JAX's
    fused_lstm_last_hidden with its gradients (the tree's, x's)."""
    jdt = DTYPES[dtype][0]
    npdt = np.float64 if dtype == "float64" else np.float32
    tree, x = _inputs(n_layers, 11 + n_layers, npdt)
    ct = np.random.default_rng(5).normal(size=(B, H)).astype(npdt)

    def loss(p, xx):
        out = jax_flstm.fused_lstm_last_hidden(p, xx, compute_dtype=jdt)
        return jnp.sum(out * ct), out

    with jax.enable_x64(dtype == "float64"):
        (_, out), (gp, gx) = jax.value_and_grad(loss, (0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    return tree, x, ct, np.asarray(out), jax.tree.map(np.asarray, gp), np.asarray(gx)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n_layers", [1, 3])
def test_row20_train_schedule_matches_jax_grad(dtype, n_layers):
    """Row 20's train-mode card schedule on its plain pieces: row 14's
    forward with residuals, row 15's backward without masks."""
    tdt = DTYPES[dtype][1]
    tree, x, ct, out, gp, gx = _jax_case(dtype, n_layers)
    x_tbc = torch.from_numpy(np.ascontiguousarray(x.transpose(1, 0, 2)))
    wx0, wxr, wh, b2d = _split(tree)
    h_last, h_all, c_all = fls.split_forward_schedule(x_tbc, wx0, wxr, wh, b2d, None, 1.0, tdt,
                                                      fls.FWD_PLAIN_PIECES)
    dx, dwx0, dwxr, dwh, db = fls.split_backward_schedule(
        torch.from_numpy(ct), x_tbc, h_all, c_all, wx0, wxr, wh, b2d, None, 1.0, tdt,
        fls.PLAIN_PIECES)
    tol = TOL[dtype]
    np.testing.assert_allclose(h_last.numpy(), out, rtol=tol, atol=tol)
    got = {"x": dx.transpose(0, 1)}
    for l, dwx in enumerate([dwx0, *dwxr]):
        got.update({f"wx{l}": dwx, f"wh{l}": dwh[l], f"b{l}": db[l]})
    ref = {"x": gx}
    for l, p in enumerate(gp["layers"]):
        ref.update({f"wx{l}": p["wx"], f"wh{l}": p["wh"], f"b{l}": p["b"]})
    assert got.keys() == ref.keys()
    for name, g in got.items():
        assert g.dtype == tdt and g.shape == ref[name].shape, name
        assert _rel(g.numpy(), ref[name]) <= tol, (name, _rel(g.numpy(), ref[name]))


@pytest.fixture
def plain_card(monkeypatch):
    """The card routes with only their C calls swapped for the plain
    schedule: every input counts as a card's, the forward's one-call entry
    (`_split_forward_card`) runs `_forward_layers` on `FWD_PLAIN_PIECES`
    and counts as the real one does, the backward's pieces are the plain
    ones."""
    def split_forward_card(x_tbc, wx, wh, b2d, masks, keep, compute_dtype, residuals, counter,
                           what):
        h_last, h_all, c_all, _ = fls._forward_layers(
            x_tbc[None], None if masks is None else masks[None], keep, compute_dtype, b2d[None],
            [w[None] for w in wx], [w[None] for w in wh], fls.FWD_PLAIN_PIECES,
            keep_gates=False, residuals=residuals)
        counter.launches += 1
        counter.forward_gemm_nn_launches += len(wh)
        counter.forward_recurrence_launches += len(wh)
        return (h_last[0], h_all[0], c_all[0]) if residuals else (h_last[0], None, None)

    def on_card(x, compute_dtype):
        return True

    monkeypatch.setattr(fls, "_on_card", on_card)
    monkeypatch.setattr(fused_lstm, "_on_card", on_card)
    monkeypatch.setattr(fls, "_split_forward_card", split_forward_card)
    monkeypatch.setattr(fls, "CARD_PIECES", fls.PLAIN_PIECES)


def _counts(fn):
    return (fn.launches, fn.forward_gemm_nn_launches, fn.forward_recurrence_launches)


def test_eval_entries_share_one_schedule_and_count_apart(plain_card):
    """Rows 2 and 20 and row 14's eval forward through `eval_forward`: each
    equals JAX's function, counted on its own entry (one call, L products,
    L recurrences)."""
    n_layers = 3
    tree, x = _inputs(n_layers, 21)
    ref = np.asarray(jax_flstm.fused_lstm_last_hidden(jax.tree.map(jnp.asarray, tree),
                                                      jnp.asarray(x)))
    lstm = _port_lstm(tree)
    xt = torch.from_numpy(x)
    entries = {
        fls.lstm_stack_last_all: lambda: fls.lstm_stack_last_all(lstm.layers, xt, merged=True),
        fls.lstm_stack_split: lambda: fls.lstm_stack_last_all(lstm.layers, xt, merged=False),
        fused_lstm.fused_lstm_last_hidden: lambda: fused_lstm.fused_lstm_last_hidden(
            lstm.layers, xt),
    }
    for entry, run in entries.items():
        before = {e: _counts(e) for e in entries}
        with torch.no_grad():
            got = run()
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
        for e in entries:
            step = (1, n_layers, n_layers) if e is entry else (0, 0, 0)
            assert _counts(e) == tuple(b + s for b, s in zip(before[e], step)), e.__name__


@pytest.mark.parametrize("n_layers", [1, 3])
def test_row20_card_route_grads_match_jax(plain_card, n_layers):
    """`fused_lstm_last_hidden` with a gradient asked: row 14's forward with
    residuals and row 15's backward, counted on row 20's entry; dx and every
    leaf's gradient (the biases split as b_ih / b_hh, each given the fused
    bias's gradient) against jax.grad of JAX's function, float32."""
    tree, x, ct, out, gp, gx = _jax_case("float32", n_layers)
    lstm = _port_lstm(tree, split_biases=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    row20 = fused_lstm.fused_lstm_last_hidden
    before = _counts(row20), row20.backward_launches
    got = row20(lstm.layers, xt)
    (got * torch.from_numpy(ct)).sum().backward()
    assert _counts(row20) == tuple(b + s for b, s in zip(before[0], (1, n_layers, n_layers)))
    assert row20.backward_launches == before[1] + 1
    np.testing.assert_allclose(got.detach().numpy(), out, rtol=1e-5, atol=1e-5)
    assert _rel(xt.grad.numpy(), gx) <= 1e-5
    for l, (layer, ref) in enumerate(zip(lstm.layers, gp["layers"])):
        for name, g, r in (("wx", layer.wx.grad, ref["wx"]), ("wh", layer.wh.grad, ref["wh"]),
                           ("b_ih", layer.b_ih.grad, ref["b"]), ("b_hh", layer.b_hh.grad,
                                                                 ref["b"])):
            assert _rel(g.numpy(), r) <= 1e-5, (l, name, _rel(g.numpy(), r))


def _a_hat():
    lats = np.arange(10.0, 11.0 + 1e-9, 0.25)
    lons = np.arange(20.0, 21.0 + 1e-9, 0.25)
    return jax_graph(lats, lons).a_hat  # 25 nodes padded to 128


SMALL = dict(hidden_channels=16, gcn_layers=2, lstm_layers=2, window=4, horizon=2, koppen_dim=4,
             use_pallas_gcn=False)
FLAGS = {"auto": dict(lstm_kernel="auto"), "use_pallas_lstm": dict(use_pallas_lstm=True)}


def _hybrid(kw, a_hat, x, monkeypatch):
    """The port's hybrid eval forward under config `kw` with JAX's weights
    (key 2) and the LSTM entries it called (spied)."""
    dtype = getattr(torch, kw["compute_dtype"])
    jp = jax.tree.map(np.asarray, jax_init_model(jax.random.key(2), jcfg.ModelConfig(**kw)))
    tmc = tcfg.ModelConfig(**kw)
    model = init_model(torch.Generator().manual_seed(0), tmc).to(dtype)
    model.load_state_dict(state_dict_from_params(jp, np.dtype(kw["compute_dtype"])))
    calls = []
    for module, name in ((tlstm, "lstm_stack_last_all"), (port_hybrid, "fused_lstm_last_hidden")):
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.append(_n), _fn(*a, **k))[1])
    with torch.no_grad():
        out = apply_model(model, torch.from_numpy(a_hat).to(dtype), torch.from_numpy(x).to(dtype),
                          3, tmc)
    monkeypatch.undo()
    return out, calls, jp


@pytest.mark.parametrize("hidden", [448, 130])
@pytest.mark.parametrize("flag", list(FLAGS))
def test_eval_routing_takes_the_plain_stack_where_unplanned(monkeypatch, hidden, flag):
    """float32 hidden 448 (no cluster holds Wh) or 130 (not a multiple of
    8): neither row 2's nor row 20's entry is called, the plain route is
    counted once, and the forward is bitwise the plain stack's
    (`lstm_kernel="xla"`); in float64 (plain on every route) the hybrid's
    eval forward equals JAX's `apply_hybrid` with the same flags (its XLA
    routes)."""
    a_hat = _a_hat()
    x = np.random.default_rng(hidden).normal(size=(4, 128, 16))
    kw = dict(SMALL, lstm_hidden=hidden, compute_dtype="float32", **FLAGS[flag])
    before = fls.lstm_stack_train.plain_routes
    got, calls, _ = _hybrid(kw, a_hat, x, monkeypatch)
    assert calls == [] and fls.lstm_stack_train.plain_routes == before + 1
    plain, _, _ = _hybrid(dict(kw, lstm_kernel="xla", use_pallas_lstm=False), a_hat, x,
                          monkeypatch)
    assert torch.equal(got, plain)

    kw = dict(kw, compute_dtype="float64")
    got, _, jp = _hybrid(kw, a_hat, x, monkeypatch)
    with jax.enable_x64(True):
        jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64) if a.dtype == np.float32
                          else jnp.asarray(a), jp)
        ref = jax_apply_hybrid(jp, jnp.asarray(a_hat, jnp.float64), jnp.asarray(x), jnp.int32(3),
                               jcfg.ModelConfig(**kw), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL["float64"],
                               atol=TOL["float64"])


@pytest.mark.parametrize("hidden,itemsize,rows,plan", [
    (128, 4, 1536, (2, 64, 32)),   # validate's rows, float32: 48 clusters of 2, one wave
    (128, 2, 1536, (1, 128, 16)),  # bfloat16: 96 blocks, one wave already
    (64, 4, 1536, (1, 64, 16)),    # one wave at 16 rows
    (128, 4, 2112, (2, 64, 32)),   # 66 clusters of 2: the last one-wave wide plan
    (128, 4, 2200, (2, 64, 16)),   # no wave at 32 rows either: the largest tile of 16
    (256, 4, 1536, (8, 32, 16)),   # no wave at 32 rows: unchanged
    (32, 2, 3000, (1, 32, 32)),    # bfloat16 takes the wide tile at 32 weight columns
    (64, 2, 3000, (1, 64, 16)),    # but not at 64 (its registers would spill)
])
def test_forward_plan_at_validate_rows(hidden, itemsize, rows, plan):
    """The 32-row tile only where it puts every cluster in one wave and no
    tile of 16 rows or less does, for one task; two tasks keep their tiles
    of at most 16 rows."""
    assert fls.forward_plan(hidden, rows, itemsize, 132) == (*plan, hidden)
    cs, hcp, rb = plan
    assert fls.scan_fwd_smem(hidden, hcp, rb, itemsize) <= fls.SCAN_MAX_SMEM
    assert rb < fls.FWD_WIDE_TILE or hcp <= 16 * itemsize
    assert fls.forward_plan(hidden, rows, itemsize, 132, 2)[2] <= 16


@pytest.mark.parametrize("c_in,hidden,dtype,planned", [
    (256, 128, torch.float32, True), (256, 256, torch.float32, True),
    (16, 448, torch.float32, False), (16, 130, torch.float32, False),
    (12, 128, torch.float32, False), (256, 384, torch.bfloat16, True),
    (16, 320, torch.float64, True), (256, 320, torch.float32, True),
    (256, 384, torch.float32, True), (256, 512, torch.bfloat16, True),
    (256, 640, torch.bfloat16, False),
])
def test_eval_planned(c_in, hidden, dtype, planned):
    """The eval forward's answer at validate's 1536 rows: widths that are
    multiples of 8 and a forward plan that holds Wh; float64 runs plain on
    every route."""
    assert fls.eval_planned(c_in, hidden, 1536, dtype, torch.device("cpu")) is planned
    if dtype is torch.float32 and hidden % 8 == 0 and c_in % 8 == 0:
        assert planned is fls.stack_planned(hidden, 1536, dtype, torch.device("cpu"))
