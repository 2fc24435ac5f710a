"""Row 11's layer-by-layer schedule (the tangent of the merged LSTM stack's
training backward, second-order MAML) and row 14's (the unmerged-gates
stack's forward on row 4's schedule), on their plain pieces, against the
JAX package on the CPU.

  * `fused_lstm_hvp.hvp_backward_schedule` on `PLAIN_TANGENT_PIECES` (the
    plain products, the plain tangent recurrence) against JAX's
    `_hvpbwd_kernel_m` in the Pallas interpreter, reached through jax.jvp of
    `hvp_stack_ops(..., interpret=True)` as tests/test_torch_port_so.py
    reaches it: tdx, every tdW and tdb; float32 and bfloat16, masks on and
    off, one and three layers. The schedule's primal residuals (gates,
    their tangents, row 5's dgates / dh / dc) come from the port's plain
    R-operator at the same point.
  * The same schedule against `hvp_bwd_plain` (the stage-by-stage reference)
    in float64.
  * The plain tangent recurrence against torch.func.jvp of the plain
    backward recurrence (`lstm_scan.scan_backward_plain`) in float64, the
    tangent of Wh entering through the off-chain product p.
  * `fused_lstm_stack.split_forward_schedule` on `FWD_PLAIN_PIECES` against
    JAX's `_fwd_pallas` (`_fwd_kernel` in the interpreter): h_last, h_all,
    c_all; without residuals only h_last, equal to the residual run's; the
    next layer's input rounded once, from the float32 h.

Tolerances: max|diff| / max|ref| on the tangents, chip_smoke.py's HVP_TOL
(float32 1e-4: JAX sums [tdgates | dgates] @ [W; tW]^T in one contraction,
the schedule in two; bfloat16 5e-2); the forward rtol = atol 1e-5 (float32:
JAX adds the bias last, the recurrence before h Wh) and 5e-2 (bfloat16);
float64 1e-10.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from weatherforecast_stgcn_maml_tpu.models.lstm import init_lstm as jax_init_lstm
from weatherforecast_stgcn_maml_tpu.ops import fused_lstm_hvp as jax_fh
from weatherforecast_stgcn_maml_tpu.ops import fused_lstm_stack as jax_fls
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm_hvp as fh
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm_stack as fls
from weatherforecast_stgcn_maml_tpu_torch.ops.gemm import gemm_nn_plain
from weatherforecast_stgcn_maml_tpu_torch.ops.lstm_scan import scan_backward_plain

torch.set_num_threads(1)  # small tensors; more threads oversubscribe side-by-side workers

T, B, C, H = 5, 16, 24, 8  # tests/test_torch_port_forward_schedule.py's widths
KEEP = 0.75
HVP_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _stack_inputs(seed, layers, with_masks, dtype=np.float32):
    """Primals and tangents of the stack, numpy; wcat_r stacked as JAX's
    (one dummy layer when L = 1)."""
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


def _row11(p, t, g, tg, masks, layers, dt, pieces=fh.PLAIN_TANGENT_PIECES):
    """The port's plain R-operator forward and primal backward at the point,
    then row 11 by `hvp_backward_schedule` on `pieces` and by
    `hvp_bwd_plain`: ([tdx, tdw_0, .., tdb] of the schedule, of the plain)."""
    tt = lambda a: torch.from_numpy(np.asarray(a)).to(  # noqa: E731
        torch.float64 if dt == torch.float64 else torch.float32)
    wcat = [tt(p["w0"])] + [tt(p["wr"][l]) for l in range(layers - 1)]
    twcat = [tt(t["w0"])] + [tt(t["wr"][l]) for l in range(layers - 1)]
    m = None if masks is None else torch.from_numpy(masks)
    keep = KEEP if masks is not None else 1.0
    x, tx = tt(p["x"]), tt(t["x"])
    (_, h_all, c_all, gates, _, th_all, tc_all, tgates) = fh.hvp_fwd_plain(
        x, wcat, tt(p["b"]), m, keep, dt, tx, twcat, tt(t["b"]))
    out = fh.hvp_bwd_plain(tt(g), x, h_all, c_all, gates, wcat, m, keep, dt, tt(tg), tx, th_all,
                           tc_all, tgates, twcat)
    tdx, tdw, tdb = fh.hvp_backward_schedule(
        tt(tg), x, tx, h_all, th_all, c_all, tc_all, gates, tgates, wcat, twcat, m, keep, dt,
        out[3:6], pieces)
    return [tdx, *tdw, tdb], [out[6], *out[7], out[8]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layers,with_masks", [(3, True), (3, False), (1, False)])
def test_row11_schedule_matches_pallas_body(dtype, layers, with_masks):
    jdt, tdt = DTYPES[dtype]
    p, t, g, tg, masks = _stack_inputs(layers + 10 * with_masks, layers, with_masks)
    keep = KEEP if masks is not None else 1.0
    fwd_op, bwd_op = jax_fh.hvp_stack_ops(dtype, True, keep, masks is not None)
    extra = () if masks is None else (jnp.asarray(masks),)
    j = lambda d: tuple(jnp.asarray(d[k]) for k in ("x", "w0", "wr", "b"))  # noqa: E731
    with jax_fh.force_interpret():
        (_, h_all, c_all), (_, th_all, tc_all) = jax.jvp(
            lambda *a: fwd_op(*a, *extra), j(p), j(t))
        bprim = (jnp.asarray(g), j(p)[0], h_all, c_all, *j(p)[1:])
        btan = (jnp.asarray(tg), j(t)[0], th_all, tc_all, *j(t)[1:])
        _, (tdx, tdw0, tdwr, tdb) = jax.jvp(lambda *a: bwd_op(*a, *extra), bprim, btan)
    ref = [tdx, tdw0, *[tdwr[l] for l in range(layers - 1)], tdb]
    got, _ = _row11(p, t, g, tg, masks, layers, tdt)
    assert len(got) == len(ref)
    for i, (a, r) in enumerate(zip(got, ref)):
        r = np.asarray(r.astype(jnp.float32))
        assert a.shape == r.shape, i
        assert _rel(a.numpy(), r) <= HVP_TOL[dtype], (i, _rel(a.numpy(), r))


@pytest.mark.parametrize("layers,with_masks", [(3, True), (2, False), (1, False)])
def test_row11_schedule_matches_stagewise_float64(layers, with_masks):
    p, t, g, tg, masks = _stack_inputs(20 + layers, layers, with_masks, np.float64)
    got, ref = _row11(p, t, g, tg, masks, layers, torch.float64)
    for i, (a, r) in enumerate(zip(got, ref)):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, r, rtol=1e-10, atol=1e-10, msg=str(i))


@pytest.mark.parametrize("t_len", [1, 6])
def test_tangent_recurrence_is_the_jvp_of_the_backward_recurrence(t_len):
    """The plain tangent recurrence from (g, gates, c, wh) along (tg,
    tgates, tc, twh), with p = dgates[t+1] @ twh^T, against torch.func.jvp of
    `scan_backward_plain`; the bias tangent is the column sums."""
    rng = np.random.default_rng(t_len)
    f64 = lambda *shape: torch.from_numpy(rng.normal(size=shape))  # noqa: E731
    pre = f64(t_len, B, 4, H)
    gates = torch.cat([torch.sigmoid(pre[:, :, :2]), torch.tanh(pre[:, :, 2:3]),
                       torch.sigmoid(pre[:, :, 3:])], dim=2).reshape(t_len, B, 4 * H)
    g, c, wh = f64(t_len, B, H), f64(t_len, B, H), f64(H, 4 * H) * H ** -0.5
    tg, tgates, tc, twh = f64(t_len, B, H), f64(t_len, B, 4 * H), f64(t_len, B, H), f64(H, 4 * H)
    dt = torch.float64
    (dgates, dh, dc), (tdgates_ref, _, _) = torch.func.jvp(
        lambda *a: scan_backward_plain(*a, dt, carries=True), (g, gates, c, wh),
        (tg, tgates, tc, twh))
    p = (dgates[1:] @ twh.t()).reshape(t_len - 1, B, H)
    out, db = torch.empty_like(tgates), torch.empty(4 * H, dtype=dt)
    fh._tangent_recurrence_plain(tg, p, gates, tgates, c, tc, dh, dc, wh, dt, out, db)
    torch.testing.assert_close(out, tdgates_ref, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(db, tdgates_ref.sum(dim=(0, 1)), rtol=1e-10, atol=1e-10)


def _split_inputs(layers, with_masks, seed):
    """numpy x [T, B, C], wx0, wxr (a dummy layer when L = 1), wh, b2d and
    int8 masks [L-1, T, B, H] (or None)."""
    rng = np.random.default_rng(seed)
    ps = jax.tree.map(np.array, jax_init_lstm(jax.random.key(seed), C, H, layers))["layers"]
    wxr = (np.stack([q["wx"] for q in ps[1:]]) if layers > 1
           else np.zeros((1, H, 4 * H), np.float32))
    w = (ps[0]["wx"], wxr, np.stack([q["wh"] for q in ps]), np.stack([q["b"] for q in ps]))
    x = rng.normal(size=(T, B, C)).astype(np.float32)
    masks = (rng.uniform(size=(layers - 1, T, B, H)) < KEEP).astype(np.int8) \
        if with_masks and layers > 1 else None
    return x, w, masks


def _port_weights(w, layers):
    wx0, wxr, wh, b2d = (torch.from_numpy(a) for a in w)
    return wx0, wxr[:layers - 1], wh, b2d


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layers,with_masks", [(1, False), (3, False), (3, True)])
def test_row14_schedule_matches_pallas_body(dtype, layers, with_masks):
    jdt, tdt = DTYPES[dtype]
    x, w, masks = _split_inputs(layers, with_masks, 4 * layers + with_masks)
    keep = KEEP if masks is not None else 1.0
    jm = None if masks is None else jnp.asarray(masks)
    h_all, c_all, h_last = jax_fls._fwd_pallas(jnp.asarray(x), *(jnp.asarray(a) for a in w), jm,
                                                jdt, True, keep)
    tm = None if masks is None else torch.from_numpy(masks)
    got = fls.split_forward_schedule(torch.from_numpy(x), *_port_weights(w, layers), tm, keep,
                                     tdt, fls.FWD_PLAIN_PIECES)
    assert got[1].dtype == got[2].dtype == tdt and got[0].dtype == torch.float32
    for name, a, r in zip(("h_last", "h_all", "c_all"), got, (h_last, h_all, c_all)):
        r = np.asarray(r.astype(jnp.float32))
        assert a.shape == r.shape, name
        np.testing.assert_allclose(a.float().numpy(), r, rtol=TOL[dtype], atol=TOL[dtype],
                                   err_msg=name)
    # The eval route: no residuals, the same last h to the bit.
    last = fls.split_forward_schedule(torch.from_numpy(x), *_port_weights(w, layers), tm, keep,
                                      tdt, fls.FWD_PLAIN_PIECES, residuals=False)
    assert last[1] is None and last[2] is None
    torch.testing.assert_close(last[0], got[0], rtol=0, atol=0)


def test_row14_schedule_float64_and_masked_input_rounds_once():
    """float64: every output against `split_forward_plain`. bfloat16 with
    masks: the product of layer 1 reads round(h * mask / keep) from layer
    0's float32 h (JAX's rounding point), which differs from round(round(h)
    * mask / keep) (1 / keep is no power of two)."""
    x, w, masks = _split_inputs(2, True, 9)
    tx, tm = torch.from_numpy(x), torch.from_numpy(masks)
    wx0, wxr, wh, b2d = _port_weights(w, 2)
    dt = torch.float64
    got = fls.split_forward_schedule(tx.double(), wx0.double(), wxr.double(), wh.double(),
                                     b2d.double(), tm, KEEP, dt, fls.FWD_PLAIN_PIECES)
    ref = fls.split_forward_plain(tx.double(), wx0.double(), wxr.double(), wh.double(),
                                  b2d.double(), tm, KEEP, dt)
    for a, r in zip(got, ref):
        assert a.dtype == r.dtype
        torch.testing.assert_close(a, r, rtol=1e-10, atol=1e-10)

    inputs = []

    def product(a, b, **kw):
        inputs.append(a.clone())
        return gemm_nn_plain(a, b, **kw)

    bf = torch.bfloat16
    fls.split_forward_schedule(tx, wx0, wxr, wh, b2d, tm, KEEP, bf,
                               fls.ForwardPieces(product, fls._forward_recurrence_plain))
    gates = gemm_nn_plain(tx, wx0, compute_dtype=bf)
    h32 = torch.empty((T, B, H))
    fls._forward_recurrence_plain(gates, wh[0], b2d[0], bf, h32, torch.empty_like(h32))
    scale = tm[0].float() * (1 / KEEP)
    once, twice = (h32 * scale).to(bf), (h32.to(bf).float() * scale).to(bf)
    torch.testing.assert_close(inputs[1], once, rtol=0, atol=0)
    assert (twice != once).any()
