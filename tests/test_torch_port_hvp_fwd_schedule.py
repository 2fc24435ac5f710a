"""Row 10's layer-by-layer schedule (the tangent of the merged LSTM stack's
training forward, second-order MAML) and row 18's route (one layer's
recurrence on the cluster forward recurrence), on their plain pieces,
against the JAX package on the CPU.

  * `fused_lstm_hvp.hvp_forward_schedule` on `PLAIN_HVP_FWD_PIECES` (the
    plain product of two operand pairs, the plain tangent forward
    recurrence), from row 4's residuals at the same point
    (`fused_lstm_stack.forward_schedule` on its plain pieces), against JAX's
    `_hvpfwd_pallas_m(..., interpret=True)` (`_hvpfwd_kernel_m` in the
    Pallas interpreter) on the same numpy inputs and int8 masks: th_all,
    tc_all and th_last; float32 and bfloat16, masks on and off, one and
    three layers.
  * The schedule's tangent gates against their formula from its own
    residuals: slopes(gates) * (round(tin) @ Wx + round(in) @ tWx +
    round(h_{t-1}) @ tWh + round(th_{t-1}) @ Wh + tb), with the next
    layer's tin from the float32 th; in float64 every output against the
    stage-by-stage `hvp_fwd_plain`.
  * `tangent_forward_plan`'s table and refusal.
  * Row 18: `lstm_scan.scan_forward_plain` (the route's plain piece: the
    forward recurrence with no bias array) against JAX's
    `lstm_scan._fwd_pallas(..., interpret=True)`: h_all and c_all (float32
    whatever the compute dtype); float32 and bfloat16.

Tolerances: float32 1e-5 (max|diff| / max|ref|: JAX sums the four tangent
products in one contraction, the schedule in three), bfloat16 5e-2 (the
schedule reads row 4's rounded c, JAX recomputes it), float64 1e-10.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from weatherforecast_stgcn_maml_tpu.ops import fused_lstm_hvp as jax_fh
from weatherforecast_stgcn_maml_tpu.ops import lstm_scan as jax_scan
from weatherforecast_stgcn_maml_tpu_torch.models.common import apply_mask, as_operand
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm_hvp as fh
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm_stack as fls
from weatherforecast_stgcn_maml_tpu_torch.ops import lstm_scan

torch.set_num_threads(1)  # small tensors; more threads oversubscribe side-by-side workers

T, B, C, H = 5, 16, 24, 8  # tests/test_torch_port_hvp_schedule.py's widths
KEEP = 0.75
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
    masks = None
    if with_masks and layers > 1:
        masks = (rng.uniform(size=(layers - 1, T, B, H)) < KEEP).astype(np.int8)
    return p, t, masks


def _row10(p, t, masks, layers, dt):
    """Row 4's plain schedule at the point, then row 10's schedule on its
    plain pieces: (x, tx, wcat, twcat, tb, masks, keep, row 4's residuals,
    (th_last, th_all, tc_all, tgates))."""
    ad = torch.float64 if dt == torch.float64 else torch.float32
    tt = lambda a: torch.from_numpy(np.asarray(a)).to(ad)  # noqa: E731
    wcat = [tt(p["w0"])] + [tt(p["wr"][l]) for l in range(layers - 1)]
    twcat = [tt(t["w0"])] + [tt(t["wr"][l]) for l in range(layers - 1)]
    m = None if masks is None else torch.from_numpy(masks)
    keep = KEEP if masks is not None else 1.0
    x, tx, tb = tt(p["x"]), tt(t["x"]), tt(t["b"])
    res = fls.forward_schedule(x, m, keep, dt, tt(p["b"]), wcat, fls.FWD_PLAIN_PIECES)[1:]
    out = fh.hvp_forward_schedule(x, tx, wcat, twcat, tb, m, keep, dt, res,
                                  fh.PLAIN_HVP_FWD_PIECES)
    return x, tx, wcat, twcat, tb, m, keep, res, out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layers,with_masks", [(3, True), (3, False), (1, False)])
def test_row10_schedule_matches_pallas_body(dtype, layers, with_masks):
    jdt, tdt = DTYPES[dtype]
    p, t, masks = _stack_inputs(layers + 10 * with_masks, layers, with_masks)
    keep = KEEP if masks is not None else 1.0
    j = lambda d, k: jnp.asarray(d[k])  # noqa: E731
    with jax_fh.force_interpret():
        _, _, th_all, tc_all, _, th_last = jax_fh._hvpfwd_pallas_m(
            j(p, "x"), j(t, "x"), j(p, "w0"), j(t, "w0"), j(p, "wr"), j(t, "wr"), j(p, "b"),
            j(t, "b"), None if masks is None else jnp.asarray(masks), jdt, True, keep)
    got = _row10(p, t, masks, layers, tdt)[-1]
    assert got[1].dtype == got[2].dtype == tdt
    assert got[0].dtype == got[3].dtype == torch.float32
    for name, g, r in zip(("th_last", "th_all", "tc_all"), got, (th_last, th_all, tc_all)):
        r = np.asarray(r.astype(jnp.float32))
        assert g.shape == r.shape, name
        assert _rel(g.float().numpy(), r) <= TOL[dtype], (name, _rel(g.float().numpy(), r))


@pytest.mark.parametrize("with_masks", [True, False])
def test_row10_schedule_tangent_gates_and_float64(with_masks):
    """float32: the tangent gates from the schedule's own residuals and
    tangents, by their formula; float64: every output against
    `hvp_fwd_plain`."""
    p, t, masks = _stack_inputs(7 + with_masks, 3, with_masks)
    x, tx, wcat, twcat, tb, m, keep, (h_all, c_all, gates), out = _row10(
        p, t, masks, 3, torch.float32)
    _, th_all, tc_all, tgates = out
    for l in range(3):
        k = C if l == 0 else H
        w, tw = wcat[l], twcat[l]
        inp, tinp = (x, tx) if l == 0 else (h_all[l - 1], th_all[l - 1])
        if l > 0 and m is not None:
            inp, tinp = apply_mask(inp, m[l - 1], keep), apply_mask(tinp, m[l - 1], keep)
        prev = lambda a: torch.cat([torch.zeros_like(a[:1]), a[:-1]])  # noqa: E731
        ds = (as_operand(tinp, torch.float32) @ w[:k] + as_operand(inp, torch.float32) @ tw[:k]
              + prev(h_all[l]) @ tw[k:] + prev(th_all[l]) @ w[k:] + tb[l])
        want = fh._gate_slopes(gates[l], H) * ds
        torch.testing.assert_close(tgates[l], want, rtol=1e-5, atol=1e-5, msg=str(l))
    p, t, masks = _stack_inputs(9 + with_masks, 3, with_masks, np.float64)
    x, tx, wcat, twcat, tb, m, keep, _, got = _row10(p, t, masks, 3, torch.float64)
    ref = fh.hvp_fwd_plain(x, wcat, torch.from_numpy(p["b"]), m, keep, torch.float64, tx, twcat,
                           tb)[4:]
    for name, g, r in zip(("th_last", "th_all", "tc_all", "tgates"), got, ref):
        assert g.dtype == torch.float64, name
        torch.testing.assert_close(g, r, rtol=1e-10, atol=1e-10, msg=name)


def test_row10_next_input_rounds_once():
    """bfloat16 with masks: the next layer's tin is round(th * mask / keep)
    from the float32 th, not from round(th); its in is round(round(h) *
    mask / keep) from row 4's stored h; beside it the next layer's stored h
    a step back (zero at t = 0)."""
    rng = np.random.default_rng(5)
    f32 = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    tgates, gates = f32(T, B, 4 * H), torch.sigmoid(f32(T, B, 4 * H))
    c, h, h_next = (f32(T, B, H).to(torch.bfloat16) for _ in range(3))
    wh, tb = f32(H, 4 * H) * 0.3, f32(4 * H) * 0.1
    mask = torch.from_numpy((rng.uniform(size=(T, B, H)) < KEEP).astype(np.int8))
    outs = {}
    for store in (torch.bfloat16, torch.float32):  # round(th), and th itself
        th_out = torch.empty((T, B, H), dtype=store)
        next_in = torch.empty((T, B, 3 * H), dtype=torch.bfloat16)
        fh._tangent_forward_recurrence_plain(tgates.clone(), gates, c, h, h_next, wh, tb,
                                             torch.bfloat16, th_out, torch.empty_like(th_out),
                                             mask=mask, inv_keep=1 / KEEP, next_in=next_in)
        outs[store] = (th_out, next_in)
    (th_bf, next_in), (th_f32, _) = outs[torch.bfloat16], outs[torch.float32]
    scale = mask.float() * (1 / KEEP)
    once = (th_f32 * scale).to(torch.bfloat16)
    twice = (th_bf.float() * scale).to(torch.bfloat16)
    torch.testing.assert_close(next_in[..., :H], once, rtol=0, atol=0)
    torch.testing.assert_close(next_in[..., H:2 * H], (h.float() * scale).to(torch.bfloat16),
                               rtol=0, atol=0)
    torch.testing.assert_close(next_in[1:, :, 2 * H:], h_next[:-1], rtol=0, atol=0)
    assert not next_in[0, :, 2 * H:].any()
    assert (twice != once).any()


@pytest.mark.parametrize("hidden,itemsize,rows,plan", [
    (128, 4, 512, (2, 64, 8)),    # the SO inner step, float32: 64 clusters of 2
    (128, 2, 512, (1, 128, 4)),   # bfloat16: Wh (128 KB) in one block
    (128, 4, 1024, (2, 64, 8)),   # two waves: row tiles stop at 8
    (256, 2, 512, (4, 64, 8)),
    (64, 4, 48, (1, 64, 2)),
])
def test_tangent_forward_plan(hidden, itemsize, rows, plan):
    """The forward recurrence's plan (`forward_plan`) with row tiles of at
    most 8 rows."""
    assert fh.tangent_forward_plan(hidden, rows, itemsize, 132) == plan
    cs, hcp, rb = plan
    assert fls.scan_fwd_smem(hidden, hcp, rb, itemsize) <= fls.SCAN_MAX_SMEM
    assert hcp >= fls.scan_units(hidden, cs)


def test_tangent_forward_plan_refuses_what_no_cluster_holds():
    with pytest.raises(ValueError, match="tangent forward recurrence holds Wh in at most 16"):
        fh.tangent_forward_plan(1024, 512, 4, 132)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", [8, 12])
def test_row18_plain_piece_matches_pallas_body(dtype, hidden):
    """h_all and c_all in float32 under either compute dtype (JAX's
    `_fwd_pallas` out_shape); hidden 12: a width the float32 card route
    takes (a multiple of 4) and the bfloat16 one refuses."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(hidden)
    xp = rng.normal(size=(T, B, 4 * hidden)).astype(np.float32)
    wh = (rng.normal(size=(hidden, 4 * hidden)) * 0.3).astype(np.float32)
    with jax_scan.force_interpret():
        h_all, c_all = jax_scan._fwd_pallas(jnp.asarray(xp), jnp.asarray(wh), jdt, True)
    got_h, got_c, gates = lstm_scan.scan_forward_plain(torch.from_numpy(xp),
                                                       torch.from_numpy(wh), tdt, True)
    assert got_h.dtype == got_c.dtype == gates.dtype == torch.float32
    for name, g, r in (("h_all", got_h, h_all), ("c_all", got_c, c_all)):
        assert np.asarray(r).dtype == np.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=TOL[dtype], atol=TOL[dtype],
                                   err_msg=name)
    assert lstm_scan.scan_forward_plain(torch.from_numpy(xp), torch.from_numpy(wh), tdt,
                                        False)[2] is None
