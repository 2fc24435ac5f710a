"""Row 4's layer-by-layer forward and row 13's backward schedule (the LSTM
stack's training forward on the GEMM core and a cluster recurrence, the
node-sharded GCN sandwich's backward on the GEMM core), on their plain
pieces, against the JAX package on the CPU.

  * `fused_lstm_stack.forward_schedule` on `FWD_PLAIN_PIECES` (the plain
    product, the plain forward recurrence) against JAX's `_fwd_pallas_m`
    (`_fwd_kernel_m` in the Pallas interpreter) on the same numpy inputs and
    int8 masks: h_last, h_all, c_all; float32 and bfloat16, masks on and
    off, one and three layers. The schedule's activated gates against their
    formula from its own residuals; in float64 against `lstm_stack_plain`.
    The next layer's input rounds once, from the float32 h (JAX's rounding
    point), not from round(h). `forward_plan`'s table and its refusal.
  * `fused_gcn_shard.backward_schedule` on row 7's `PLAIN_PIECES` against
    JAX's `_shard_layer_op(..., interpret=True)` under jax.vjp, from JAX's
    own forward residual: g2 only, g1 only and both, mask on and off, at a
    row count NL that is not a multiple of 8 (the zero padding of the A^T
    product's K) and at one that is.

Tolerances: float64 1e-10; float32 1e-5 (rtol = atol on the forward's
outputs and gates; max|diff| / max|ref| on gradients: the same products
summed in another order); bfloat16 5e-2.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from weatherforecast_stgcn_maml_tpu.models.lstm import init_lstm as jax_init_lstm
from weatherforecast_stgcn_maml_tpu.ops import fused_gcn_shard as jax_fgs
from weatherforecast_stgcn_maml_tpu.ops import fused_lstm_stack as jax_fls
from weatherforecast_stgcn_maml_tpu_torch.models.common import apply_mask, as_operand
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_gcn_shard as fgs
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_gcn_train as fgt
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm_stack as fls
from weatherforecast_stgcn_maml_tpu_torch.ops.fused_lstm_hvp import hvp_fwd_plain

torch.set_num_threads(1)  # small tensors; more threads oversubscribe side-by-side workers

T, B, C, H = 5, 16, 24, 8  # JAX tests/test_lstm_stack.py's widths
KEEP = 0.8
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _lstm_inputs(n_layers, with_masks, seed):
    """numpy x [T, B, C], wcat_l, b2d and int8 masks [L-1, T, B, H] (or None)."""
    rng = np.random.default_rng(seed)
    layers = jax.tree.map(np.array, jax_init_lstm(jax.random.key(seed), C, H, n_layers))
    wcat = [np.concatenate([p["wx"], p["wh"]]) for p in layers["layers"]]
    b2d = np.stack([p["b"] for p in layers["layers"]])
    x = rng.normal(size=(T, B, C)).astype(np.float32)
    masks = (rng.uniform(size=(n_layers - 1, T, B, H)) < KEEP).astype(np.int8) \
        if with_masks and n_layers > 1 else None
    return x, wcat, b2d, masks


def _schedule(x, wcat, b2d, masks, dt):
    t = torch.from_numpy
    return fls.forward_schedule(t(x), None if masks is None else t(masks), KEEP, dt, t(b2d),
                                [t(w) for w in wcat], fls.FWD_PLAIN_PIECES)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_layers,with_masks", [(1, False), (3, False), (3, True)])
def test_row4_schedule_matches_pallas_body(dtype, n_layers, with_masks):
    jdt, tdt = DTYPES[dtype]
    x, wcat, b2d, masks = _lstm_inputs(n_layers, with_masks, 3 * n_layers + with_masks)
    jwr = (jnp.asarray(np.stack(wcat[1:])) if n_layers > 1
           else jnp.zeros((1, 2 * H, 4 * H), jnp.float32))
    with jax_fls.force_interpret():
        h_all, c_all, h_last = jax_fls._fwd_pallas_m(
            jnp.asarray(x), jnp.asarray(wcat[0]), jwr, jnp.asarray(b2d),
            None if masks is None else jnp.asarray(masks), jdt, True, KEEP)
    got = _schedule(x, wcat, b2d, masks, tdt)
    assert got[1].dtype == got[2].dtype == tdt and got[0].dtype == got[3].dtype == torch.float32
    for name, g, r in zip(("h_last", "h_all", "c_all"), got, (h_last, h_all, c_all)):
        r = np.asarray(r.astype(jnp.float32))
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.float().numpy(), r, rtol=TOL[dtype], atol=TOL[dtype],
                                   err_msg=name)


@pytest.mark.parametrize("with_masks", [True, False])
def test_row4_schedule_gates_and_float64(with_masks):
    """float32: the stored gates are act(round(in_l) @ Wx_l + round(h_{t-1})
    @ Wh_l + b_l) from the schedule's own residuals; float64: every output
    against `lstm_stack_plain` and the stage-by-stage `hvp_fwd_plain`."""
    x, wcat, b2d, masks = _lstm_inputs(3, with_masks, 7 + with_masks)
    h_last, h_all, c_all, gates = _schedule(x, wcat, b2d, masks, torch.float32)
    tx, tw, tb = torch.from_numpy(x), [torch.from_numpy(w) for w in wcat], torch.from_numpy(b2d)
    tm = None if masks is None else torch.from_numpy(masks)
    for l, w in enumerate(tw):
        inp = tx if l == 0 else h_all[l - 1]
        if l > 0 and tm is not None:
            inp = apply_mask(inp, tm[l - 1], KEEP)
        h_prev = torch.cat([torch.zeros_like(h_all[l, :1]), h_all[l, :-1]])
        pre = (as_operand(inp, torch.float32) @ w[:-H] + h_prev @ w[-H:] + tb[l]).split(H, -1)
        want = torch.cat([torch.sigmoid(pre[0]), torch.sigmoid(pre[1]), torch.tanh(pre[2]),
                          torch.sigmoid(pre[3])], dim=-1)
        torch.testing.assert_close(gates[l], want, rtol=1e-5, atol=1e-5)
    dt = torch.float64
    got = fls.forward_schedule(tx.double(), tm, KEEP, dt, tb.double(), [w.double() for w in tw],
                               fls.FWD_PLAIN_PIECES)
    layers = [SimpleNamespace(wx=w[:-H].double(), wh=w[-H:].double(), b=b.double())
              for w, b in zip(tw, tb)]
    ref_last = fls.lstm_stack_plain(layers, tx.transpose(0, 1).double(), dt, tm, KEEP)
    torch.testing.assert_close(got[0], ref_last, rtol=1e-10, atol=1e-10)
    ref = hvp_fwd_plain(tx.double(), [w.double() for w in tw], tb.double(), tm, KEEP, dt)
    for g, r in zip(got, ref):
        assert g.dtype == dt
        torch.testing.assert_close(g, r, rtol=1e-10, atol=1e-10)


def test_row4_masked_input_rounds_once():
    """bfloat16 with masks: the next layer's input is round(h * mask /
    keep) from the float32 h; round(round(h) * mask / keep) differs from it
    (1 / keep = 1.25 is no power of two), so the schedule must not form it
    from h_all."""
    x, wcat, b2d, masks = _lstm_inputs(2, True, 11)
    gates = torch.from_numpy(x) @ as_operand(torch.from_numpy(wcat[0][:-H]), torch.bfloat16)
    wh, bias, mask = torch.from_numpy(wcat[0][-H:]), torch.from_numpy(b2d[0]), torch.from_numpy(
        masks[0])
    outs = {}
    for store in (torch.bfloat16, torch.float32):  # round(h), and h itself
        h_out = torch.empty((T, B, H), dtype=store)
        next_in = torch.empty((T, B, H), dtype=torch.bfloat16)
        fls._forward_recurrence_plain(gates.clone(), wh, bias, torch.bfloat16, h_out,
                                      torch.empty_like(h_out), mask=mask, inv_keep=1 / KEEP,
                                      next_in=next_in)
        outs[store] = (h_out, next_in)
    (h_bf, next_in), (h_f32, _) = outs[torch.bfloat16], outs[torch.float32]
    once = (h_f32 * (mask.float() * (1 / KEEP))).to(torch.bfloat16)
    twice = (h_bf.float() * (mask.float() * (1 / KEEP))).to(torch.bfloat16)
    torch.testing.assert_close(next_in, once, rtol=0, atol=0)
    assert (twice != once).any()


@pytest.mark.parametrize("hidden,itemsize,rows,plan", [
    (128, 4, 512, (2, 64, 8)),     # the inner step, float32: 64 clusters of 2
    (128, 2, 512, (1, 128, 4)),    # bfloat16: Wh (128 KB) in one block
    (128, 4, 1024, (2, 64, 16)),   # the adaptation step: two windows of rows
    (128, 2, 1024, (1, 128, 8)),
    (128, 4, 256, (2, 64, 4)),     # a node-sharded rank's 256 rows
    (256, 2, 512, (4, 64, 16)),
    (64, 4, 48, (1, 64, 2)),
])
def test_forward_plan(hidden, itemsize, rows, plan):
    """The smallest cluster whose Wh slice [H, 4, hcp] fits beside the
    tiles, with the smallest row tile that fills 132 SMs in one wave; all
    H of its K-rows resident."""
    assert fls.forward_plan(hidden, rows, itemsize, 132) == (*plan, hidden)
    cs, hcp, rb = plan
    assert fls.scan_fwd_smem(hidden, hcp, rb, itemsize) <= fls.SCAN_MAX_SMEM
    assert hcp >= fls.scan_units(hidden, cs)


def test_forward_plan_refuses_what_no_cluster_holds():
    """Past the clusters that hold Wh one task streams part of each slice
    (k_res < H); V tasks (row 16) and widths past H 2048 still raise."""
    assert fls.forward_plan(1024, 512, 4, 132)[3] < 1024
    with pytest.raises(ValueError, match="forward recurrence holds Wh in at most 16 blocks"):
        fls.forward_plan(1024, 512, 4, 132, 2)
    with pytest.raises(ValueError, match="nor does a streamed slice"):
        fls.forward_plan(2056, 512, 4, 132)


# Row 13: node-major on the port's side, [W, rows, C] on JAX's.


def _nm(a):
    return np.ascontiguousarray(np.swapaxes(np.asarray(a), 0, 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("has_mask", [True, False])
@pytest.mark.parametrize("cts", ["g2", "g1", "both"])
def test_row13_schedule_matches_pallas_body(dtype, has_mask, cts):
    """W 4, N 36, NL 12 (K of the A^T product padded to 16), hid 16 -> 8."""
    _row13_case(dtype, has_mask, cts, nl=12, n=36)


@pytest.mark.parametrize("cts", ["g2", "both"])
def test_row13_schedule_at_aligned_rows(cts):
    """NL 16 of N 32: no padding."""
    _row13_case("float32", True, cts, nl=16, n=32)


def _row13_case(dtype, has_mask, cts, nl, n, w=4, hid=16, hid_next=8):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(nl + has_mask + 3 * len(cts))
    f32 = np.float32
    hw_full = rng.normal(size=(w, n, hid)).astype(f32)
    a_rows = (rng.uniform(size=(nl, n)) / n).astype(f32)
    b = rng.normal(size=(hid,)).astype(f32)
    w_next = (rng.normal(size=(hid, hid_next)) * 0.3).astype(f32)
    mask = (rng.uniform(size=(w, nl, hid)) < KEEP).astype(np.int8)
    g1 = rng.normal(size=(w, nl, hid)).astype(f32) * (cts != "g2")
    g2 = rng.normal(size=(w, nl, hid_next)).astype(f32) * (cts != "g1")
    op = jax_fgs._shard_layer_op(dtype, True, KEEP, True, has_mask)
    jm = [jnp.asarray(mask)] if has_mask else []
    (h_post, _), vjp = jax.vjp(lambda hw, bb, wn: op(hw, jnp.asarray(a_rows), bb, wn, *jm),
                               jnp.asarray(hw_full).astype(jdt), jnp.asarray(b)[None],
                               jnp.asarray(w_next))
    ref = vjp((jnp.asarray(g1).astype(jdt), jnp.asarray(g2).astype(jdt)))
    t = torch.from_numpy
    got = fgs.backward_schedule(
        None if cts == "g2" else t(_nm(g1)).to(tdt), None if cts == "g1" else t(_nm(g2)).to(tdt),
        t(_nm(h_post.astype(jnp.float32))).to(tdt), t(a_rows), t(w_next),
        t(_nm(mask)) if has_mask else None, 1 / KEEP, tdt, tdt, fgt.PLAIN_PIECES)
    assert got[0].dtype == tdt and got[0].shape == (n, w, hid)
    refs = (_nm(ref[0].astype(jnp.float32)), ref[1][0], ref[2])
    for name, g, r in zip(("d_hw_full", "db", "dw_next"), got, refs):
        if name == "dw_next" and cts == "g1":  # no cotangent of hw_next: zero
            assert not g.any() and not np.asarray(r).any()
            continue
        assert _rel(g.float().numpy(), r) <= TOL[dtype], (name, _rel(g.float().numpy(), r))
