"""Kernel row 5's layer-by-layer schedule, the backward recurrence's cluster
plan and row 1's layer loop, on the CPU.

  * `merged_backward_schedule` (row 5: the merged stack's training backward
    from row 4's stored gates) on its plain pieces against the
    stage-by-stage `fused_lstm_hvp.hvp_bwd_plain` (all six outputs: dx,
    the weight and bias gradients, dgates and each stage's dh and dc) and
    against JAX's `_bwd_pallas_m` (`_bwd_kernel_m` in the Pallas
    interpreter) on the same numpy inputs, JAX's residuals and int8 masks;
    one to three layers, the input wider than the hidden width, masks on
    and off; float64 against `hvp_bwd_plain`;
  * with the second-order carries every layer's dgates kept while the
    weight gradients still run layer by layer, the gradients bitwise those
    of the first-order call (which keeps none);
  * the plain recurrence's dh / dc carries against autograd of a plain
    recurrence;
  * `recurrence_plan` (the cluster size, weight columns and row tile of
    csrc/lstm_scan_bwd.cuh) and `recurrence_weights` (its column slices of
    Wh^T) at the widths the card runs;
  * `gcn_stack_schedule` (row 1's two products a layer) on `gemm_nn_plain`
    against JAX's `_pallas_stack` (`_stack_kernel` in the TPU interpreter),
    float32 and bfloat16, one and four layers, and against
    `gcn_stack_plain` in float64.

Tolerances: float64 1e-10 (the same operations in another order); float32
1e-5 on dx and on the gate gradients, max|diff| / max|ref| <= 1e-5 on the
weight gradients and the carries (sums over every step and row, or
chains over every step, in another order); bfloat16 5e-2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from weatherforecast_stgcn_maml_tpu.models.lstm import init_lstm as jax_init_lstm
from weatherforecast_stgcn_maml_tpu.ops import fused_gcn as jax_fgcn
from weatherforecast_stgcn_maml_tpu.ops import fused_lstm_stack as jax_fls
from weatherforecast_stgcn_maml_tpu_torch.models.common import Dense, apply_mask, as_operand
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_gcn
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm_stack as fls
from weatherforecast_stgcn_maml_tpu_torch.ops.fused_lstm_hvp import hvp_bwd_plain, hvp_fwd_plain
from weatherforecast_stgcn_maml_tpu_torch.ops.gemm import gemm_nn_plain
from weatherforecast_stgcn_maml_tpu_torch.ops.lstm_scan import scan_backward_plain

torch.set_num_threads(1)  # small tensors; more threads oversubscribe side-by-side workers

T, B, C, H = 5, 16, 24, 8  # JAX tests/test_lstm_stack.py's widths
CASES = [(1, False), (2, False), (2, True), (3, False), (3, True)]  # (layers, masks)
NAMES = ("dx", "dwcat", "db", "dgates", "dh_all", "dc_all")


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def _inputs(n_layers, with_masks, seed):
    rng = np.random.default_rng(seed)
    layers = jax.tree.map(np.array, jax_init_lstm(jax.random.key(seed), C, H, n_layers))
    wcat = [np.concatenate([p["wx"], p["wh"]]) for p in layers["layers"]]
    b2d = np.stack([p["b"] for p in layers["layers"]])
    x = rng.normal(size=(T, B, C)).astype(np.float32)
    masks = (rng.uniform(size=(n_layers - 1, T, B, H)) >= 0.3).astype(np.int8) \
        if with_masks else None
    g = rng.normal(size=(B, H)).astype(np.float32)
    return g, x, wcat, b2d, masks, 0.7 if with_masks else 1.0


def _gates(x, h_all, wcat, b2d, masks, keep):
    """Each stage's activated gates from the forward's residuals, as row 4
    stores them: act(round(in_l) @ Wx_l + round(h_{t-1}) @ Wh_l + b_l)."""
    out = []
    for l, w in enumerate(wcat):
        inp = x if l == 0 else h_all[l - 1].float()
        if l > 0 and masks is not None:
            inp = apply_mask(inp, masks[l - 1], keep)
        h_prev = torch.cat([torch.zeros_like(h_all[l, :1]), h_all[l, :-1]]).float()
        pre = (as_operand(inp, torch.float32) @ as_operand(w[:-H], torch.float32)
               + as_operand(h_prev, torch.float32) @ as_operand(w[-H:], torch.float32) + b2d[l])
        i, f, gg, o = pre.split(H, dim=-1)
        out.append(torch.cat([torch.sigmoid(i), torch.sigmoid(f), torch.tanh(gg),
                              torch.sigmoid(o)], dim=-1))
    return torch.stack(out)


def _check(got, ref, name):
    assert got.shape == ref.shape, name
    if name in ("dx", "dgates"):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    else:
        assert _rel(got, ref) <= 1e-5, (name, _rel(got, ref))


@pytest.mark.parametrize("n_layers,with_masks", CASES)
def test_merged_schedule_matches_stage_by_stage_and_jax(n_layers, with_masks):
    """Float32, from JAX's residuals (`_fwd_pallas_m` in the interpreter) and
    the gates they give: the schedule on `PLAIN_PIECES` against
    `hvp_bwd_plain` (all six outputs) and against `_bwd_pallas_m`; float64:
    against `hvp_bwd_plain` from float64 residuals."""
    g, x, wcat, b2d, masks, keep = _inputs(n_layers, with_masks, 20 + 2 * n_layers + with_masks)
    jw0 = jnp.asarray(wcat[0])
    jwr = (jnp.asarray(np.stack(wcat[1:])) if n_layers > 1
           else jnp.zeros((1, 2 * H, 4 * H), jnp.float32))  # JAX's placeholder (dwcatr: zeros)
    jm = None if masks is None else jnp.asarray(masks)
    with jax_fls.force_interpret():
        h_all, c_all, _ = jax_fls._fwd_pallas_m(jnp.asarray(x), jw0, jwr, jnp.asarray(b2d), jm,
                                                jnp.float32, True, keep)
        ref_jax = jax_fls._bwd_pallas_m(jnp.asarray(g), jnp.asarray(x), h_all, c_all, jw0, jwr,
                                        jnp.asarray(b2d), jm, jnp.float32, True, keep)
    tm = None if masks is None else torch.from_numpy(masks)
    tg, tx = torch.from_numpy(g), torch.from_numpy(x)
    th, tc = (torch.from_numpy(np.array(a)) for a in (h_all, c_all))
    tw = [torch.from_numpy(w) for w in wcat]
    gates = _gates(tx, th, tw, torch.from_numpy(b2d), tm, keep)
    got = fls.merged_backward_schedule(tg, tx, th, tc, gates, tw, tm, keep, torch.float32,
                                       fls.PLAIN_PIECES, carries=True)
    ref = hvp_bwd_plain(tg, tx, th, tc, gates, tw, tm, keep, torch.float32)
    for name, a, r in zip(NAMES, got, ref):
        if name == "dwcat":
            assert len(a) == len(r) == n_layers
            for l, (al, rl) in enumerate(zip(a, r)):
                _check(al, rl, f"dwcat[{l}]")
        else:
            _check(a, r, name)
    dx, dwcat, db = got[:3]
    jdx, jdw0, jdwr, jdb = (torch.from_numpy(np.array(a)) for a in ref_jax)
    _check(dx, jdx, "dx")
    _check(dwcat[0], jdw0, "dwcat[0]")
    _check(db, jdb, "db")
    if n_layers > 1:
        _check(torch.stack(dwcat[1:]), jdwr, "dwcatr")
    else:
        assert not jdwr.any()

    w64 = [w.double() for w in tw]
    _, h64, c64, gates64 = hvp_fwd_plain(tx.double(), w64, torch.from_numpy(b2d).double(), tm,
                                         keep, torch.float64)
    got = fls.merged_backward_schedule(tg.double(), tx.double(), h64, c64, gates64, w64, tm,
                                       keep, torch.float64, fls.PLAIN_PIECES, carries=True)
    ref = hvp_bwd_plain(tg.double(), tx.double(), h64, c64, gates64, w64, tm, keep,
                        torch.float64)
    for name, a, r in zip(NAMES, got, ref):
        for al, rl in zip(a, r) if name == "dwcat" else [(a, r)]:
            assert al.dtype == torch.float64, name
            torch.testing.assert_close(al, rl, rtol=1e-10, atol=1e-10)


def test_merged_schedule_without_carries_returns_none():
    """Without `carries` the schedule keeps no dh / dc (first order)."""
    g, x, wcat, b2d, masks, keep = _inputs(2, True, 5)
    tw = [torch.from_numpy(w) for w in wcat]
    tm = torch.from_numpy(masks)
    _, h_all, c_all, gates = hvp_fwd_plain(torch.from_numpy(x), tw, torch.from_numpy(b2d), tm,
                                           keep, torch.float32)
    out = fls.merged_backward_schedule(torch.from_numpy(g), torch.from_numpy(x), h_all, c_all,
                                       gates, tw, tm, keep, torch.float32, fls.PLAIN_PIECES)
    assert out[4] is None and out[5] is None
    ref = hvp_bwd_plain(torch.from_numpy(g), torch.from_numpy(x), h_all, c_all, gates, tw, tm,
                        keep, torch.float32)
    torch.testing.assert_close(out[0], ref[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-10)])
@pytest.mark.parametrize("n_layers,with_masks", [(1, False), (3, True)])
def test_merged_schedule_carries_keep_every_layer(dtype, tol, n_layers, with_masks):
    """With `carries` (second order) the weight gradients still run layer by
    layer, each on its layer's slice of the kept [L, T, B, 4H] dgates:
    every layer's dgates, dh and dc and every weight gradient against the
    stage-by-stage `hvp_bwd_plain`; dx, [dwcat_l] and db equal, bit for
    bit, to the first-order call's, which keeps no dgates."""
    g, x, wcat, b2d, masks, keep = _inputs(n_layers, with_masks, 40 + n_layers)
    tg, tx, tb = (torch.from_numpy(a).to(dtype) for a in (g, x, b2d))
    tw = [torch.from_numpy(w).to(dtype) for w in wcat]
    tm = None if masks is None else torch.from_numpy(masks)
    _, h_all, c_all, gates = hvp_fwd_plain(tx, tw, tb, tm, keep, dtype)
    args = (tg, tx, h_all, c_all, gates, tw, tm, keep, dtype, fls.PLAIN_PIECES)
    got = fls.merged_backward_schedule(*args, carries=True)
    first = fls.merged_backward_schedule(*args)
    ref = hvp_bwd_plain(tg, tx, h_all, c_all, gates, tw, tm, keep, dtype)
    assert got[3].shape == (n_layers, T, B, 4 * H) and first[3:] == (None, None, None)
    for name, a, f, r in zip(NAMES, got, first, ref):
        for al, fl, rl in zip(a, f, r) if name == "dwcat" else [(a, f, r)]:
            assert al.dtype == dtype and al.shape == rl.shape, name
            assert _rel(al, rl) <= tol, (name, _rel(al, rl))
            if fl is not None:
                assert torch.equal(al, fl), name


@pytest.mark.parametrize("t_len,rows,hidden", [(6, 5, 8), (1, 3, 4)])
def test_plain_recurrence_carries_match_autograd(t_len, rows, hidden):
    """`scan_backward_plain(..., carries=True)`: dgates, each step's dh (the
    gradient of h_t through every later step) and dc (of c_t) against
    autograd of a plain recurrence, float64."""
    gen = torch.Generator().manual_seed(t_len)
    xp = torch.randn((t_len, rows, 4 * hidden), generator=gen, dtype=torch.float64)
    wh = torch.randn((hidden, 4 * hidden), generator=gen, dtype=torch.float64) / hidden ** 0.5
    g = torch.randn((t_len, rows, hidden), generator=gen, dtype=torch.float64)
    pre = xp.clone().requires_grad_(True)
    h = torch.zeros((rows, hidden), dtype=torch.float64)
    c = torch.zeros_like(h)
    hs, cs, gates = [], [], []
    for t in range(t_len):
        i, f, gg, o = (pre[t] + h @ wh).split(hidden, dim=-1)
        i, f, gg, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(gg), torch.sigmoid(o)
        c = f * c + i * gg
        h = o * torch.tanh(c)
        c.retain_grad()
        h.retain_grad()
        hs.append(h)
        cs.append(c)
        gates.append(torch.cat([i, f, gg, o], dim=-1).detach())
    (torch.stack(hs) * g).sum().backward()
    dgates, dh, dc = scan_backward_plain(g, torch.stack(gates), torch.stack(cs).detach(), wh,
                                         torch.float64, carries=True)
    torch.testing.assert_close(dgates, pre.grad, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(dh, torch.stack([v.grad for v in hs]), rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(dc, torch.stack([v.grad for v in cs]), rtol=1e-10, atol=1e-10)
    alone = scan_backward_plain(g, torch.stack(gates), torch.stack(cs).detach(), wh,
                                torch.float64)
    torch.testing.assert_close(alone, dgates, rtol=0, atol=0)


@pytest.mark.parametrize("hidden,itemsize,rows,plan", [
    (128, 4, 512, (2, 64, 8)),     # the inner step, float32: 64 clusters of 2
    (128, 2, 512, (1, 128, 4)),    # bfloat16: Wh^T (128 KB) in one block
    (128, 4, 1024, (2, 64, 16)),   # adaptation: two windows folded into the rows
    (128, 4, 256, (2, 64, 4)),     # the node-sharded step: 256 rows a rank
    (128, 2, 1024, (1, 128, 8)),
    (64, 4, 48, (1, 64, 2)),
    (64, 2, 48, (1, 64, 2)),
    (256, 4, 48, (8, 32, 4)),      # 1 MB of float32 Wh^T over 8 blocks
    (256, 2, 48, (4, 64, 2)),
    (12, 4, 100, (1, 32, 2)),      # a width under one warp's units
])
def test_recurrence_plan(hidden, itemsize, rows, plan):
    """The cluster plan at the widths the card runs (132 SMs): each fits in
    a block's shared memory and puts the clusters in one wave."""
    got = fls.recurrence_plan(hidden, rows, itemsize, 132)
    assert got == (*plan, 4 * hidden)  # every K-row of the slice resident
    cs, hcp, rb = plan
    assert fls.scan_units(hidden, cs) <= hcp
    assert fls.scan_smem(hidden, hcp, rb, itemsize) <= fls.SCAN_MAX_SMEM
    assert -(-rows // rb) * cs <= 132


def test_recurrence_plan_past_one_wave_and_refusal():
    """Rows past one wave take the smallest cluster's largest tile; a width
    whose Wh^T fits no cluster of 16 streams part of each slice for one
    task (k_res < 4H) and raises for two."""
    assert fls.recurrence_plan(32, 5000, 4, 132) == (1, 32, 16, 128)
    assert fls.recurrence_plan(512, 512, 4, 132)[3] < 4 * 512
    with pytest.raises(ValueError, match="does not fit"):
        fls.recurrence_plan(512, 512, 4, 132, 2)


@pytest.mark.parametrize("hidden,cs,hcp", [(128, 2, 64), (128, 1, 128), (12, 1, 32),
                                           (100, 2, 64), (256, 8, 32)])
def test_recurrence_weights_are_column_slices(hidden, cs, hcp):
    """Slice b holds Wh^T's columns b * hc .. b * hc + hc - 1, in the
    compute dtype, zeros past H and past hc."""
    gen = torch.Generator().manual_seed(hidden)
    wh = torch.randn((hidden, 4 * hidden), generator=gen)
    for dtype in (torch.float32, torch.bfloat16):
        wts = fls.recurrence_weights(wh, cs, hcp, dtype)
        assert wts.shape == (cs, 4 * hidden, hcp) and wts.dtype == dtype
        assert wts.is_contiguous()
        hc = fls.scan_units(hidden, cs)
        wt = wh.to(dtype).t()
        for b in range(cs):
            n = max(0, min(hc, hidden - b * hc))
            torch.testing.assert_close(wts[b, :, :n], wt[:, b * hc:b * hc + n], rtol=0, atol=0)
            assert not wts[b, :, n:].any()


def _gcn_inputs(n_layers, seed, slices=3, nodes=128, c_in=24, hidden=32):
    rng = np.random.default_rng(seed)
    widths = [c_in] + [hidden] * n_layers
    ws = [(rng.normal(size=(a, b)) / a ** 0.5).astype(np.float32)
          for a, b in zip(widths, widths[1:])]
    bs = [(rng.normal(size=(b,)) * 0.1).astype(np.float32) for b in widths[1:]]
    a = np.abs(rng.normal(size=(nodes, nodes))).astype(np.float32)
    a_hat = (a / a.sum(axis=1, keepdims=True)).astype(np.float32)
    h = rng.normal(size=(slices, nodes, c_in)).astype(np.float32)
    return ws, bs, a_hat, h


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_layers", [1, 4])
def test_gcn_stack_schedule_matches_pallas_stack(dtype, n_layers):
    """Row 1's layer loop on `gemm_nn_plain` against `_stack_kernel` through
    `_pallas_stack` in the TPU interpreter, h [3, 128, 24] -> 32 channels."""
    ws, bs, a_hat, h = _gcn_inputs(n_layers, 40 + n_layers)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_fgcn._pallas_stack([jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs],
                                     jnp.asarray(a_hat), jnp.asarray(h), getattr(jnp, dtype))
    got = fused_gcn.gcn_stack_schedule(
        [torch.from_numpy(w) for w in ws], [torch.from_numpy(b) for b in bs],
        torch.from_numpy(a_hat), torch.from_numpy(h), getattr(torch, dtype),
        product=gemm_nn_plain)
    assert got.dtype == torch.float32 and got.shape == (3, 128, 32)
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=tol, atol=tol)


def test_gcn_stack_schedule_matches_plain_float64():
    """Row 1's layer loop against `gcn_stack_plain` (the layerwise route),
    float64, 4 layers, at a width that takes padding (20 -> 24 channels)."""
    ws, bs, a_hat, h = _gcn_inputs(4, 7, c_in=20, hidden=36)
    layers = [Dense(torch.from_numpy(w).double(), torch.from_numpy(b).double())
              for w, b in zip(ws, bs)]
    got = fused_gcn.gcn_stack_schedule([p.w for p in layers], [p.b for p in layers],
                                       torch.from_numpy(a_hat).double(),
                                       torch.from_numpy(h).double(), torch.float64,
                                       product=gemm_nn_plain)
    ref = fused_gcn.gcn_stack_plain(layers, torch.from_numpy(a_hat).double(),
                                    torch.from_numpy(h).double(), torch.float64)
    torch.testing.assert_close(got.double(), ref, rtol=1e-10, atol=1e-10)
