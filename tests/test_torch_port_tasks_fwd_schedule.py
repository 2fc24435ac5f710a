"""Kernel row 16's layer-by-layer schedule with a task axis and row 19's
backward schedule, on their plain pieces, against the JAX package on the
CPU.

  * `fused_lstm_stack.tasks_forward_schedule` (row 16: the merged LSTM
    stack's training forward for V tasks, each with its own weights) on
    `FWD_PLAIN_PIECES` against JAX's `_fwd_pallas_mv` (`_fwd_kernel_mv` in
    the Pallas interpreter, under `force_interpret`) on the same numpy inputs
    and int8 masks: h_last, h_all and c_all; V = 2 and 3, one to three
    layers, masks on and off, float32 and bfloat16. In float64 against
    `lstm_stack_tasks_plain` (h_last) and, task by task, against row 4's
    `forward_schedule` (every output).
  * `forward_plan` with a task count: one task keeps row 4's plans, two
    tasks at 512 rows double the row tile (the plans the card runs).
  * `lstm_scan.scan_backward_schedule` (row 19) on `PLAIN_PIECES`
    (`gemm_tn_plain`, `sum_splits_plain`) against JAX's
    `_recurrence_bwd(compute_dtype, True, res, g)` from JAX's own forward
    residuals (`_recurrence_fwd`, `_bwd_kernel` in the interpreter): dgates
    and dwh; float32 and bfloat16, a hidden width that is a multiple of 8
    and 12 (h's columns zero-padded to 16 for the TN product). In float64
    against autograd of `lstm_recurrence_plain`.

Tolerances: float32 1e-5 (rtol = atol) on the forward's outputs and dgates,
JAX's own rtol 1e-4 / atol 1e-5 on dwh (a reduction over every step and row
in another order); bfloat16 5e-2; float64 1e-10.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from weatherforecast_stgcn_maml_tpu.models.lstm import init_lstm as jax_init_lstm
from weatherforecast_stgcn_maml_tpu.ops import fused_lstm_stack as jax_fls
from weatherforecast_stgcn_maml_tpu.ops import lstm_scan as jax_scan
from weatherforecast_stgcn_maml_tpu_torch.models.common import as_operand
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm_stack as fls
from weatherforecast_stgcn_maml_tpu_torch.ops import lstm_scan

torch.set_num_threads(1)  # small tensors; more threads oversubscribe side-by-side workers

T, B, C, H = 5, 16, 24, 8  # JAX tests/test_lstm_stack.py's widths
KEEP = 0.7
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tasks_inputs(nv, n_layers, with_masks, seed):
    """numpy x [V, T, B, C], wcat0, wcatr, b2d and int8 masks [V, L-1, T,
    B, H] (or None)."""
    rng = np.random.default_rng(seed)
    params = [jax.tree.map(np.array, jax_init_lstm(jax.random.key(seed + v), C, H, n_layers))
              for v in range(nv)]
    cat = [[np.concatenate([p["wx"], p["wh"]]) for p in t["layers"]] for t in params]
    wcat0 = np.stack([c[0] for c in cat])
    wcatr = np.stack([np.stack(c[1:]) if n_layers > 1 else np.zeros((0, 2 * H, 4 * H), np.float32)
                      for c in cat])
    b2d = np.stack([np.stack([p["b"] for p in t["layers"]]) for t in params])
    x = rng.normal(size=(nv, T, B, C)).astype(np.float32)
    masks = ((rng.uniform(size=(nv, n_layers - 1, T, B, H)) >= 0.3).astype(np.int8)
             if with_masks and n_layers > 1 else None)
    return x, wcat0, wcatr, b2d, masks


def _schedule(x, wcat0, wcatr, b2d, masks, keep, dt):
    t = torch.from_numpy
    return fls.tasks_forward_schedule(t(x), None if masks is None else t(masks), keep, dt,
                                      t(wcat0), t(wcatr), t(b2d), fls.FWD_PLAIN_PIECES)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nv,n_layers,with_masks", [(2, 3, True), (3, 1, False), (3, 2, True)])
def test_row16_schedule_matches_mv_body(dtype, nv, n_layers, with_masks):
    jdt, tdt = DTYPES[dtype]
    x, wcat0, wcatr, b2d, masks = _tasks_inputs(nv, n_layers, with_masks,
                                                7 * nv + 3 * n_layers + with_masks)
    keep = KEEP if masks is not None else 1.0
    jwr = jnp.asarray(wcatr) if n_layers > 1 else jnp.zeros((nv, 1, 2 * H, 4 * H), jnp.float32)
    with jax_fls.force_interpret():
        h_all, c_all, h_last = jax_fls._fwd_pallas_mv(
            jnp.asarray(x), jnp.asarray(wcat0), jwr, jnp.asarray(b2d),
            None if masks is None else jnp.asarray(masks), jdt, True, keep)
    got = _schedule(x, wcat0, wcatr, b2d, masks, keep, tdt)
    assert got[1].dtype == got[2].dtype == tdt and got[0].dtype == got[3].dtype == torch.float32
    assert got[3].shape == (nv, n_layers, T, B, 4 * H)
    for name, g, r in zip(("h_last", "h_all", "c_all"), got, (h_last, h_all, c_all)):
        r = np.asarray(r.astype(jnp.float32))
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.float().numpy(), r, rtol=TOL[dtype], atol=TOL[dtype],
                                   err_msg=name)


@pytest.mark.parametrize("nv,n_layers,with_masks", [(2, 3, True), (3, 1, False)])
def test_row16_schedule_float64(nv, n_layers, with_masks):
    """h_last against `lstm_stack_tasks_plain`; every output (h_last, h_all,
    c_all, the gates) against row 4's `forward_schedule`, task by task."""
    x, wcat0, wcatr, b2d, masks = _tasks_inputs(nv, n_layers, with_masks, 30 + nv)
    keep = KEEP if masks is not None else 1.0
    dt = torch.float64
    tx, tw0, twr, tb = (torch.from_numpy(a).double() for a in (x, wcat0, wcatr, b2d))
    tm = None if masks is None else torch.from_numpy(masks)
    got = fls.tasks_forward_schedule(tx, tm, keep, dt, tw0, twr, tb, fls.FWD_PLAIN_PIECES)
    ref = fls.lstm_stack_tasks_plain(tx.transpose(1, 2), tw0, twr, tb, tm, keep, dt)
    torch.testing.assert_close(got[0], ref, rtol=1e-10, atol=1e-10)
    for v in range(nv):
        one = fls.forward_schedule(tx[v], None if tm is None else tm[v], keep, dt, tb[v],
                                   [tw0[v], *twr[v]], fls.FWD_PLAIN_PIECES)
        for g, r in zip(got, one):
            assert g.dtype == dt
            torch.testing.assert_close(g[v], r, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("itemsize,rows,plan,plan2", [
    (4, 512, (2, 64, 8), (2, 64, 16)),     # the inner step, float32
    (2, 512, (1, 128, 4), (1, 128, 8)),    # bfloat16
    (4, 1024, (2, 64, 16), (2, 64, 16)),   # the adaptation step's rows: no wave at V = 2
    (2, 1024, (1, 128, 8), (1, 128, 16)),
])
def test_forward_plan_by_task_count(itemsize, rows, plan, plan2):
    """One task: row 4's plans (the default); two tasks: the row tile that
    puts both tasks' clusters on 132 SMs in one wave (128 blocks at 512
    rows), else the largest tile that fits."""
    assert fls.forward_plan(128, rows, itemsize, 132) == (*plan, 128)
    assert fls.forward_plan(128, rows, itemsize, 132, 1) == (*plan, 128)
    assert fls.forward_plan(128, rows, itemsize, 132, 2) == (*plan2, 128)
    cs, hcp, rb = plan2
    assert fls.scan_fwd_smem(128, hcp, rb, itemsize) <= fls.SCAN_MAX_SMEM


def _gates(xp, h_all, wh, dt):
    """The activated gates JAX's `_bwd_kernel` recomputes: act(xp +
    round(h_{t-1}) @ round(wh))."""
    h_prev = torch.cat([torch.zeros_like(h_all[:1]), h_all[:-1]])
    pre = xp + as_operand(h_prev, dt) @ as_operand(wh, dt)
    i, f, g, o = pre.split(wh.shape[0], dim=-1)
    return torch.cat([torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)], -1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", [8, 12])
def test_row19_schedule_matches_pallas_vjp(dtype, hidden):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(50 + hidden)
    xp = rng.normal(size=(T, B, 4 * hidden)).astype(np.float32)
    wh = (rng.normal(size=(hidden, 4 * hidden)) * 0.3).astype(np.float32)
    g = rng.normal(size=(T, B, hidden)).astype(np.float32)
    with jax_scan.force_interpret():
        _, res = jax_scan._recurrence_fwd(jnp.asarray(xp), jnp.asarray(wh), jdt, True)
        ref_dg, ref_dwh = jax_scan._recurrence_bwd(jdt, True, res, jnp.asarray(g))
    t = torch.from_numpy
    h_all, c_all = (t(np.array(r)) for r in res[2:])
    assert h_all.dtype == torch.float32  # row 18's residuals: float32 under either dtype
    gates = _gates(t(xp), h_all, t(wh), tdt)
    dg, dwh = lstm_scan.scan_backward_schedule(t(g), h_all, c_all, gates, t(wh), tdt,
                                               lstm_scan.PLAIN_PIECES)
    assert dg.dtype == dwh.dtype == torch.float32 and dwh.shape == (hidden, 4 * hidden)
    tol = TOL[dtype]
    np.testing.assert_allclose(dg.numpy(), np.asarray(ref_dg), rtol=tol, atol=tol,
                               err_msg="dgates")
    np.testing.assert_allclose(dwh.numpy(), np.asarray(ref_dwh), atol=tol,
                               rtol=1e-4 if dtype == "float32" else tol, err_msg="dwh")


@pytest.mark.parametrize("hidden", [8, 12])
def test_row19_schedule_float64_matches_autograd(hidden):
    """dxp and dwh against autograd of the plain recurrence, from the plain
    forward piece's residuals."""
    dt = torch.float64
    draw = torch.Generator().manual_seed(hidden)
    xp = torch.randn((T, B, 4 * hidden), generator=draw, dtype=dt)
    wh = torch.randn((hidden, 4 * hidden), generator=draw, dtype=dt) * 0.3
    g = torch.randn((T, B, hidden), generator=draw, dtype=dt)
    h_all, c_all, gates = lstm_scan.scan_forward_plain(xp, wh, dt, True)
    dg, dwh = lstm_scan.scan_backward_schedule(g, h_all, c_all, gates, wh, dt,
                                               lstm_scan.PLAIN_PIECES)
    leaves = [a.clone().requires_grad_(True) for a in (xp, wh)]
    ref = torch.autograd.grad(lstm_scan.lstm_recurrence_plain(*leaves, dt), leaves, g)
    for a, r in zip((dg, dwh), ref):
        torch.testing.assert_close(a, r, rtol=1e-10, atol=1e-10)
