"""Kernel row 17's layer-by-layer schedule with a task axis, the batched TN
product and row 6's forward schedule, on their plain pieces, against the
JAX package on the CPU.

  * `tasks_backward_schedule` (row 17: the merged LSTM stack's training
    backward for V tasks, each with its own weights) on `PLAIN_PIECES`
    against JAX's `_bwd_pallas_mv` (`_bwd_kernel_mv` in the Pallas
    interpreter, the body `_VBATCH` routes jax.vmap of the stack's gradient
    to) on the same numpy inputs, int8 masks and JAX's residuals from
    `_fwd_pallas_mv`; V = 2 and 3, one to three layers, the input wider than
    the hidden width, masks on and off; and in float64 against autograd of
    `lstm_stack_tasks_plain`;
  * `gemm_tn_plain` with a task axis and an A row offset against a loop of
    one-task calls (equal bits);
  * `recurrence_plan` with a task count: one task keeps the plans the card
    runs today, two tasks fill one wave with twice the row tile;
  * `fused_gcn_train.forward_schedule` (row 6) on `gemm_nn_plain` against
    JAX's `_fwd_pallas` (`_fwd_kernel` in the interpreter), float32 and
    bfloat16, with masks after no layer, all but the last and every layer,
    at a node count and widths that are multiples of 8 and at ones that are
    not (the zero padding); in float64 against `gcn_stack_train_plain`.

Tolerances: float32 rtol 1e-4 / atol 1e-5 on row 17 (JAX's own for its
task-batched stack: reductions over every step and row in another order),
1e-5 on row 6 (rtol = atol); bfloat16 5e-2; float64 1e-10.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from weatherforecast_stgcn_maml_tpu.models.lstm import init_lstm as jax_init_lstm
from weatherforecast_stgcn_maml_tpu.ops import fused_gcn_train as jax_fgt
from weatherforecast_stgcn_maml_tpu.ops import fused_lstm_stack as jax_fls
from weatherforecast_stgcn_maml_tpu_torch.models.common import Dense, apply_mask, as_operand
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_gcn_train as fgt
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm_stack as fls
from weatherforecast_stgcn_maml_tpu_torch.ops.gemm import gemm_nn_plain, gemm_tn_plain, tn_splits

torch.set_num_threads(1)  # small tensors; more threads oversubscribe side-by-side workers

T, B, C, H = 5, 16, 24, 8  # JAX tests/test_lstm_stack.py's widths
KEEP = 0.7


def _tasks_inputs(nv, n_layers, with_masks, seed):
    """numpy g [V, B, H], x [V, T, B, C], wcat0, wcatr, b2d, int8 masks."""
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
             if with_masks else None)
    g = rng.normal(size=(nv, B, H)).astype(np.float32)
    return g, x, wcat0, wcatr, b2d, masks


def _gates(x, h_all, wcat0, wcatr, b2d, masks, keep, dtype):
    """Each task's activated gates [V, L, T, B, 4H] from the forward's
    residuals, as row 16 stores them: act(round(in_l) @ Wx_l +
    round(h_{t-1}) @ Wh_l + b_l)."""
    out = []
    for v in range(x.shape[0]):
        layers = []
        for l, w in enumerate([wcat0[v], *wcatr[v]]):
            inp = x[v] if l == 0 else h_all[v, l - 1].to(x.dtype)
            if l > 0 and masks is not None:
                inp = apply_mask(inp, masks[v, l - 1], keep)
            h = h_all[v, l].to(x.dtype)
            h_prev = torch.cat([torch.zeros_like(h[:1]), h[:-1]])
            pre = (as_operand(inp, dtype) @ as_operand(w[:-H], dtype)
                   + as_operand(h_prev, dtype) @ as_operand(w[-H:], dtype) + b2d[v, l])
            i, f, gg, o = pre.split(H, dim=-1)
            layers.append(torch.cat([torch.sigmoid(i), torch.sigmoid(f), torch.tanh(gg),
                                     torch.sigmoid(o)], dim=-1))
        out.append(torch.stack(layers))
    return torch.stack(out)


TASK_CASES = [(2, 3, True), (3, 1, False)]  # (V, L, masks)


@pytest.mark.parametrize("nv,n_layers,with_masks", TASK_CASES)
def test_tasks_schedule_matches_mv_body(nv, n_layers, with_masks):
    """Float32, from JAX's residuals: the schedule on `PLAIN_PIECES` against
    `_bwd_pallas_mv` (dx, dwcat0, dwcatr, db of every task)."""
    g, x, wcat0, wcatr, b2d, masks = _tasks_inputs(nv, n_layers, with_masks,
                                                   10 * nv + 2 * n_layers + with_masks)
    keep = KEEP if with_masks else 1.0
    jwr = jnp.asarray(wcatr) if n_layers > 1 else jnp.zeros((nv, 1, 2 * H, 4 * H), jnp.float32)
    jm = None if masks is None else jnp.asarray(masks)
    with jax_fls.force_interpret():
        h_all, c_all, _ = jax_fls._fwd_pallas_mv(jnp.asarray(x), jnp.asarray(wcat0), jwr,
                                                 jnp.asarray(b2d), jm, jnp.float32, True, keep)
        ref = jax_fls._bwd_pallas_mv(jnp.asarray(g), jnp.asarray(x), h_all, c_all,
                                     jnp.asarray(wcat0), jwr, jnp.asarray(b2d), jm, jnp.float32,
                                     True, keep)
    t = torch.from_numpy
    tm = None if masks is None else t(masks)
    th, tc = t(np.array(h_all)), t(np.array(c_all))
    gates = _gates(t(x), th, t(wcat0), t(wcatr), t(b2d), tm, keep, torch.float32)
    got = fls.tasks_backward_schedule(t(g), t(x), th, tc, gates, t(wcat0), t(wcatr), tm, keep,
                                      torch.float32, fls.PLAIN_PIECES)
    refs = [np.asarray(r) for r in ref]
    if n_layers == 1:
        assert got[2].shape == (nv, 0, 2 * H, 4 * H) and not refs[2].any()
        got, refs = got[:2] + got[3:], refs[:2] + refs[3:]
    for a, r in zip(got, refs):
        assert a.shape == r.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), r, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("nv,n_layers,with_masks", [(2, 3, True), (3, 2, False), (2, 1, True)])
def test_tasks_schedule_float64_matches_autograd(nv, n_layers, with_masks):
    """Float64: the schedule from the plain forward's residuals against
    autograd of `lstm_stack_tasks_plain` (each task's x, wcat0, wcatr, b2d)."""
    g, x, wcat0, wcatr, b2d, masks = _tasks_inputs(nv, n_layers, with_masks, 40 + nv)
    keep = KEEP if with_masks else 1.0
    dt = torch.float64
    tm = None if masks is None else torch.from_numpy(masks)
    leaves = [torch.from_numpy(a).to(dt).requires_grad_(True) for a in (x, wcat0, wcatr, b2d)]
    out = fls.lstm_stack_tasks_plain(leaves[0].transpose(1, 2), *leaves[1:], tm, keep, dt)
    tg = torch.from_numpy(g).to(dt)
    ref = [torch.zeros_like(a) if r is None else r  # one layer: wcatr is empty
           for a, r in zip(leaves, torch.autograd.grad(out, leaves, tg, allow_unused=True))]
    from weatherforecast_stgcn_maml_tpu_torch.ops.fused_lstm_hvp import hvp_fwd_plain

    res = [hvp_fwd_plain(leaves[0][v].detach(),
                         [w.detach() for w in (leaves[1][v], *leaves[2][v])],
                         leaves[3][v].detach(), None if tm is None else tm[v], keep, dt)[1:]
           for v in range(nv)]
    h_all, c_all, gates = (torch.stack(r) for r in zip(*res))
    got = fls.tasks_backward_schedule(tg, leaves[0].detach(), h_all, c_all, gates,
                                      *(a.detach() for a in leaves[1:3]), tm, keep, dt,
                                      fls.PLAIN_PIECES)
    for a, r in zip(got, ref):
        assert a.dtype == dt and a.shape == r.shape
        torch.testing.assert_close(a, r, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("a_row_offset", [0, 5])
def test_batched_tn_plain_is_a_loop_of_one_task_calls(a_row_offset):
    """`gemm_tn_plain` over a task axis gives the bits of one call a task,
    in float32 and bfloat16; the A row offset is zero rows over A."""
    rng = np.random.default_rng(a_row_offset)
    k, m, n, nv, split_rows = 70, 16, 24, 3, 32
    b = torch.from_numpy(rng.normal(size=(nv, k, n)).astype(np.float32))
    a = torch.from_numpy(rng.normal(size=(nv, k - a_row_offset, m)).astype(np.float32))
    splits = tn_splits(k, split_rows)
    for dtype in (torch.float32, torch.bfloat16):
        out = torch.empty((nv, splits, m, n))
        gemm_tn_plain(a.to(dtype), b.to(dtype), out, compute_dtype=dtype, split_rows=split_rows,
                      a_row_offset=a_row_offset)
        for v in range(nv):
            one = torch.empty((splits, m, n))
            gemm_tn_plain(a[v].to(dtype), b[v].to(dtype), one, compute_dtype=dtype,
                          split_rows=split_rows, a_row_offset=a_row_offset)
            assert torch.equal(out[v], one)
        padded = torch.cat([torch.zeros((nv, a_row_offset, m)), a], dim=1).double()
        torch.testing.assert_close(out.sum(dim=1).double(),
                                   as_operand(padded, dtype).double().transpose(1, 2)
                                   @ as_operand(b, dtype).double(),
                                   rtol=1e-5 if dtype == torch.float32 else 1e-2, atol=1e-5)


@pytest.mark.parametrize("hidden,itemsize,rows,tasks,plan", [
    (128, 4, 512, 1, (2, 64, 8)),     # today's plans, one task (rows 5, 15)
    (128, 2, 512, 1, (1, 128, 4)),
    (256, 4, 48, 1, (8, 32, 4)),
    (128, 4, 512, 2, (2, 64, 16)),    # row 17 at V = 2: 2 x 32 clusters of 2
    (128, 2, 512, 2, (1, 128, 8)),
    (128, 4, 512, 4, (2, 64, 16)),    # past one wave: the largest tile
])
def test_recurrence_plan_with_tasks(hidden, itemsize, rows, tasks, plan):
    """The cluster plan for `tasks` x rows: one task keeps today's plans;
    more tasks take the row tile that puts all their clusters in one wave
    on 132 SMs, or the largest tile if none does."""
    assert fls.recurrence_plan(hidden, rows, itemsize, 132, tasks) == (*plan, 4 * hidden)
    cs, hcp, rb = plan
    assert fls.scan_smem(hidden, hcp, rb, itemsize) <= fls.SCAN_MAX_SMEM
    if tasks < 4:
        assert tasks * -(-rows // rb) * cs <= 132
    assert fls.recurrence_plan(hidden, rows, itemsize, 132) == fls.recurrence_plan(
        hidden, rows, itemsize, 132, 1)


def _gcn_inputs(seed, slices, n, c_in, hid, layers, n_masks):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    widths = [c_in] + [hid] * layers
    return dict(
        x=rng.normal(size=(slices, n, c_in)).astype(f32),
        a_hat=(rng.uniform(size=(n, n)) / n * 2).astype(f32),
        weights=[(rng.normal(size=(a, b)) / a ** 0.5).astype(f32)
                 for a, b in zip(widths, widths[1:])],
        biases=[(rng.normal(size=(b,)) * 0.1).astype(f32) for b in widths[1:]],
        masks=(rng.uniform(size=(n_masks, slices, n, hid)) < 0.8).astype(np.int8)
        if n_masks else None,
    )


GCN_CASES = [  # (dtype, layers, n_masks, (slices, nodes, c_in, hid))
    ("float32", 3, 0, (4, 32, 24, 16)),
    ("float32", 3, 2, (3, 13, 5, 12)),
    ("float32", 3, 3, (4, 32, 24, 16)),
    ("bfloat16", 3, 0, (3, 13, 5, 12)),
    ("bfloat16", 2, 1, (4, 32, 24, 16)),
    ("bfloat16", 3, 3, (3, 13, 5, 12)),
]


@pytest.mark.parametrize("dtype,layers,n_masks,shape", GCN_CASES)
def test_row6_schedule_matches_pallas_body(dtype, layers, n_masks, shape):
    """Every layer's stored activation against `_fwd_pallas`'s h_all."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    slices, n, c_in, hid = shape
    inp = _gcn_inputs(layers + n_masks, slices, n, c_in, hid, layers, n_masks)
    w, b = inp["weights"], inp["biases"]
    wr = np.stack(w[1:]) if layers > 1 else np.zeros((1, hid, hid), np.float32)
    masks = inp["masks"]
    with jax_fgt.force_interpret():
        ref = jax_fgt._fwd_pallas(jnp.asarray(inp["x"]), jnp.asarray(inp["a_hat"]),
                                  jnp.asarray(w[0]), jnp.asarray(wr), jnp.asarray(np.stack(b)),
                                  None if masks is None else jnp.asarray(masks), jdt, True,
                                  keep=0.8)
    t = torch.from_numpy
    got = fgt.forward_schedule(t(inp["x"]), t(inp["a_hat"]), [t(a) for a in w],
                               [t(a) for a in b], None if masks is None else t(masks),
                               1.0 / 0.8, tdt, product=gemm_nn_plain)
    tol = 1e-5 if dtype == "float32" else 5e-2
    assert len(got) == layers
    for l, (a, r) in enumerate(zip(got, ref)):
        assert a.dtype == tdt and a.shape == (slices, n, hid), l
        np.testing.assert_allclose(a.float().numpy(), np.asarray(r.astype(jnp.float32)),
                                   rtol=tol, atol=tol, err_msg=f"layer {l}")


@pytest.mark.parametrize("shape", [(4, 32, 24, 16), (3, 13, 5, 12)])
def test_row6_schedule_float64_matches_plain(shape):
    """Float64: the last layer's output against `gcn_stack_train_plain` and
    every layer's against the plain stack cut to that layer."""
    slices, n, c_in, hid = shape
    inp = _gcn_inputs(9, slices, n, c_in, hid, 3, 2)
    dt = torch.float64
    enc = [Dense(torch.tensor(w, dtype=dt), torch.tensor(b, dtype=dt))
           for w, b in zip(inp["weights"], inp["biases"])]
    x, a_hat = torch.tensor(inp["x"], dtype=dt), torch.tensor(inp["a_hat"], dtype=dt)
    masks = torch.from_numpy(inp["masks"])
    got = fgt.forward_schedule(x, a_hat, [l.w for l in enc], [l.b for l in enc], masks,
                               1.0 / 0.8, dt, product=gemm_nn_plain)
    for l, h in enumerate(got):
        ref = fgt.gcn_stack_train_plain(enc[:l + 1], a_hat, x, masks, 0.8, dt)
        torch.testing.assert_close(h, ref, rtol=1e-10, atol=1e-10)
