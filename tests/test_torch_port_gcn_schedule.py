"""Row 7's layer-by-layer backward and row 12's forward schedule (the GCN
rows on the pipelined GEMM core), on their plain pieces, against the JAX
package on the CPU.

Row 7 (`fused_gcn_train.backward_schedule` through `_backward` with
`PLAIN_PIECES`): against JAX's `_bwd_pallas` in the Pallas interpreter
(`force_interpret()`) on the same numpy inputs, residuals and int8 masks
(dx, every dW_l and db_l; float32 and bfloat16, masks on and off, 1 and 3
layers), and in float64 against autograd of `gcn_stack_train_plain` (also
at a node count and widths that take the zero padding). Row 12
(`fused_gcn_shard.forward_schedule` on `gemm_nn_plain`): against JAX's
`_fwd_kernel` through `_shard_layer_op(..., interpret=True)`. The plain TN
product with its split plan against float64 a^T b, and the plain forms of
the two new epilogues against their formulas.

Tolerances: float64 1e-10; float32 1e-5 (rtol = atol on forwards,
max|diff| / max|ref| on gradients: the same products summed in another
order); bfloat16 5e-2.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from weatherforecast_stgcn_maml_tpu.ops import fused_gcn_shard as jax_fgs
from weatherforecast_stgcn_maml_tpu.ops import fused_gcn_train as jax_fgt
from weatherforecast_stgcn_maml_tpu_torch.models.common import Dense
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_gcn_shard as fgs
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_gcn_train as fgt
from weatherforecast_stgcn_maml_tpu_torch.ops.gemm import (
    NN_ROW_TILE,
    gemm_nn_plain,
    gemm_tn_plain,
    tn_splits,
)

torch.set_num_threads(1)  # small tensors; more threads oversubscribe side-by-side workers

KEEP = 0.8
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _row7_inputs(seed, slices, n, c_in, hid, layers, masked):
    """numpy x, a_hat, weights, int8 masks (after every layer), residuals
    (relu'd, so some are 0) and the output's cotangent."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        x=rng.normal(size=(slices, n, c_in)).astype(f32),
        a_hat=(rng.uniform(size=(n, n)) / n).astype(f32),
        weights=[(rng.normal(size=(c_in if l == 0 else hid, hid)) * 0.3).astype(f32)
                 for l in range(layers)],
        masks=(rng.uniform(size=(layers, slices, n, hid)) < KEEP).astype(np.int8)
        if masked else None,
        h_all=np.maximum(rng.normal(size=(layers, slices, n, hid)), 0).astype(f32),
        g=rng.normal(size=(slices, n, hid)).astype(f32),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("layers,hid", [(3, 16), (1, 8)])
def test_row7_schedule_matches_pallas_body(dtype, masked, layers, hid):
    """W 5, N 56 (280 rows: three row tiles, two TN splits), C 24."""
    jdt, tdt = DTYPES[dtype]
    inp = _row7_inputs(layers + 2 * masked, 5, 56, 24, hid, layers, masked)
    h_all = jnp.asarray(inp["h_all"]).astype(jdt)
    masks = None if inp["masks"] is None else jnp.asarray(inp["masks"])
    w = inp["weights"]
    wr = np.stack(w[1:]) if layers > 1 else np.zeros((1, hid, hid), np.float32)
    with jax_fgt.force_interpret():
        dx, dw0, dwr, db = jax_fgt._bwd_pallas(
            jnp.asarray(inp["g"]).astype(jdt), jnp.asarray(inp["x"]), jnp.asarray(inp["a_hat"]),
            jnp.asarray(w[0]), jnp.asarray(wr), masks, h_all, jdt, True, keep=KEEP)
    t = torch.from_numpy
    got_dx, got_dw, got_db = fgt._backward(
        t(inp["g"]).to(tdt), t(inp["x"]), t(inp["a_hat"]), [t(a) for a in w],
        None if masks is None else t(inp["masks"]),
        [t(np.array(h.astype(jnp.float32))).to(tdt) for h in h_all], 1.0 / KEEP, tdt,
        fgt.PLAIN_PIECES)
    refs = [dx, dw0, *list(dwr)[:layers - 1], *list(db)]
    gots = [got_dx, *got_dw, *got_db]
    for i, (g, r) in enumerate(zip(gots, refs)):
        assert _rel(g, np.asarray(r.astype(jnp.float32))) <= TOL[dtype], i


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("shape", [(5, 16, 24, 16, 3), (5, 16, 24, 8, 1), (3, 13, 5, 12, 2)])
def test_row7_schedule_float64_matches_autograd(masked, shape):
    """The schedule in float64 against autograd of the plain stack; (3, 13,
    5, 12, 2) takes the zero padding to multiples of 8."""
    slices, n, c_in, hid, layers = shape
    inp = _row7_inputs(7, slices, n, c_in, hid, layers, masked)
    dt = torch.float64
    enc = [Dense(torch.tensor(w, dtype=dt, requires_grad=True),
                 torch.tensor(np.random.default_rng(l).normal(size=hid) * 0.1, dtype=dt,
                              requires_grad=True)) for l, w in enumerate(inp["weights"])]
    a_hat = torch.tensor(inp["a_hat"], dtype=dt)
    x = torch.tensor(inp["x"], dtype=dt, requires_grad=True)
    masks = None if inp["masks"] is None else torch.from_numpy(inp["masks"])
    out = fgt.gcn_stack_train_plain(enc, a_hat, x, masks, KEEP, dt)
    g = torch.tensor(inp["g"], dtype=dt)
    ref = torch.autograd.grad(out, [x] + [p for layer in enc for p in (layer.w, layer.b)], g)
    with torch.no_grad():
        h_all = [fgt.gcn_stack_train_plain(enc[:l + 1], a_hat, x, masks, KEEP, dt)
                 for l in range(layers)]
        dx, dws, dbs = fgt._backward(g, x, a_hat, [layer.w for layer in enc], masks, h_all,
                                     1.0 / KEEP, dt, fgt.PLAIN_PIECES)
    for got, want in zip([dx, *(t for pair in zip(dws, dbs) for t in pair)], ref):
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("has_mask", [True, False])
@pytest.mark.parametrize("has_next", [True, False])
def test_row12_schedule_matches_pallas_body(dtype, has_mask, has_next):
    """W 4, N 32, NL 16, hid 16 -> 8; node-major on the port's side."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(2 * has_next + has_mask)
    hw_full = rng.normal(size=(4, 32, 16)).astype(np.float32)
    a_rows = (rng.uniform(size=(16, 32)) / 32).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    w_next = rng.normal(size=(16, 8)).astype(np.float32)
    mask = (rng.uniform(size=(4, 16, 16)) < KEEP).astype(np.int8)
    op = jax_fgs._shard_layer_op(dtype, True, KEEP, has_next, has_mask)
    args = [jnp.asarray(hw_full).astype(jdt), jnp.asarray(a_rows), jnp.asarray(b)[None]]
    args += ([jnp.asarray(w_next)] if has_next else []) + ([jnp.asarray(mask)] if has_mask else [])
    ref = op(*args)
    ref = ref if has_next else (ref,)

    def nm(a):  # [W, rows, C] <-> node-major [rows, W, C]
        return np.ascontiguousarray(np.swapaxes(a, 0, 1))

    t = torch.from_numpy
    got = fgs.forward_schedule(
        t(nm(hw_full)).to(tdt), t(a_rows), t(b), t(w_next) if has_next else None,
        t(nm(mask)) if has_mask else None, 1.0 / KEEP, tdt, gemm_nn_plain)
    assert got[0].dtype == tdt and (got[1] is None) == (not has_next)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(nm(g.float().numpy()), np.asarray(r.astype(jnp.float32)),
                                   rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,split_rows", [(100, 32), (256, 64), (40, 256)])
def test_tn_plain_split_plan_matches_float64(dtype, k, split_rows):
    rng = np.random.default_rng(k)
    a = torch.from_numpy(rng.normal(size=(k, 24)).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.normal(size=(k, 16)).astype(np.float32)).to(dtype)
    splits = tn_splits(k, split_rows)
    part = gemm_tn_plain(a, b, torch.empty((splits, 24, 16)), compute_dtype=dtype,
                         split_rows=split_rows)
    assert splits == -(-k // split_rows)
    want = a.double().T @ b.double()
    assert _rel(part.sum(dim=0), want) <= 1e-5
    # Each split is its own rows' product.
    last = slice((splits - 1) * split_rows, k)
    assert _rel(part[-1], a[last].double().T @ b[last].double()) <= 1e-5


def test_plain_epilogues_match_their_formulas():
    """bias_relu_mask (row 12) and relu_grad (row 7: the residual's relu
    gate, the mask, each 128-row tile's column sums) in float64 at a ragged
    M (300 rows: three tiles, the last one short)."""
    rng = np.random.default_rng(0)
    dt = torch.float64
    a = torch.from_numpy(rng.normal(size=(300, 24)))
    b = torch.from_numpy(rng.normal(size=(24, 16)))
    bias = torch.from_numpy(rng.normal(size=(16,)))
    mask = torch.from_numpy((rng.uniform(size=(300, 16)) < KEEP).astype(np.int8))
    residual = torch.from_numpy(rng.normal(size=(300, 16)))
    y = a @ b
    got = gemm_nn_plain(a, b, compute_dtype=dt, epilogue="bias_relu_mask", bias=bias, mask=mask,
                        scale=1 / KEEP)
    torch.testing.assert_close(got, torch.relu(y + bias) * mask / KEEP, rtol=1e-10, atol=1e-10)
    for m in (mask, None):
        colsum = torch.empty((3, 16), dtype=dt)
        got = gemm_nn_plain(a, b, compute_dtype=dt, epilogue="relu_grad", residual=residual,
                            mask=m, scale=1 / KEEP, colsum=colsum)
        want = y * (residual > 0) * (1 if m is None else m / KEEP)
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)
        tiles = torch.stack([want[i:i + NN_ROW_TILE].sum(dim=0)
                             for i in range(0, 300, NN_ROW_TILE)])
        torch.testing.assert_close(colsum, tiles, rtol=1e-10, atol=1e-10)
