"""Kernel row 15's layer-by-layer schedule and the pipelined GEMM core's
plain version, on the CPU.

  * `split_backward_schedule` on its plain pieces (`gemm_nn_plain` for the
    recomputed gates and the masked input gradient, `scan_backward_plain`
    for the recurrence, the plain weight gradients) against the
    stage-by-stage `split_backward_plain` and against JAX's `_bwd_pallas`
    (`_bwd_kernel` in the Pallas interpreter) on the same numpy inputs,
    JAX's residuals and int8 masks; one to three layers, the input wider
    than the hidden width, masks on and off;
  * `scan_backward_plain` (row 19's recurrence) against autograd of the
    plain recurrence;
  * `gemm_nn_plain` against a product written out with torch.matmul at
    ragged M, N and K (K = 24, as row 3's second shape), every epilogue,
    one pair and two pairs at a row offset;
  * `gemm_nn` refusing a CPU tensor.

Tolerances: float64 1e-10 (the same operations in another order); float32
1e-5 on dx and on the gate gradients, max|diff| / max|ref| <= 1e-5 on the
weight gradients (a sum over every step and row in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from weatherforecast_stgcn_maml_tpu.models.lstm import init_lstm as jax_init_lstm
from weatherforecast_stgcn_maml_tpu.ops import fused_lstm_stack as jax_fls
from weatherforecast_stgcn_maml_tpu_torch.models.common import as_operand
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm_stack as fls
from weatherforecast_stgcn_maml_tpu_torch.ops.gemm import gemm_nn, gemm_nn_plain
from weatherforecast_stgcn_maml_tpu_torch.ops.lstm_scan import (
    lstm_recurrence_plain,
    scan_backward_plain,
)

torch.set_num_threads(1)  # small tensors; more threads oversubscribe side-by-side workers

T, B, C, H = 5, 16, 24, 8  # JAX tests/test_lstm_stack.py's widths
CASES = [(1, False), (2, False), (2, True), (3, False), (3, True)]  # (layers, masks)


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def _inputs(n_layers, with_masks, seed):
    rng = np.random.default_rng(seed)
    layers = jax.tree.map(np.array, jax_init_lstm(jax.random.key(seed), C, H, n_layers))
    layers = layers["layers"]
    wx0 = layers[0]["wx"]
    wxr = (np.stack([p["wx"] for p in layers[1:]]) if n_layers > 1
           else np.zeros((0, H, 4 * H), np.float32))
    wh = np.stack([p["wh"] for p in layers])
    b2d = np.stack([p["b"] for p in layers])
    x = rng.normal(size=(T, B, C)).astype(np.float32)
    masks = (rng.uniform(size=(n_layers - 1, T, B, H)) >= 0.3).astype(np.int8) \
        if with_masks else None
    g = rng.normal(size=(B, H)).astype(np.float32)
    return g, x, (wx0, wxr, wh, b2d), masks, 0.7 if with_masks else 1.0


@pytest.mark.parametrize("n_layers,with_masks", CASES)
def test_schedule_matches_stage_by_stage_and_jax(n_layers, with_masks):
    """Float32: the schedule from JAX's residuals against `_bwd_pallas` in
    the interpreter and against `split_backward_plain`; float64: against
    `split_backward_plain` from float64 residuals."""
    g, x, w, masks, keep = _inputs(n_layers, with_masks, 10 + 2 * n_layers + with_masks)
    jw = [jnp.asarray(a) for a in w]
    if n_layers == 1:  # JAX's placeholder for the layers above 0 (its dwxr: zeros)
        jw[1] = jnp.zeros((1, H, 4 * H), jnp.float32)
    jm = None if masks is None else jnp.asarray(masks)
    h_all, c_all, _ = jax_fls._fwd_pallas(jnp.asarray(x), *jw, jm, jnp.float32, True, keep)
    ref_jax = jax_fls._bwd_pallas(jnp.asarray(g), jnp.asarray(x), h_all, c_all, *jw, jm,
                                  jnp.float32, True, keep)
    tm = None if masks is None else torch.from_numpy(masks)
    args = [torch.from_numpy(np.array(a)) for a in (g, x, h_all, c_all, *w)]
    got = fls.split_backward_schedule(*args, tm, keep, torch.float32, fls.PLAIN_PIECES)
    ref = fls.split_backward_plain(*args, tm, keep, torch.float32)
    names = ("dx", "dwx0", "dwxr", "dwh", "db")
    for name, a, r_plain, r_jax in zip(names, got, ref, ref_jax):
        r_jax = torch.from_numpy(np.array(r_jax))
        assert a.shape == r_plain.shape, name
        if not a.numel():
            assert not r_jax.any(), name
            continue
        assert a.shape == r_jax.shape, name
        for r in (r_plain, r_jax):
            if name == "dx":
                torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)
            else:
                assert _rel(a, r) <= 1e-5, (name, _rel(a, r))

    w64 = [torch.from_numpy(a).double() for a in (x, *w)]
    _, h64, c64 = fls.split_forward_plain(*w64, tm, keep, torch.float64)
    g64 = torch.from_numpy(g).double()
    got = fls.split_backward_schedule(g64, w64[0], h64, c64, *w64[1:], tm, keep, torch.float64,
                                      fls.PLAIN_PIECES)
    ref = fls.split_backward_plain(g64, w64[0], h64, c64, *w64[1:], tm, keep, torch.float64)
    for a, r in zip(got, ref):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, r, rtol=1e-10, atol=1e-10)


def test_split_backward_on_the_cpu_is_the_stage_by_stage_version(monkeypatch):
    """On a CPU tensor `split_backward` is `split_backward_plain`; the
    schedule runs only where its pieces are given."""
    g, x, w, masks, keep = _inputs(2, True, 3)
    args = [torch.from_numpy(a) for a in (g, x)]
    seen = []
    monkeypatch.setattr(fls, "split_backward_schedule", lambda *a, **k: seen.append(1))
    _, h_all, c_all = fls.split_forward_plain(args[1], *map(torch.from_numpy, w),
                                              torch.from_numpy(masks), keep)
    got = fls.split_backward(*args, h_all, c_all, *map(torch.from_numpy, w),
                             torch.from_numpy(masks), keep, torch.float32)
    ref = fls.split_backward_plain(*args, h_all, c_all, *map(torch.from_numpy, w),
                                   torch.from_numpy(masks), keep, torch.float32)
    assert not seen
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=0, atol=0)


@pytest.mark.parametrize("t_len,rows,hidden", [(5, 16, 8), (1, 3, 4), (7, 9, 12)])
def test_scan_backward_plain_matches_autograd(t_len, rows, hidden):
    """Row 19's recurrence: from the forward's activated gates and cell
    states, dgates is the gradient of sum(h_all * g) by the pre-activation
    xp (float64)."""
    gen = torch.Generator().manual_seed(t_len + rows)
    xp = torch.randn((t_len, rows, 4 * hidden), generator=gen, dtype=torch.float64)
    wh = torch.randn((hidden, 4 * hidden), generator=gen, dtype=torch.float64) / hidden ** 0.5
    g = torch.randn((t_len, rows, hidden), generator=gen, dtype=torch.float64)
    h = torch.zeros((rows, hidden), dtype=torch.float64)
    c = torch.zeros_like(h)
    gates, cs = [], []
    for t in range(t_len):
        i, f, gg, o = (xp[t] + h @ wh).split(hidden, dim=-1)
        i, f, gg, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(gg), torch.sigmoid(o)
        c = f * c + i * gg
        h = o * torch.tanh(c)
        gates.append(torch.cat([i, f, gg, o], dim=-1))
        cs.append(c)
    got = scan_backward_plain(g, torch.stack(gates), torch.stack(cs), wh, torch.float64)
    leaf = xp.clone().requires_grad_(True)
    (ref,) = torch.autograd.grad(lstm_recurrence_plain(leaf, wh, torch.float64), leaf, g)
    torch.testing.assert_close(got, ref, rtol=1e-10, atol=1e-10)


def _written_out(a, b, compute_dtype, a2, b2, row_offset, epilogue, bias, mask, scale):
    """The product row by row with torch.matmul on rounded operands."""
    y = as_operand(a, compute_dtype) @ as_operand(b, compute_dtype)
    if a2 is not None:
        y = y.clone()
        y[row_offset:] += as_operand(a2, compute_dtype) @ as_operand(b2, compute_dtype)
    if epilogue == "bias_relu":
        y = torch.clamp(y + bias, min=0)
    elif epilogue == "gates":
        n = y.shape[-1] // 4
        z = y + bias
        y = torch.cat([1 / (1 + torch.exp(-z[:, :2 * n])), torch.tanh(z[:, 2 * n:3 * n]),
                       1 / (1 + torch.exp(-z[:, 3 * n:]))], dim=-1)
    elif epilogue == "mask":
        y = y * mask.to(y.dtype) * scale
    return y


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pairs", [1, 2])
@pytest.mark.parametrize("epilogue", ["none", "bias_relu", "gates", "mask"])
def test_gemm_nn_plain_matches_matmul(dtype, pairs, epilogue):
    """Ragged M = 37, N = 20, K = 24, the second pair K2 = 12 at row offset
    5; bfloat16 rounds both operands and accumulates in float32."""
    gen = torch.Generator().manual_seed(pairs)
    m, n, k, k2, off = 37, 20, 24, 12, 5
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    a = torch.randn((m, k), generator=gen, dtype=acc)
    b = torch.randn((k, n), generator=gen, dtype=acc)
    a2 = torch.randn((m - off, k2), generator=gen, dtype=acc) if pairs == 2 else None
    b2 = torch.randn((k2, n), generator=gen, dtype=acc) if pairs == 2 else None
    bias = torch.randn((n,), generator=gen, dtype=acc)
    mask = (torch.rand((m, n), generator=gen) < 0.7).to(torch.int8)
    kw = dict(a2=a2, b2=b2, row_offset=off if pairs == 2 else 0, epilogue=epilogue,
              bias=bias, mask=mask, scale=1.25)
    got = gemm_nn_plain(a, b, compute_dtype=dtype, **kw)
    ref = _written_out(a, b, dtype, **kw)
    assert got.dtype == acc
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(got, ref, rtol=tol, atol=tol)
    if pairs == 2:  # rows above the offset take no second term
        first = gemm_nn_plain(a, b, compute_dtype=dtype, epilogue=epilogue, bias=bias,
                              mask=mask, scale=1.25)
        torch.testing.assert_close(got[:off], first[:off], rtol=0, atol=0)
    out = torch.empty((m, n), dtype=torch.bfloat16)
    assert gemm_nn_plain(a, b, compute_dtype=dtype, out=out, **kw) is out
    torch.testing.assert_close(out, ref.to(torch.bfloat16), rtol=0, atol=0)


def test_gemm_nn_refuses_a_cpu_tensor():
    with pytest.raises(TypeError, match="CUDA"):
        gemm_nn(torch.zeros((8, 8)), torch.zeros((8, 8)), compute_dtype=torch.float32)
