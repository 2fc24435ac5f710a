"""The port's node-sharded GCN sandwich layer (kernel rows 12-13, plain
versions) against the JAX package, on the CPU.

float32: `shard_layer_plain` (autograd backward) and the `_ShardLayer`
Function on CPU tensors (its backward is `shard_bwd_plain`, the plain
statement of row 13) against JAX's `_shard_layer_op`, the Pallas bodies
`_fwd_kernel` / `_bwd_kernel` run standalone in the interpreter, and its
`_layer_reference`: forward and jax.vjp with the same int8 masks and
cotangents, has_next x has_mask x t in {4, 6} (t = 6 runs the Pallas grid
twice, accumulating dW_next and db). Tolerance 1e-5 (rtol = atol): the same
products summed in another order.

float64: the JAX op accumulates in float32 whatever its inputs, so the
float64 reference is JAX's float64 layer composed from the package's own
functions (`models.gcn.apply_gcn_layer` with an identity transform, relu,
the mask, `models.common.apply_dense`) and jax.vjp; tolerance 1e-10.

The port is node-major ([rows, W, C]); the JAX op slice-major ([W, rows, C]):
inputs and results are transposed at the boundary.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from weatherforecast_stgcn_maml_tpu.models.common import apply_dense as jax_apply_dense
from weatherforecast_stgcn_maml_tpu.models.gcn import apply_gcn_layer as jax_gcn_layer
from weatherforecast_stgcn_maml_tpu.ops import fused_gcn_shard as jax_fgs
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_gcn_shard as fgs

torch.set_num_threads(1)  # small tensors; more threads oversubscribe side-by-side workers

KEEP = 0.7


def _inputs(seed, t, dtype, nl=16, n=32, hid=16, hid_next=8):
    """JAX-layout numpy inputs (hw_full [t, n, hid], mask [t, nl, hid]) and
    cotangents (g1 [t, nl, hid], g2 [t, nl, hid_next])."""
    rng = np.random.default_rng(seed)
    return dict(
        hw_full=rng.normal(size=(t, n, hid)).astype(dtype),
        a_rows=(rng.uniform(size=(nl, n)) / n).astype(dtype),
        b=rng.normal(size=(hid,)).astype(dtype),
        w_next=rng.normal(size=(hid, hid_next)).astype(dtype),
        mask=(rng.uniform(size=(t, nl, hid)) < KEEP).astype(np.int8),
        g1=rng.normal(size=(t, nl, hid)).astype(dtype),
        g2=rng.normal(size=(t, nl, hid_next)).astype(dtype),
    )


def _nm(a):
    """JAX layout [t, rows, C] <-> the port's node-major [rows, t, C]."""
    return np.ascontiguousarray(np.swapaxes(np.asarray(a), 0, 1))


def _port(inp, has_next, has_mask, dtype, function):
    """The port's forward outputs and (d_hw_full, db, dw_next), JAX layout."""
    t = lambda a: torch.from_numpy(a.copy())  # noqa: E731
    hw = t(_nm(inp["hw_full"])).requires_grad_(True)
    b = t(inp["b"]).requires_grad_(True)
    w_next = t(inp["w_next"]).requires_grad_(True) if has_next else None
    mask = t(_nm(inp["mask"])) if has_mask else None
    args = (hw, t(inp["a_rows"]), b, w_next, mask, KEEP, dtype)
    out = fgs._ShardLayer.apply(*args) if function else fgs.shard_layer_plain(*args)
    outs = out if has_next else (out,)
    cts = [t(_nm(inp["g1"])), t(_nm(inp["g2"]))][:len(outs)]
    leaves = [hw, b] + ([w_next] if has_next else [])
    grads = torch.autograd.grad(outs, leaves, cts)
    return ([_nm(o.detach().numpy()) for o in outs],
            [_nm(grads[0].numpy()), *(g.numpy() for g in grads[1:])])


@pytest.mark.parametrize("function", [False, True], ids=["plain", "function"])
@pytest.mark.parametrize("t", [4, 6])
@pytest.mark.parametrize("has_mask", [True, False])
@pytest.mark.parametrize("has_next", [True, False])
def test_sandwich_float32_matches_pallas_bodies(has_next, has_mask, t, function):
    inp = _inputs(2 * has_next + has_mask, t, np.float32)
    a_rows = jnp.asarray(inp["a_rows"])
    mask = jnp.asarray(inp["mask"]) if has_mask else None
    op = jax_fgs._shard_layer_op("float32", True, KEEP, has_next, has_mask)

    def pallas(hw, b, wn):
        args = [hw, a_rows, b] + ([wn] if has_next else []) + ([mask] if has_mask else [])
        with jax_fgs.force_interpret():
            return op(*args)

    def reference(hw, b, wn):
        return jax_fgs._layer_reference(hw, a_rows, b, wn if has_next else None, mask,
                                        jnp.float32, KEEP)

    primals = (jnp.asarray(inp["hw_full"]), jnp.asarray(inp["b"])[None],
               jnp.asarray(inp["w_next"]))
    cts = (jnp.asarray(inp["g1"]), jnp.asarray(inp["g2"])) if has_next else jnp.asarray(inp["g1"])
    got_out, got_grads = _port(inp, has_next, has_mask, torch.float32, function)
    for ref_fn in (pallas, reference):
        out, vjp = jax.vjp(ref_fn, *primals)
        d_hw, db, dwn = vjp(cts)
        for g, r in zip(got_out, jax.tree.leaves(out)):
            np.testing.assert_allclose(g, np.asarray(r), rtol=1e-5, atol=1e-5)
        refs = [d_hw, db[0]] + ([dwn] if has_next else [])
        for name, g, r in zip(("d_hw_full", "db", "dw_next"), got_grads, refs):
            np.testing.assert_allclose(g, np.asarray(r), rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("function", [False, True], ids=["plain", "function"])
@pytest.mark.parametrize("t", [4, 6])
@pytest.mark.parametrize("has_mask", [True, False])
@pytest.mark.parametrize("has_next", [True, False])
def test_sandwich_float64_matches_jax_layers(has_next, has_mask, t, function):
    inp = _inputs(10 + 2 * has_next + has_mask, t, np.float64)
    hid = inp["b"].shape[0]
    with jax.enable_x64(True):
        a_rows = jnp.asarray(inp["a_rows"])
        mask = jnp.asarray(inp["mask"]) if has_mask else None

        def reference(hw, b, wn):
            z = jax_gcn_layer({"w": jnp.eye(hid, dtype=jnp.float64), "b": b}, a_rows, hw,
                              compute_dtype=jnp.float64)
            h = jnp.maximum(z, 0.0)
            if mask is not None:
                h = h * (mask.astype(jnp.float64) * (1.0 / KEEP))
            if not has_next:
                return h
            return h, jax_apply_dense({"w": wn, "b": jnp.zeros(wn.shape[1], jnp.float64)}, h,
                                      compute_dtype=jnp.float64)

        out, vjp = jax.vjp(reference, *(jnp.asarray(inp[k]) for k in ("hw_full", "b", "w_next")))
        cts = (jnp.asarray(inp["g1"]), jnp.asarray(inp["g2"])) if has_next else jnp.asarray(
            inp["g1"])
        refs = vjp(cts)
    got_out, got_grads = _port(inp, has_next, has_mask, torch.float64, function)
    for g, r in zip(got_out, jax.tree.leaves(out)):
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-10, atol=1e-10)
    for name, g, r in zip(("d_hw_full", "db", "dw_next"), got_grads, refs):
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-10, atol=1e-10, err_msg=name)


def test_sandwich_routes_cpu_to_plain_and_refuses_other_devices():
    """On the CPU the wrapper is the plain version (its launch counters do
    not move); a device with no kernel raises."""
    inp = _inputs(0, 4, np.float32)
    args = [torch.from_numpy(_nm(inp["hw_full"])), torch.from_numpy(inp["a_rows"]),
            torch.from_numpy(inp["b"]), torch.from_numpy(inp["w_next"]), None]
    before = (fgs.gcn_shard_layer.launches, fgs.gcn_shard_layer.backward_launches)
    h, hw_next = fgs.gcn_shard_layer(*args)
    ref_h, ref_next = fgs.shard_layer_plain(*args, 1.0, torch.float32)
    torch.testing.assert_close(h, ref_h, rtol=0, atol=0)
    torch.testing.assert_close(hw_next, ref_next, rtol=0, atol=0)
    assert (fgs.gcn_shard_layer.launches, fgs.gcn_shard_layer.backward_launches) == before
    with pytest.raises(TypeError, match="no GCN sandwich kernel"):
        fgs.gcn_shard_layer(*(a.to("meta") if a is not None else None for a in args))
