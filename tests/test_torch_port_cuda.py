"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked `cuda` and skips without a card. The file imports
no jax, so it also runs where only PyTorch is installed:

  python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -q

(`--noconftest`: tests/conftest.py sets up jax for the JAX package's tests.)
Tolerances are those of chip_smoke.py: float32 1e-5, bfloat16 5e-2, on
forwards as rtol = atol and on gradients as max|diff| / max|ref| (a
reduction over thousands of terms in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

from weatherforecast_stgcn_maml_tpu_torch.config import DataConfig, MetaConfig, ModelConfig
from weatherforecast_stgcn_maml_tpu_torch.data.synthetic import synthetic_region_for_box
from weatherforecast_stgcn_maml_tpu_torch.graph import build_region_graph
from weatherforecast_stgcn_maml_tpu_torch.models.common import Dense, as_operand, draw_mask
from weatherforecast_stgcn_maml_tpu_torch.models.gcn import apply_gcn_layer
from weatherforecast_stgcn_maml_tpu_torch.models.lstm import init_lstm
from weatherforecast_stgcn_maml_tpu_torch.models.registry import apply_model, init_model
from weatherforecast_stgcn_maml_tpu_torch.models.stgcn import init_encoder
from weatherforecast_stgcn_maml_tpu_torch.ops import (
    cuda_build,
    fused_gcn,
    fused_gcn_shard,
    fused_gcn_train,
    fused_lstm,
    fused_lstm_hvp,
    fused_lstm_stack,
    fused_sgd,
    lstm_scan,
)
from weatherforecast_stgcn_maml_tpu_torch.ops.gemm import (
    gemm_nn,
    gemm_nn_plain,
    gemm_tn,
    gemm_tn_plain,
    sum_splits,
    tn_splits,
)
from weatherforecast_stgcn_maml_tpu_torch.train.maml import task_batch_grad
from weatherforecast_stgcn_maml_tpu_torch.train.tasks import build_meta_tasks, stack_tasks

TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
CFG = ModelConfig(hidden_channels=64, gcn_layers=3, lstm_hidden=32, lstm_layers=3,
                  window=7, horizon=3)


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _a_hat(dev):
    g = build_region_graph(np.arange(10.0, 13.0 + 1e-9, 0.25), np.arange(20.0, 22.0 + 1e-9, 0.25))
    return torch.from_numpy(g.a_hat).to(dev)  # 117 nodes padded to 128


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gcn_kernel_matches_plain(dev, dtype):
    enc = init_encoder(torch.Generator().manual_seed(0), CFG).to(dev).requires_grad_(False)
    a_hat = _a_hat(dev)
    x = torch.from_numpy(
        np.random.default_rng(5).normal(size=(3, 7, 128, CFG.in_channels)).astype(np.float32)
    ).to(dev)
    stack = fused_gcn.fused_gcn_stack
    before = stack.launches, stack.gemm_nn_launches, gemm_nn.launches
    got = stack(enc.layers, a_hat, x, compute_dtype=dtype)
    ref = fused_gcn.gcn_stack_plain(enc.layers, a_hat, x, dtype)
    # Row 1: two GEMM-core launches a layer.
    assert (stack.launches, stack.gemm_nn_launches, gemm_nn.launches) == (
        before[0] + 1, before[1] + 2 * CFG.gcn_layers, before[2] + 2 * CFG.gcn_layers)
    torch.testing.assert_close(got, ref, rtol=TOL[dtype], atol=TOL[dtype])


def _eval_counts(entry):
    return (entry.launches, entry.forward_gemm_nn_launches, entry.forward_recurrence_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [100, 3000, 5000])
def test_lstm_kernel_matches_plain(dev, dtype, rows):
    """Row 2 (the eval forward on row 14's schedule) at row counts that are
    no multiple of the forward plan's row tile (3000 and 5000 rows of H 32
    take the 32-row tile); one call, L gemm_nn and L recurrence launches."""
    lstm = init_lstm(torch.Generator().manual_seed(1), 24, 32, 3).to(dev).requires_grad_(False)
    x = torch.from_numpy(
        np.random.default_rng(6).normal(size=(rows, 7, 24)).astype(np.float32)
    ).to(dev)
    row2 = fused_lstm_stack.lstm_stack_last_all
    before = _eval_counts(row2), gemm_nn.launches
    got = row2(lstm.layers, x, compute_dtype=dtype)
    ref = fused_lstm_stack.lstm_stack_plain(lstm.layers, x, dtype)
    assert (_eval_counts(row2), gemm_nn.launches) == (
        (before[0][0] + 1, before[0][1] + 3, before[0][2] + 3), before[1] + 3)
    torch.testing.assert_close(got, ref, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
def test_gcn_kernel_rejects_unaligned_nodes(dev):
    enc = init_encoder(torch.Generator().manual_seed(0), CFG).to(dev).requires_grad_(False)
    with pytest.raises(ValueError, match="multiples of 128"):
        fused_gcn.fused_gcn_stack(
            enc.layers, torch.eye(100, device=dev),
            torch.zeros((2, 100, CFG.in_channels), device=dev),
        )


def _rel(got, ref):
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max())


def _fwd_bwd(fn, inputs, params):
    """fn(*inputs) and the gradients of <out, fixed cotangent> w.r.t.
    inputs + params."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    for p in params:
        p.grad = None
    out = fn(*leaves)
    ct = torch.from_numpy(
        np.random.default_rng(9).normal(size=out.shape).astype(np.float32)
    ).to(out.device, out.dtype)
    grads = torch.autograd.grad(out, leaves + list(params), ct)
    return out.detach(), grads


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nodes", [117, 128])
def test_gcn_train_kernels_match_plain(dev, dtype, nodes):
    """Rows 6-7, forward and every gradient, with dropout masks (the
    standalone STGCN's: after every layer)."""
    enc = init_encoder(torch.Generator().manual_seed(0), CFG).to(dev)
    a_hat = _a_hat(dev)[:nodes, :nodes].contiguous()
    x = torch.from_numpy(
        np.random.default_rng(5).normal(size=(7, nodes, CFG.in_channels)).astype(np.float32)
    ).to(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    masks = draw_mask(gen, (CFG.gcn_layers, 7, nodes, CFG.hidden_channels), 0.2, dev)
    params = [p for layer in enc.layers for p in (layer.w, layer.b)]
    before = (fused_gcn_train.gcn_stack_train.launches,
              fused_gcn_train.gcn_stack_train.backward_launches)
    got, got_g = _fwd_bwd(
        lambda x: fused_gcn_train.gcn_stack_train(
            enc.layers, a_hat, x, masks=masks, keep=0.8, compute_dtype=dtype), [x], params)
    assert (fused_gcn_train.gcn_stack_train.launches,
            fused_gcn_train.gcn_stack_train.backward_launches) == (before[0] + 1, before[1] + 1)
    ref, ref_g = _fwd_bwd(
        lambda x: fused_gcn_train.gcn_stack_train_plain(enc.layers, a_hat, x, masks, 0.8, dtype),
        [x], params)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])
    for i, (g, r) in enumerate(zip(got_g, ref_g)):
        assert _rel(g, r) <= TOL[dtype], (i, _rel(g, r))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [100, 3000, 5000])
@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_lstm_train_kernels_match_plain(dev, dtype, rows, dropout):
    """Rows 4-5, forward and every gradient, at row counts that pick each
    row tile, none a multiple of it."""
    lstm = init_lstm(torch.Generator().manual_seed(1), 24, 32, 3).to(dev)
    x = torch.from_numpy(
        np.random.default_rng(6).normal(size=(rows, 7, 24)).astype(np.float32)
    ).to(dev)
    masks = None
    if dropout:
        gen = torch.Generator(device=dev).manual_seed(4)
        masks = draw_mask(gen, (2, 7, rows, 32), dropout, dev)
    keep = 1.0 - dropout
    params = [p for layer in lstm.layers for p in (layer.wx, layer.wh, layer.b)]
    train = fused_lstm_stack.lstm_stack_train
    counts = lambda: (train.launches, train.backward_launches,  # noqa: E731
                      train.backward_recurrence_launches, train.backward_gemm_nn_launches,
                      train.forward_recurrence_launches, train.forward_gemm_nn_launches)
    before = counts()
    got, got_g = _fwd_bwd(
        lambda x: fused_lstm_stack.lstm_stack_train(
            lstm.layers, x, masks=masks, keep=keep, compute_dtype=dtype), [x], params)
    # Rows 4 and 5: a recurrence and a GEMM-core launch a layer each way.
    assert counts() == (before[0] + 1, before[1] + 1, before[2] + 3, before[3] + 3,
                        before[4] + 3, before[5] + 3)
    ref, ref_g = _fwd_bwd(
        lambda x: fused_lstm_stack.lstm_stack_plain(lstm.layers, x, dtype, masks, keep),
        [x], params)
    torch.testing.assert_close(got, ref, rtol=TOL[dtype], atol=TOL[dtype])
    for i, (g, r) in enumerate(zip(got_g, ref_g)):
        assert _rel(g, r) <= TOL[dtype], (i, _rel(g, r))


def _leaves_and_grads(dev, tasks, scale):
    """The reference model's 23 leaves (task axis of `tasks` when > 1) and
    numpy-drawn gradients of global norm ~`scale` per task."""
    model = init_model(torch.Generator().manual_seed(3), ModelConfig(), device=dev)
    params = [p.detach() for p in model.parameters()]
    if tasks > 1:
        params = [torch.stack([p * (1 + 0.1 * v) for v in range(tasks)]) for p in params]
    rng = np.random.default_rng(8)
    grads = [torch.from_numpy(rng.normal(size=p.shape).astype(np.float32)).to(dev)
             for p in params]
    norm = float(torch.sqrt(sum(torch.sum(g * g) for g in grads))) / tasks ** 0.5
    return params, [g * (scale / norm) for g in grads]


@pytest.mark.cuda
@pytest.mark.parametrize("tasks", [1, 4])
@pytest.mark.parametrize("scale", [0.5, 30.0])
def test_clip_sgd_kernel_matches_plain(dev, tasks, scale):
    """Rows 8 (one task) and 9 (a task axis): the whole tree, gradient
    norms below and above clip_norm 1.0; two launches give the same bits."""
    params, grads = _leaves_and_grads(dev, tasks, scale)
    batched = tasks > 1
    counter = "batched_launches" if batched else "launches"
    before = getattr(fused_sgd.clip_sgd_update, counter)
    got = [p.clone() for p in params]
    fused_sgd.clip_sgd_update(got, grads, 0.01, 1.0, batched=batched)
    again = [p.clone() for p in params]
    fused_sgd.clip_sgd_update(again, grads, 0.01, 1.0, batched=batched)
    assert getattr(fused_sgd.clip_sgd_update, counter) == before + 2
    ref = [p.clone() for p in params]
    fused_sgd.clip_sgd_update_plain(ref, grads, 0.01, 1.0, batched=batched)
    for g, a, r in zip(got, again, ref):
        assert torch.equal(g, a)
        assert _rel(g, r) <= TOL[torch.float32]


def _offset_copy(p):
    """A copy of p as far off 16-byte alignment as p is."""
    off = p.storage_offset() % 4
    return torch.empty(p.numel() + off, device=p.device)[off:].view(p.shape).copy_(p)


@pytest.mark.cuda
@pytest.mark.parametrize("tasks", [1, 3])
def test_clip_sgd_kernel_odd_leaves(dev, tasks):
    """Ragged chunk ends, sizes not a multiple of 4 and a parameter one
    float off 16-byte alignment (the kernel's scalar paths), above
    clip_norm: against plain, and two calls bitwise equal."""
    rng = np.random.default_rng(9)
    lead = (tasks,) if tasks > 1 else ()
    params = [torch.from_numpy(rng.normal(size=lead + s).astype(np.float32)).to(dev)
              for s in ((31, 7), (5,), (3, 1000), (1,), (64, 64))]
    base = torch.from_numpy(rng.normal(size=1 + 333 * tasks).astype(np.float32)).to(dev)
    params.append(base[1:].reshape(lead + (333,)))
    grads = [torch.from_numpy(rng.normal(size=p.shape).astype(np.float32) * 3).to(dev)
             for p in params]
    got, again = [_offset_copy(p) for p in params], [_offset_copy(p) for p in params]
    assert got[-1].data_ptr() % 16 != 0
    fused_sgd.clip_sgd_update(got, grads, 0.01, 1.0, batched=tasks > 1)
    fused_sgd.clip_sgd_update(again, grads, 0.01, 1.0, batched=tasks > 1)
    ref = [p.clone() for p in params]
    fused_sgd.clip_sgd_update_plain(ref, grads, 0.01, 1.0, batched=tasks > 1)
    for g, a, r in zip(got, again, ref):
        assert torch.equal(g, a)
        assert _rel(g, r) <= TOL[torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("tasks", [1, 4])
def test_clip_sgd_kernel_graph_replay(dev, tasks):
    """One call captured in a CUDA graph (its own scratch), replayed: the
    same bits as an eager call."""
    params, grads = _leaves_and_grads(dev, tasks, 30.0)
    eager, replayed = [p.clone() for p in params], [p.clone() for p in params]
    fused_sgd.clip_sgd_update(eager, grads, 0.01, 1.0, batched=tasks > 1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        fused_sgd.clip_sgd_update(replayed, grads, 0.01, 1.0, batched=tasks > 1)
    graph.replay()
    torch.cuda.synchronize()
    for e, r in zip(eager, replayed):
        assert torch.equal(e, r)


@pytest.mark.cuda
def test_clip_sgd_kernel_refuses_what_it_does_not_take(dev):
    p = [torch.zeros(4, device=dev, dtype=torch.bfloat16)]
    with pytest.raises(TypeError, match="float32"):
        fused_sgd.clip_sgd_update(p, [torch.ones_like(p[0])], 0.1, 1.0)
    p = [torch.zeros((4, 4), device=dev).t()]
    with pytest.raises(ValueError, match="contiguous"):
        fused_sgd.clip_sgd_update(p, [torch.ones_like(p[0])], 0.1, 1.0)


@pytest.mark.cuda
def test_fo_meta_gradient_kernels_match_plain(dev):
    """One micro-batch of the FO meta step (2 tasks, 2 inner steps each,
    dropout on): kernel route (rows 4-8) against the plain route (the plain
    stacks, the per-leaf clip + SGD), same masks."""
    cfg = ModelConfig(hidden_channels=64, gcn_layers=3, lstm_hidden=32, lstm_layers=3,
                      window=7, horizon=3)
    meta = MetaConfig(inner_epochs=1, inner_batches=2)
    regions = [synthetic_region_for_box((10.0 + 3 * i, 12.0 + 3 * i, 20.0, 23.0),
                                        num_timesteps=40, seed=i) for i in range(2)]
    tasks = stack_tasks([b.task for b in build_meta_tasks(regions, cfg, meta, DataConfig())])
    tasks = type(tasks)(*(f.to(dev) for f in tasks))
    model = init_model(torch.Generator().manual_seed(2), cfg, device=dev)
    out = {}
    before = fused_sgd.clip_sgd_update.launches
    for route, mc, mt in (
        ("kernel", cfg, meta),
        ("plain", ModelConfig(**{**cfg.__dict__, "use_pallas_gcn": False, "lstm_kernel": "xla"}),
         MetaConfig(inner_epochs=1, inner_batches=2, fused_inner_update=False)),
    ):
        gen = torch.Generator(device=dev).manual_seed(7)
        out[route] = task_batch_grad(model, tasks, gen, mc, mt)
    assert fused_sgd.clip_sgd_update.launches == before + 4
    tol = TOL[torch.float32]
    torch.testing.assert_close(out["kernel"][0], out["plain"][0], rtol=tol, atol=tol)
    for name, g in out["kernel"][1].items():
        assert _rel(g, out["plain"][1][name]) <= tol, name


def _r_op_inputs(dev, t_len, rows, c_in, hidden, layers, dropout, seed=0, w_scale=0.3):
    """Primals and tangents of the stack's R-operator, drawn with numpy
    (the weights and their tangents at w_scale)."""
    rng = np.random.default_rng(seed)

    def arr(shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(dev)

    ks = [(c_in if l == 0 else hidden) + hidden for l in range(layers)]
    masks = None
    if dropout and layers > 1:
        masks = torch.from_numpy(
            (rng.uniform(size=(layers - 1, t_len, rows, hidden)) >= dropout).astype(np.int8)
        ).to(dev)
    return dict(
        x=arr((t_len, rows, c_in)), tx=arr((t_len, rows, c_in)),
        wcat=[arr((k, 4 * hidden), w_scale) for k in ks],
        twcat=[arr((k, 4 * hidden), w_scale) for k in ks],
        b2d=arr((layers, 4 * hidden), 0.1), tb2d=arr((layers, 4 * hidden), 0.1),
        g=arr((rows, hidden)), tg=arr((rows, hidden)), masks=masks,
        keep=1.0 - dropout if masks is not None else 1.0,
    )


def r_ops(a, dtype, kernels):
    """Rows 4 + 10 then 5 + 11 (kernels) or their plain versions: the
    primal outputs and the tangents of the stack forward and backward."""
    fh = fused_lstm_hvp
    m, keep = a["masks"], a["keep"]
    if kernels:
        h_last, h_all, c_all, gates = fh.stack_fwd(a["x"], a["wcat"], a["b2d"], m, keep, dtype)
        th_last, th_all, tc_all, tgates = fh.hvp_stack_fwd(
            a["x"], a["tx"], a["wcat"], a["twcat"], a["b2d"], a["tb2d"], m, keep, dtype,
            res=(h_all, c_all, gates))
        dx, dw, db, dgates, dh_all, dc_all = fh.stack_bwd(
            a["g"], a["x"], h_all, c_all, gates, a["wcat"], m, keep, dtype)
        tdx, tdw, tdb = fh.hvp_stack_bwd(
            a["g"], a["tg"], a["x"], a["tx"], h_all, th_all, c_all, tc_all, gates, tgates,
            a["wcat"], a["twcat"], m, keep, dtype, res=(dgates, dh_all, dc_all))
    else:
        (h_last, h_all, c_all, gates, th_last, th_all, tc_all, tgates) = fh.hvp_fwd_plain(
            a["x"], a["wcat"], a["b2d"], m, keep, dtype, a["tx"], a["twcat"], a["tb2d"])
        dx, dw, db, _, _, _, tdx, tdw, tdb = fh.hvp_bwd_plain(
            a["g"], a["x"], h_all, c_all, gates, a["wcat"], m, keep, dtype,
            a["tg"], a["tx"], th_all, tc_all, tgates, a["twcat"])
    primal = [h_last, h_all, c_all, dx, *dw, db]
    tangent = [th_last, th_all, tc_all, tgates, tdx, *tdw, tdb]
    return primal, tangent


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(7, 100, 24, 32, 3), (7, 3000, 24, 32, 3),
                                   (5, 5000, 64, 32, 2), (7, 100, 24, 32, 1)])
@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_hvp_kernels_match_plain(dev, dtype, shape, dropout):
    """Rows 10-11 (after rows 4-5 at the same point) against the plain
    R-operator, at row counts that pick each row tile and one layer.
    Tangents: max|diff| / max|ref| <= 1e-4 in float32 (the tangent of a
    backward compounds about twice the rounding of the backward)."""
    a = _r_op_inputs(dev, *shape, dropout)
    before = (fused_lstm_hvp.hvp_stack_fwd.launches, fused_lstm_hvp.hvp_stack_bwd.launches)
    got_p, got_t = r_ops(a, dtype, kernels=True)
    assert (fused_lstm_hvp.hvp_stack_fwd.launches,
            fused_lstm_hvp.hvp_stack_bwd.launches) == (before[0] + 1, before[1] + 1)
    ref_p, ref_t = r_ops(a, dtype, kernels=False)
    tol = TOL[dtype]
    for i, (g, r) in enumerate(zip(got_p, ref_p)):
        if i < 3:  # the forward's outputs
            torch.testing.assert_close(g.float(), r.float(), rtol=tol, atol=tol)
        else:
            assert _rel(g, r) <= tol, (i, _rel(g, r))
    ttol = 1e-4 if dtype == torch.float32 else tol
    for i, (g, r) in enumerate(zip(got_t, ref_t)):
        assert _rel(g, r) <= ttol, (i, _rel(g, r))


@pytest.mark.cuda
def test_hvp_kernels_refuse_what_they_do_not_take(dev):
    a = _r_op_inputs(dev, 3, 16, 12, 32, 2, 0.0)
    with pytest.raises(ValueError, match="multiples of 8"):
        fused_lstm_hvp.stack_fwd(a["x"], a["wcat"], a["b2d"], None, 1.0, torch.float32)
    a = _r_op_inputs(dev, 3, 16, 24, 32, 2, 0.2)
    with pytest.raises(ValueError, match="masks"):
        fused_lstm_hvp.stack_fwd(a["x"], a["wcat"], a["b2d"], a["masks"][:, :2], 0.8,
                                 torch.float32)


@pytest.mark.cuda
def test_so_meta_gradient_kernels_match_plain(dev):
    """One micro-batch of the SO meta step (fhvp, 2 tasks, 2 inner steps
    each, dropout on): kernel route (rows 4-7 for each inner gradient, rows
    4-5 and 10-11 for each Hessian-vector product) against the plain route
    (jvp of the plain loss's gradient), same masks. The tangent of a
    backward compounds about twice the rounding: max|diff| / max|ref| 1e-4."""
    cfg = ModelConfig(hidden_channels=64, gcn_layers=3, lstm_hidden=32, lstm_layers=3,
                      window=7, horizon=3)
    meta = MetaConfig(inner_epochs=1, inner_batches=2, second_order=True)
    regions = [synthetic_region_for_box((10.0 + 3 * i, 12.0 + 3 * i, 20.0, 23.0),
                                        num_timesteps=40, seed=i) for i in range(2)]
    tasks = stack_tasks([b.task for b in build_meta_tasks(regions, cfg, meta, DataConfig())])
    tasks = type(tasks)(*(f.to(dev) for f in tasks))
    model = init_model(torch.Generator().manual_seed(2), cfg, device=dev)
    out = {}
    before = (fused_lstm_hvp.hvp_stack_fwd.launches, fused_lstm_hvp.hvp_stack_bwd.launches)
    for route, mc in (
        ("kernel", cfg),
        ("plain", ModelConfig(**{**cfg.__dict__, "use_pallas_gcn": False, "lstm_kernel": "xla"})),
    ):
        gen = torch.Generator(device=dev).manual_seed(7)
        out[route] = task_batch_grad(model, tasks, gen, mc, meta)
    assert (fused_lstm_hvp.hvp_stack_fwd.launches,
            fused_lstm_hvp.hvp_stack_bwd.launches) == (before[0] + 4, before[1] + 4)
    tol = TOL[torch.float32]
    torch.testing.assert_close(out["kernel"][0], out["plain"][0], rtol=tol, atol=tol)
    for name, g in out["kernel"][1].items():
        assert _rel(g, out["plain"][1][name]) <= 1e-4, (name, _rel(g, out["plain"][1][name]))


def _shard_inputs(dev, dtype, nl, has_next, has_mask, n=128, w=7, hid=64, hid_next=48):
    rng = np.random.default_rng(nl + 2 * has_next + has_mask)

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(dev)

    return dict(
        hw_full=arr(n, w, hid).to(dtype),
        a_rows=(arr(nl, n).abs() / n).contiguous(),
        b=arr(hid, scale=0.1), w_next=arr(hid, hid_next, scale=0.1) if has_next else None,
        mask=torch.from_numpy((rng.uniform(size=(nl, w, hid)) < 0.8).astype(np.int8)).to(dev)
        if has_mask else None,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nl", [128, 64, 40])  # 1, 2 and 3 shards; 40 rows: a ragged tile
@pytest.mark.parametrize("has_next", [True, False])
@pytest.mark.parametrize("has_mask", [True, False])
def test_gcn_shard_kernels_match_plain(dev, dtype, nl, has_next, has_mask):
    """Rows 12-13 (the sandwich layer, node-major), forward and the
    gradients of hw_full, b and w_next, against the plain version."""
    # NL must divide N: 40 rows are a third of a 120-node graph.
    a = _shard_inputs(dev, dtype, nl, has_next, has_mask, n=120 if nl == 40 else 128)
    leaves = [a["hw_full"], a["b"]] + ([a["w_next"]] if has_next else [])
    outs, grads = {}, {}
    before = (fused_gcn_shard.gcn_shard_layer.launches,
              fused_gcn_shard.gcn_shard_layer.backward_launches)
    for route, fn in (("kernel", fused_gcn_shard.gcn_shard_layer),
                      ("plain", fused_gcn_shard.shard_layer_plain)):
        xs = [t.detach().clone().requires_grad_(True) for t in leaves]
        out = fn(xs[0], a["a_rows"], xs[1], xs[2] if has_next else None, a["mask"], 0.8, dtype)
        out = out if has_next else (out,)
        cts = [torch.from_numpy(np.random.default_rng(i).normal(size=o.shape).astype(
            np.float32)).to(dev, o.dtype) for i, o in enumerate(out)]
        grads[route] = torch.autograd.grad(out, xs, cts)
        outs[route] = [o.detach() for o in out]
    assert (fused_gcn_shard.gcn_shard_layer.launches,
            fused_gcn_shard.gcn_shard_layer.backward_launches) == (before[0] + 1, before[1] + 1)
    tol = TOL[dtype]
    for g, r in zip(outs["kernel"], outs["plain"]):
        torch.testing.assert_close(g.float(), r.float(), rtol=tol, atol=tol)
    for g, r in zip(grads["kernel"], grads["plain"]):
        assert _rel(g, r) <= tol, _rel(g, r)


@pytest.mark.cuda
def test_gcn_shard_kernels_refuse_what_they_do_not_take(dev):
    a = _shard_inputs(dev, torch.float32, 64, True, True)
    args = (a["hw_full"], a["a_rows"], a["b"], a["w_next"], a["mask"], 0.8)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_gcn_shard.gcn_shard_layer(*args, torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_gcn_shard.gcn_shard_layer(a["hw_full"].half(), *args[1:], torch.float32)
    with pytest.raises(ValueError, match="mask"):
        fused_gcn_shard.gcn_shard_layer(*args[:4], a["mask"][:, :3].contiguous(), 0.8)
    with pytest.raises(ValueError, match="NL dividing"):
        fused_gcn_shard.gcn_shard_layer(args[0], a["a_rows"][:, :100].contiguous(), *args[2:])


@pytest.mark.cuda
def test_sharded_meta_gradient_matches_unsharded(dev):
    """The node-sharded FO meta-gradient on a 1 x 1 mesh (a NCCL group of
    one rank; rows 12-13 for the encoder, rows 4-5 and 8) against the
    unsharded kernel route, 2 tasks x 2 inner steps, dropout 0. float32,
    max|diff| / max|ref| 1e-5."""
    import torch.distributed as dist

    from weatherforecast_stgcn_maml_tpu_torch.parallel import distributed
    from weatherforecast_stgcn_maml_tpu_torch.parallel.mesh import make_mesh_2d
    from weatherforecast_stgcn_maml_tpu_torch.parallel.meta_sp import make_shardmap_batch_grad

    cfg = ModelConfig(hidden_channels=64, gcn_layers=3, lstm_hidden=32, lstm_layers=3,
                      window=7, horizon=3, gcn_dropout=0.0, lstm_dropout=0.0)
    meta = MetaConfig(inner_epochs=1, inner_batches=2)
    regions = [synthetic_region_for_box((10.0 + 3 * i, 12.0 + 3 * i, 20.0, 23.0),
                                        num_timesteps=40, seed=i) for i in range(2)]
    tasks = stack_tasks([b.task for b in build_meta_tasks(regions, cfg, meta, DataConfig())])
    tasks = type(tasks)(*(f.to(dev) for f in tasks))
    model = init_model(torch.Generator().manual_seed(2), cfg, device=dev)
    assert distributed.ensure_process_group("nccl")
    try:
        mesh = make_mesh_2d(1, 1, dev)
        before = fused_gcn_shard.gcn_shard_layer.launches
        losses, grads = make_shardmap_batch_grad(cfg, meta, mesh)(model, tasks, None)
        # 2 tasks x (2 inner steps + 1 query) forwards, one launch a layer.
        assert fused_gcn_shard.gcn_shard_layer.launches == before + 3 * 2 * 3
    finally:
        dist.destroy_process_group()
    ref_losses, ref_grads = task_batch_grad(model, tasks, None, cfg, meta)
    tol = TOL[torch.float32]
    torch.testing.assert_close(losses, ref_losses, rtol=tol, atol=tol)
    for name, g in grads.items():
        assert _rel(g, ref_grads[name]) <= tol, (name, _rel(g, ref_grads[name]))


@pytest.mark.cuda
def test_sharded_so_meta_gradient_matches_unsharded(dev):
    """The second-order fhvp meta-gradient on a 1 x 1 dp x sp mesh (a NCCL
    group of one rank) against the unsharded SO meta-gradient, 2 tasks x 2
    inner steps, dropout 0: rows 12-13 in the inner gradient's forward (one
    launch a layer a forward), rows 10-11 in its Hessian transpose (one
    launch each an inner step). float32, max|diff| / max|ref| 1e-4 (the SO
    tangent gate)."""
    import torch.distributed as dist

    from weatherforecast_stgcn_maml_tpu_torch.parallel import distributed
    from weatherforecast_stgcn_maml_tpu_torch.parallel.mesh import make_mesh_2d
    from weatherforecast_stgcn_maml_tpu_torch.parallel.meta_sp import make_shardmap_batch_grad

    cfg = ModelConfig(hidden_channels=64, gcn_layers=3, lstm_hidden=32, lstm_layers=3,
                      window=7, horizon=3, gcn_dropout=0.0, lstm_dropout=0.0)
    meta = MetaConfig(inner_epochs=1, inner_batches=2, second_order=True, so_impl="fhvp")
    regions = [synthetic_region_for_box((10.0 + 3 * i, 12.0 + 3 * i, 20.0, 23.0),
                                        num_timesteps=40, seed=i) for i in range(2)]
    tasks = stack_tasks([b.task for b in build_meta_tasks(regions, cfg, meta, DataConfig())])
    tasks = type(tasks)(*(f.to(dev) for f in tasks))
    model = init_model(torch.Generator().manual_seed(2), cfg, device=dev)
    counters = (fused_gcn_shard.gcn_shard_layer, fused_lstm_hvp.hvp_stack_fwd,
                fused_lstm_hvp.hvp_stack_bwd)
    assert distributed.ensure_process_group("nccl")
    try:
        mesh = make_mesh_2d(1, 1, dev)
        before = [fn.launches for fn in counters]
        losses, grads = make_shardmap_batch_grad(cfg, meta, mesh)(model, tasks, None)
        launches = [fn.launches - b for fn, b in zip(counters, before)]
    finally:
        dist.destroy_process_group()
    # 2 tasks x (2 inner steps + 1 query) forwards of 3 layers; 2 x 2 steps.
    assert launches == [3 * 2 * 3, 2 * 2, 2 * 2]
    ref_losses, ref_grads = task_batch_grad(model, tasks, None, cfg, meta)
    tol = TOL[torch.float32]
    torch.testing.assert_close(losses, ref_losses, rtol=tol, atol=tol)
    for name, g in grads.items():
        assert _rel(g, ref_grads[name]) <= 1e-4, (name, _rel(g, ref_grads[name]))


# Rows 18-19 (the per-layer recurrence), 20 (the eval stack as per-layer
# projections and recurrences) and 3 (one GCN layer), at small widths and
# at the reference width (T = 24, 512 rows, 4H = 512; [512, 24, 256] with 4
# layers of 128; [24, 512, 256] -> 256).


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(7, 100, 32), (7, 3000, 12), (24, 512, 128)])
def test_lstm_recurrence_kernels_match_plain(dev, dtype, shape):
    """Rows 18-19: h_all, dxp and dwh against the plain recurrence under
    autograd, at row counts that pick each row tile. Hidden 12 under
    bfloat16 is refused (row 18's cluster recurrence loads the bfloat16 h
    tile 8 units at a time); under float32 it runs."""
    t_len, rows, hidden = shape
    draw = np.random.default_rng(7)
    xp = torch.from_numpy(draw.normal(size=(t_len, rows, 4 * hidden)).astype(np.float32)).to(dev)
    wh = torch.from_numpy((draw.normal(size=(hidden, 4 * hidden)) * 0.1).astype(np.float32)
                          ).to(dev).requires_grad_(True)
    if dtype == torch.bfloat16 and hidden % 8:
        with pytest.raises(ValueError, match="bfloat16 compute at hidden widths that are "
                                             "multiples of 8"):
            lstm_scan.lstm_recurrence(xp, wh, compute_dtype=dtype)
        return
    before = (lstm_scan.lstm_recurrence.launches, lstm_scan.lstm_recurrence.backward_launches)
    got, got_g = _fwd_bwd(lambda a: lstm_scan.lstm_recurrence(a, wh, compute_dtype=dtype),
                          [xp], [wh])
    assert (lstm_scan.lstm_recurrence.launches,
            lstm_scan.lstm_recurrence.backward_launches) == (before[0] + 1, before[1] + 1)
    ref, ref_g = _fwd_bwd(lambda a: lstm_scan.lstm_recurrence_plain(a, wh, dtype), [xp], [wh])
    torch.testing.assert_close(got, ref, rtol=TOL[dtype], atol=TOL[dtype])
    for i, (g, r) in enumerate(zip(got_g, ref_g)):
        assert _rel(g, r) <= TOL[dtype], (i, _rel(g, r))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,hidden", [(512, 128), (1024, 128), (441, 128), (48, 64),
                                         (48, 256), (100, 32)])
def test_lstm_recurrence_forward_matches_its_plain_piece(dev, dtype, rows, hidden):
    """Row 18 alone (`scan_forward`, the cluster forward recurrence by
    `forward_plan`: clusters of 1, 2, 4 and 8, row tiles of 2-16) against
    `scan_forward_plain`: h_all, c_all (float32 under either compute dtype)
    and the gates; without a backward no gates are kept."""
    xp = _card(dev, (24, rows, 4 * hidden), seed=rows)
    wh = _card(dev, (hidden, 4 * hidden), seed=hidden, scale=hidden ** -0.5)
    before = lstm_scan.lstm_recurrence.launches
    got = lstm_scan.scan_forward(xp, wh, dtype, True)
    assert lstm_scan.lstm_recurrence.launches == before + 1
    ref = lstm_scan.scan_forward_plain(xp, wh, dtype, True)
    for name, g, r in zip(("h_all", "c_all", "gates"), got, ref):
        assert g.dtype == torch.float32 and g.shape == r.shape, name
        torch.testing.assert_close(g, r, rtol=TOL[dtype], atol=TOL[dtype], msg=name)
    h, c, gates = lstm_scan.scan_forward(xp, wh, dtype, False)
    assert gates is None and torch.equal(h, got[0]) and torch.equal(c, got[1])


@pytest.mark.cuda
def test_lstm_recurrence_refuses_what_it_does_not_take(dev):
    """Hidden widths that are no multiple of 4, float32 2056 (past H 2048 no
    plan holds even a streamed slice; float32 452, where no cluster of 16
    holds Wh, launches a streamed plan), 4H disagreeing, float64 inputs,
    float16 compute."""
    with pytest.raises(ValueError, match="multiples of 4"):
        lstm_scan.lstm_recurrence(torch.zeros((3, 8, 4 * 302), device=dev),
                                  torch.zeros((302, 1208), device=dev))
    rec = lstm_scan.lstm_recurrence
    before = rec.launches, rec.streamed_launches
    h = rec(torch.zeros((3, 8, 4 * 452), device=dev), torch.zeros((452, 1808), device=dev))
    assert (rec.launches, rec.streamed_launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(h, torch.zeros_like(h))  # gates 1/2, 0, 1/2: c and h stay 0
    with pytest.raises(ValueError, match="nor does a streamed slice"):
        lstm_scan.lstm_recurrence(torch.zeros((3, 8, 4 * 2056), device=dev),
                                  torch.zeros((2056, 8224), device=dev))
    xp = torch.zeros((3, 8, 4 * 300), device=dev)
    with pytest.raises(ValueError, match="disagree"):
        lstm_scan.lstm_recurrence(xp[..., :64], torch.zeros((8, 32), device=dev))
    with pytest.raises(TypeError, match="float32"):
        lstm_scan.lstm_recurrence(xp[..., :64].double(), torch.zeros((16, 64), device=dev))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        lstm_scan.lstm_recurrence(xp[..., :64], torch.zeros((16, 64), device=dev),
                                  compute_dtype=torch.float16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(100, 7, 24, 32, 3), (3000, 7, 24, 32, 1),
                                   (512, 24, 256, 128, 4)])
def test_fused_lstm_kernel_matches_plain(dev, dtype, shape):
    """Row 20's eval forward (row 14's schedule without residuals: L gemm_nn
    and L recurrence launches) and its train-mode forward (with residuals)
    against the plain layerwise route, and its gradients (row 15's schedule,
    2L gemm_tn launches) against autograd of the plain route."""
    rows, t_len, c_in, hidden, layers = shape
    lstm = init_lstm(torch.Generator().manual_seed(1), c_in, hidden, layers).to(dev)
    x = torch.from_numpy(
        np.random.default_rng(6).normal(size=(rows, t_len, c_in)).astype(np.float32)).to(dev)
    params = [p for layer in lstm.layers for p in (layer.wx, layer.wh, layer.b)]
    row20 = fused_lstm.fused_lstm_last_hidden
    with torch.no_grad():
        before = _eval_counts(row20)
        got = row20(lstm.layers, x, compute_dtype=dtype)
        assert _eval_counts(row20) == (before[0] + 1, before[1] + layers, before[2] + layers)
        torch.testing.assert_close(got, fused_lstm_stack.lstm_stack_plain(lstm.layers, x, dtype),
                                   rtol=TOL[dtype], atol=TOL[dtype])
    before = _eval_counts(row20), row20.backward_launches, row20.backward_gemm_tn_launches
    got, got_g = _fwd_bwd(lambda a: row20(lstm.layers, a, compute_dtype=dtype), [x], params)
    assert (_eval_counts(row20), row20.backward_launches, row20.backward_gemm_tn_launches) == (
        (before[0][0] + 1, before[0][1] + layers, before[0][2] + layers), before[1] + 1,
        before[2] + 2 * layers)
    ref, ref_g = _fwd_bwd(lambda a: fused_lstm_stack.lstm_stack_plain(lstm.layers, a, dtype),
                          [x], params)
    torch.testing.assert_close(got, ref, rtol=TOL[dtype], atol=TOL[dtype])
    for i, (g, r) in enumerate(zip(got_g, ref_g)):
        assert _rel(g, r) <= TOL[dtype], (i, _rel(g, r))


@pytest.mark.cuda
def test_retired_kernels_are_gone(dev):
    """The library exports no `wf_gemm` (gemm.cu's SIMT GEMM, whose last
    caller was row 20's projections) and no entry of the retired row 2 and
    row 20 kernels; their sources are gone. This stands for the former
    "no gemm.cu GEMM launched" gates: none can launch."""
    import os

    lib = cuda_build.load()
    for name in ("wf_gemm", "wf_lstm_stack_last", "wf_fused_lstm_last"):
        assert not hasattr(lib, name), name
    assert hasattr(lib, "wf_sum_splits")
    csrc = os.path.join(os.path.dirname(cuda_build.__file__), "csrc")
    for name in ("fused_lstm_stack.cu", "fused_lstm.cu", "lstm_recurrence.cuh"):
        assert not os.path.exists(os.path.join(csrc, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1536, 512])
def test_eval_rows_2_and_20_at_full_width(dev, dtype, rows):
    """Rows 2 and 20 at validate's [1536, 24, 256] and the forecast's [512,
    24, 256], 4 layers of 128, against the plain stack; each call one C
    call of 4 gemm_nn and 4 recurrence launches, counted on its own entry;
    float32 at 1536 rows on 48 clusters of 2 blocks x 32 rows, all
    co-resident."""
    fls = fused_lstm_stack
    lstm = init_lstm(torch.Generator().manual_seed(2), 256, 128, 4).to(dev).requires_grad_(False)
    x = _card(dev, (rows, 24, 256), seed=rows)
    plan = fls.forward_plan(128, rows, dtype.itemsize, fls._sms(dev))
    if dtype == torch.float32 and rows == 1536 and fls._sms(dev) == fls.H100_SMS:
        assert plan == (2, 64, 32, 128)
        assert cuda_build.load().wf_lstm_stack_forward_clusters(0, *plan[:3], 128) >= 48
    ref = fls.lstm_stack_plain(lstm.layers, x, dtype)
    entries = (fls.lstm_stack_last_all, fused_lstm.fused_lstm_last_hidden)
    for entry in entries:
        before = [_eval_counts(e) for e in entries], gemm_nn.launches
        with torch.no_grad():
            got = entry(lstm.layers, x, compute_dtype=dtype)
        assert gemm_nn.launches == before[1] + 4
        for e, b in zip(entries, before[0]):
            assert _eval_counts(e) == ((b[0] + 1, b[1] + 4, b[2] + 4) if e is entry else b)
        torch.testing.assert_close(got, ref, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden,rows", [(128, 1536), (64, 3000), (32, 3000)])
def test_forward_recurrence_wide_tile_matches_plain(dev, dtype, hidden, rows):
    """The forward recurrence alone where the plan takes 32 rows a cluster
    (bfloat16 only at 32 weight columns: H 128 and 64 keep 16) against its
    plain version, 5 steps, with a mask and the last h; a bfloat16 32-row
    tile at 64 weight columns is refused."""
    fls = fused_lstm_stack
    cs, hcp, rb, _ = fls.forward_plan(hidden, rows, dtype.itemsize, fls._sms(dev))
    if fls._sms(dev) == fls.H100_SMS:
        assert rb == (32 if dtype == torch.float32 or hidden == 32 else 16)
    xp = _card(dev, (5, rows, 4 * hidden), seed=hidden)
    wh = _card(dev, (hidden, 4 * hidden), seed=hidden + 1, scale=hidden ** -0.5)
    bias = _card(dev, (4 * hidden,), seed=hidden + 2, scale=0.1)
    mask = (_card(dev, (5, rows, hidden), seed=hidden + 3) > -0.84).to(torch.int8)
    outs = {}
    for name, piece in (("kernel", fls._forward_recurrence_card),
                        ("plain", fls._forward_recurrence_plain)):
        gates = xp.clone()
        res = [torch.empty((5, rows, hidden), dtype=dtype, device=dev) for _ in range(3)]
        h_last = torch.empty((rows, hidden), device=dev)
        piece(gates, wh, bias, dtype, res[0], res[1], mask=mask, inv_keep=1.25, next_in=res[2],
              h_last=h_last)
        outs[name] = (gates, *res, h_last)
    for i, (a, b) in enumerate(zip(outs["kernel"], outs["plain"])):
        torch.testing.assert_close(a.float(), b.float(), rtol=TOL[dtype], atol=TOL[dtype],
                                   msg=str(i))
    if dtype == torch.bfloat16 and hidden == 64:
        h = torch.empty((5, rows, 64), dtype=dtype, device=dev)
        whc = wh.to(dtype)
        err = cuda_build.load().wf_lstm_stack_forward_recurrence(fls._SCAN_FWD.pack(
            1, 1, 64, 32, xp.data_ptr(), xp.data_ptr(), whc.data_ptr(), 256,
            bias.data_ptr(), h.data_ptr(), h.data_ptr(), 0, 0, 1.0, 0, 0, 5, rows, 64,
            cuda_build.stream_ptr(dev), 1, *[0] * 8, -1))
        with pytest.raises(RuntimeError, match="invalid argument"):
            cuda_build.check(err, "bfloat16, 32 rows at 64 weight columns")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [((3, 7), 117, 24, 64), ((24,), 512, 256, 256),
                                   ((72,), 512, 24, 256)])
def test_gcn_layer_kernels_match_plain(dev, dtype, shape):
    """Row 3: relu(A_hat (h W) + b) and dh, dW, db against the plain layer
    under autograd."""
    lead, nodes, c_in, c_out = shape
    draw = np.random.default_rng(8)
    if nodes < 128:
        a_hat = _a_hat(dev)[:nodes, :nodes].contiguous()
    else:  # the Moscow box's 441 nodes padded to 512
        a_hat = torch.from_numpy(build_region_graph(
            np.arange(10.0, 15.25, 0.25), np.arange(20.0, 25.25, 0.25)).a_hat).to(dev)
    layer = Dense(*(torch.from_numpy((draw.normal(size=s) * 0.1).astype(np.float32))
                    for s in ((c_in, c_out), (c_out,)))).to(dev)
    h = torch.from_numpy(draw.normal(size=(*lead, a_hat.shape[0], c_in)).astype(np.float32)).to(dev)
    before = (fused_gcn.fused_gcn_layer.launches, fused_gcn.fused_gcn_layer.backward_launches)
    got, got_g = _fwd_bwd(
        lambda a: fused_gcn.fused_gcn_layer(layer, a_hat, a, compute_dtype=dtype),
        [h], [layer.w, layer.b])
    assert (fused_gcn.fused_gcn_layer.launches,
            fused_gcn.fused_gcn_layer.backward_launches) == (before[0] + 1, before[1] + 1)
    ref, ref_g = _fwd_bwd(
        lambda a: torch.relu(apply_gcn_layer(layer, a_hat, a, compute_dtype=dtype)),
        [h], [layer.w, layer.b])
    assert got.dtype == torch.float32 and got.shape == (*lead, a_hat.shape[0], c_out)
    torch.testing.assert_close(got, ref, rtol=TOL[dtype], atol=TOL[dtype])
    for i, (g, r) in enumerate(zip(got_g, ref_g)):
        assert _rel(g, r) <= TOL[dtype], (i, _rel(g, r))


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [dict(use_pallas_lstm=True), dict(lstm_kernel="pallas")])
def test_lstm_routes_drive_their_kernels_in_the_model(dev, flags):
    """Eval and train mode through the hybrid: the route's kernels launch,
    the others do not, and the output matches the plain route."""
    cfg = dataclasses.replace(CFG, lstm_dropout=0.0, **flags)
    model = init_model(torch.Generator().manual_seed(3), cfg, device=dev)
    a_hat = _a_hat(dev)
    x = torch.from_numpy(
        np.random.default_rng(4).normal(size=(7, 128, 16)).astype(np.float32)).to(dev)
    counters = (fused_lstm.fused_lstm_last_hidden, lstm_scan.lstm_recurrence,
                fused_lstm_stack.lstm_stack_last_all, fused_lstm_stack.lstm_stack_train)
    before = [c.launches for c in counters]
    with torch.no_grad():
        got = apply_model(model, a_hat, x, 3, cfg)
        ref = apply_model(model, a_hat, x, 3,
                          dataclasses.replace(cfg, use_pallas_lstm=False, lstm_kernel="xla"))
    out = apply_model(model, a_hat, x, 3, cfg, train=True)
    out.sum().backward()
    launched = [c.launches - b for c, b in zip(counters, before)]
    want = [2, 0, 0, 0] if flags.get("use_pallas_lstm") else [0, 2 * cfg.lstm_layers, 0, 0]
    assert launched == want, launched
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_split_lstm_biases_run_the_kernels(dev):
    """A model whose LSTM layers carry torch's two biases (`load_params`)
    trains through the default route's kernels as through the plain route,
    each of the two biases taking the fused bias's gradient."""
    from weatherforecast_stgcn_maml_tpu_torch.models.registry import load_params

    cfg = dataclasses.replace(CFG, lstm_dropout=0.0, gcn_dropout=0.0)
    model = init_model(torch.Generator().manual_seed(3), cfg)
    sd = {}
    for k, v in model.state_dict().items():
        if k.startswith("lstm.") and k.endswith(".b"):
            sd[k + "_ih"], sd[k + "_hh"] = 0.5 * v, 0.5 * v
        else:
            sd[k] = v
    load_params(model, sd)
    model = model.to(dev)
    a_hat = _a_hat(dev)
    x = torch.from_numpy(
        np.random.default_rng(4).normal(size=(7, 128, 16)).astype(np.float32)).to(dev)
    plain = dataclasses.replace(cfg, use_pallas_gcn=False, lstm_kernel="xla")
    grads = []
    for route in (cfg, plain):
        out = apply_model(model, a_hat, x, 3, route, train=True)
        grads.append(dict(zip((n for n, _ in model.named_parameters()),
                              torch.autograd.grad(out.sum(), list(model.parameters())))))
    for name, g in grads[0].items():
        assert _rel(g, grads[1][name]) <= 1e-5, (name, _rel(g, grads[1][name]))
    torch.testing.assert_close(grads[0]["lstm.layers.0.b_ih"], grads[0]["lstm.layers.0.b_hh"])


def _task_weights(dev, nv, c_in, hidden, layers, seed):
    """Distinct per-task LSTM weights, stacked: (wcat0 [V, C + H, 4H], wcatr
    [V, L-1, 2H, 4H], b2d [V, L, 4H])."""
    lstms = [init_lstm(torch.Generator().manual_seed(seed + v), c_in, hidden, layers).layers
             for v in range(nv)]
    wcat0 = torch.stack([torch.cat([m[0].wx, m[0].wh]) for m in lstms])
    wcatr = (torch.stack([torch.stack([torch.cat([m[l].wx, m[l].wh]) for l in range(1, layers)])
                          for m in lstms]) if layers > 1
             else torch.zeros((nv, 0, 2 * hidden, 4 * hidden)))
    b2d = torch.stack([torch.stack([layer.b for layer in m]) for m in lstms])
    return [w.detach().to(dev) for w in (wcat0, wcatr, b2d)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nv,rows,layers", [(2, 100, 3), (3, 3000, 3), (4, 512, 3), (2, 100, 1)])
@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_lstm_tasks_kernels_match_plain(dev, dtype, nv, rows, layers, dropout):
    """Rows 16-17: V tasks with distinct weights, forward and every
    gradient (x and each task's weights), against the plain version."""
    if dropout and layers == 1:
        pytest.skip("one layer has no inter-layer dropout")
    weights = _task_weights(dev, nv, 24, 32, layers, 10)
    x = torch.from_numpy(
        np.random.default_rng(6).normal(size=(nv, rows, 7, 24)).astype(np.float32)).to(dev)
    masks = None
    if dropout:
        masks = draw_mask(torch.Generator(device=dev).manual_seed(4),
                          (nv, layers - 1, 7, rows, 32), dropout, dev)
    keep = 1.0 - dropout
    w0, wr, b2d = weights
    fn = fused_lstm_stack.lstm_stack_train_tasks
    before = (fn.launches, fn.backward_launches)
    # One layer's wcatr is empty and takes no gradient.
    got, got_g = _fwd_bwd(
        lambda x, w0, b, *wr: fn(x, w0, *(wr or [weights[1]]), b, masks=masks, keep=keep,
                                 compute_dtype=dtype),
        [x, w0, b2d, *([wr] if layers > 1 else [])], [])
    assert (fn.launches, fn.backward_launches) == (before[0] + 1, before[1] + 1)
    ref, ref_g = _fwd_bwd(
        lambda x, w0, b, *wr: fused_lstm_stack.lstm_stack_tasks_plain(
            x, w0, *(wr or [weights[1]]), b, masks, keep, dtype),
        [x, w0, b2d, *([wr] if layers > 1 else [])], [])
    torch.testing.assert_close(got, ref, rtol=TOL[dtype], atol=TOL[dtype])
    for i, (g, r) in enumerate(zip(got_g, ref_g)):
        assert _rel(g, r) <= TOL[dtype], (i, _rel(g, r))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nv,layers", [(2, 4), (3, 1)])
def test_lstm_tasks_kernels_with_shared_weights(dev, dtype, nv, layers):
    """Rows 16-17 with one set of weights broadcast over V windows (task
    stride 0, as the adaptation step's unfolded window batch passes them):
    the forward bitwise that of the same weights copied V times, and the
    weights' gradients (summed over V through the broadcast) equal to the
    copies' gradients summed over V; both against the plain version. No
    weight is copied a task: the C entries read the stride-0 weights."""
    w0, wr, b2d = (w[:1] for w in _task_weights(dev, 1, 128, 128, layers, 10))
    x = torch.from_numpy(
        np.random.default_rng(6).normal(size=(nv, 512, 24, 128)).astype(np.float32)).to(dev)
    masks = (draw_mask(torch.Generator(device=dev).manual_seed(4),
                       (nv, layers - 1, 24, 512, 128), 0.2, dev) if layers > 1 else None)
    fn = fused_lstm_stack.lstm_stack_train_tasks

    # One layer's wcatr is empty and takes no gradient.
    inputs = [x, w0, b2d, *([wr] if layers > 1 else [])]

    def run(stack, spread):
        def call(x, w0, b, *wr_):
            return stack(x, *(spread(w) for w in (w0, *(wr_ or [wr]), b)))
        return _fwd_bwd(call, inputs, [])

    def kernels(x, w0, wr_, b):
        return fn(x, w0, wr_, b, masks=masks, keep=0.8, compute_dtype=dtype)

    def plain(x, w0, wr_, b):
        return fused_lstm_stack.lstm_stack_tasks_plain(x, w0, wr_, b, masks, 0.8, dtype)

    shared, shared_g = run(kernels, lambda w: w.expand(nv, *w.shape[1:]))
    copied, copied_g = run(kernels, lambda w: w.repeat(nv, *[1] * (w.dim() - 1)))
    torch.testing.assert_close(shared, copied, rtol=0, atol=0)
    for i, (g, r) in enumerate(zip(shared_g, copied_g)):
        torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-6, msg=str(i))
    ref, ref_g = run(plain, lambda w: w.expand(nv, *w.shape[1:]))
    torch.testing.assert_close(shared, ref, rtol=TOL[dtype], atol=TOL[dtype])
    for i, (g, r) in enumerate(zip(shared_g, ref_g)):
        assert _rel(g, r) <= TOL[dtype], (i, _rel(g, r))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,layers", [(100, 3), (3000, 3), (5000, 3), (100, 1)])
@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_lstm_split_kernels_match_plain(dev, dtype, rows, layers, dropout):
    """Rows 14-15: the forward's last h and residuals against
    `split_forward_plain`, the backward from the same residuals against
    `split_backward_plain`, then the training entry (`merged=False`, rows
    14 + 15 behind the Function) and the eval entry against the plain
    stack."""
    if dropout and layers == 1:
        pytest.skip("one layer has no inter-layer dropout")
    lstm = init_lstm(torch.Generator().manual_seed(1), 24, 32, layers).to(dev)
    x = torch.from_numpy(
        np.random.default_rng(6).normal(size=(rows, 7, 24)).astype(np.float32)).to(dev)
    masks = None
    if dropout:
        masks = draw_mask(torch.Generator(device=dev).manual_seed(4),
                          (layers - 1, 7, rows, 32), dropout, dev)
    keep = 1.0 - dropout
    fls, tol = fused_lstm_stack, TOL[dtype]
    with torch.no_grad():
        w = [t.detach() for t in fls._split_weights(lstm.layers)]
        x_tbc = x.transpose(0, 1)
        before = (fls.lstm_stack_split.launches, fls.lstm_stack_split.backward_launches)
        got = fls.split_forward(x_tbc, *w, masks, keep, dtype)
        ref = fls.split_forward_plain(x_tbc, *w, masks, keep, dtype)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype
            torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)
        g = torch.from_numpy(
            np.random.default_rng(8).normal(size=(rows, 32)).astype(np.float32)).to(dev)
        got_b = fls.split_backward(g, x_tbc, ref[1], ref[2], *w, masks, keep, dtype)
        ref_b = fls.split_backward_plain(g, x_tbc, ref[1], ref[2], *w, masks, keep, dtype)
        assert (fls.lstm_stack_split.launches,
                fls.lstm_stack_split.backward_launches) == (before[0] + 1, before[1] + 1)
        for i, (a, b) in enumerate(zip(got_b, ref_b)):
            if b.numel():
                assert _rel(a, b) <= tol, (i, _rel(a, b))
    params = [p for layer in lstm.layers for p in (layer.wx, layer.wh, layer.b)]
    got, got_g = _fwd_bwd(lambda x: fls.lstm_stack_train(
        lstm.layers, x, masks=masks, keep=keep, compute_dtype=dtype, merged=False), [x], params)
    ref, ref_g = _fwd_bwd(lambda x: fls.lstm_stack_plain(lstm.layers, x, dtype, masks, keep),
                          [x], params)
    torch.testing.assert_close(got, ref, rtol=tol, atol=tol)
    for i, (a, b) in enumerate(zip(got_g, ref_g)):
        assert _rel(a, b) <= tol, (i, _rel(a, b))
    with torch.no_grad():
        before = (fls.lstm_stack_split.launches, fls.lstm_stack_last_all.launches)
        got = fls.lstm_stack_last_all(lstm.layers, x, compute_dtype=dtype, merged=False)
        assert (fls.lstm_stack_split.launches, fls.lstm_stack_last_all.launches) == (
            before[0] + 1, before[1])
        torch.testing.assert_close(got, fls.lstm_stack_plain(lstm.layers, x, dtype),
                                   rtol=tol, atol=tol)


@pytest.mark.cuda
def test_lstm_split_and_tasks_refuse_what_they_do_not_take(dev):
    lstm = init_lstm(torch.Generator().manual_seed(1), 20, 32, 2).to(dev)
    x = torch.zeros((8, 7, 20), device=dev)
    with pytest.raises(ValueError, match="multiples of 8"):
        fused_lstm_stack.lstm_stack_train(lstm.layers, x, merged=False)
    w0, wr, b = _task_weights(dev, 2, 24, 32, 2, 0)
    with pytest.raises(ValueError, match="masks"):
        fused_lstm_stack.lstm_stack_train_tasks(
            torch.zeros((2, 8, 7, 24), device=dev), w0, wr, b,
            masks=torch.ones((1, 7, 8, 32), dtype=torch.int8, device=dev), keep=0.8)
    with pytest.raises(ValueError, match="wrong shape"):
        fused_lstm_stack.lstm_stack_train_tasks(torch.zeros((3, 8, 7, 24), device=dev), w0, wr, b)


@pytest.mark.cuda
def test_lockstep_meta_gradient_kernels_match_plain(dev, monkeypatch):
    """One micro-batch of the lockstep FO meta step (`_VBATCH`; 2 tasks, 2
    inner steps each, dropout on): kernel route (rows 6-7, 16-17 and 9)
    against the plain route (the plain stacks in lockstep, the per-task
    per-leaf clip + SGD), same generator seed."""
    monkeypatch.setattr(fused_lstm_stack, "_VBATCH", True)
    cfg = ModelConfig(hidden_channels=64, gcn_layers=3, lstm_hidden=32, lstm_layers=3,
                      window=7, horizon=3)
    meta = MetaConfig(inner_epochs=1, inner_batches=2)
    regions = [synthetic_region_for_box((10.0 + 3 * i, 12.0 + 3 * i, 20.0, 23.0),
                                        num_timesteps=40, seed=i) for i in range(2)]
    tasks = stack_tasks([b.task for b in build_meta_tasks(regions, cfg, meta, DataConfig())])
    tasks = type(tasks)(*(f.to(dev) for f in tasks))
    model = init_model(torch.Generator().manual_seed(2), cfg, device=dev)
    fn, sgd = fused_lstm_stack.lstm_stack_train_tasks, fused_sgd.clip_sgd_update
    counters = (fn, fused_lstm_stack.lstm_stack_train)
    before = [(c.launches, c.backward_launches) for c in counters]
    before_sgd = (sgd.launches, sgd.batched_launches)
    out = {}
    for route, mc, mt in (
        ("kernel", cfg, meta),
        ("plain", dataclasses.replace(cfg, use_pallas_gcn=False, lstm_kernel="xla"),
         dataclasses.replace(meta, fused_inner_update=False)),
    ):
        gen = torch.Generator(device=dev).manual_seed(7)
        out[route] = task_batch_grad(model, tasks, gen, mc, mt)
    assert [(c.launches, c.backward_launches) for c in counters] == [
        (before[0][0] + 3, before[0][1] + 3), before[1]]
    assert (sgd.launches, sgd.batched_launches) == (before_sgd[0], before_sgd[1] + 2)
    tol = TOL[torch.float32]
    torch.testing.assert_close(out["kernel"][0], out["plain"][0], rtol=tol, atol=tol)
    for name, g in out["kernel"][1].items():
        assert _rel(g, out["plain"][1][name]) <= tol, name


def _card(dev, shape, dtype=torch.float32, seed=0, scale=1.0):
    return torch.from_numpy((np.random.default_rng(seed).normal(size=shape) * scale)
                            .astype(np.float32)).to(dev, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epilogue", ["none", "bias_relu", "gates", "mask"])
@pytest.mark.parametrize("shape", [(200, 40, 72), (1000, 264, 136), (128, 16, 64)])
def test_gemm_nn_matches_plain(dev, dtype, epilogue, shape):
    """The pipelined GEMM core at ragged M, N and K (multiples of 8, not of
    its tiles), every epilogue, one operand pair and two at a row offset,
    float32 and bfloat16 A (bfloat16 compute: A float32 or bfloat16; stores
    float32 and the compute dtype)."""
    m, k, n = shape
    b = _card(dev, (k, n), seed=2, scale=k ** -0.5)
    kw = dict(epilogue=epilogue, bias=_card(dev, (n,), seed=3, scale=0.1),
              mask=(_card(dev, (m, n), seed=4) > -0.84).to(torch.int8), scale=1.25)
    tol = TOL[dtype]
    a_types = (torch.float32,) if dtype == torch.float32 else (torch.float32, torch.bfloat16)
    out_types = (torch.float32,) if dtype == torch.float32 else (torch.float32, dtype)
    before = gemm_nn.launches
    for a_dt in a_types:
        a = _card(dev, (m, k), a_dt, seed=1)
        for out_dt in out_types:
            got = gemm_nn(a, b, compute_dtype=dtype, out_dtype=out_dt, **kw)
            ref = gemm_nn_plain(a, b, compute_dtype=dtype, out_dtype=out_dt, **kw)
            assert got.dtype == out_dt
            torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)
        off = m // 4
        two = dict(a2=_card(dev, (m - off, 24), dtype, seed=5), b2=_card(dev, (24, n), seed=6),
                   row_offset=off)
        got = gemm_nn(a, b, compute_dtype=dtype, **two, **kw)
        torch.testing.assert_close(got, gemm_nn_plain(a, b, compute_dtype=dtype, **two, **kw),
                                   rtol=tol, atol=tol)
    assert gemm_nn.launches == before + len(a_types) * (len(out_types) + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_nn_batched_and_strided(dev, dtype):
    """A batch broadcast over a shared A (row 3's aggregation), a batched A
    with a shared B (its transform), and an out that is a row block of a
    larger buffer (row 3's padded hw)."""
    tol = TOL[dtype]
    a = _card(dev, (100, 64), seed=1)
    b = _card(dev, (5, 64, 48), seed=2, scale=0.125)
    bias = _card(dev, (48,), seed=3)
    got = gemm_nn(a, b, compute_dtype=dtype, epilogue="bias_relu", bias=bias)
    assert got.shape == (5, 100, 48)
    torch.testing.assert_close(got, gemm_nn_plain(a, b, compute_dtype=dtype,
                                                  epilogue="bias_relu", bias=bias),
                               rtol=tol, atol=tol)
    h = _card(dev, (5, 100, 64), seed=4)
    buf = torch.zeros((5, 104, 48), dtype=dtype, device=dev)
    gemm_nn(h, b[0], compute_dtype=dtype, out=buf[:, :100])
    torch.testing.assert_close(buf[:, :100].float(), gemm_nn_plain(
        h, b[0], compute_dtype=dtype, out_dtype=dtype).float(), rtol=tol, atol=tol)
    assert not buf[:, 100:].any()


@pytest.mark.cuda
def test_gemm_nn_refuses_what_it_does_not_take(dev):
    a, b = torch.zeros((16, 24), device=dev), torch.zeros((24, 16), device=dev)
    with pytest.raises(ValueError, match="multiples of 8"):
        gemm_nn(torch.zeros((16, 20), device=dev), torch.zeros((20, 16), device=dev),
                compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="multiples of 8"):
        gemm_nn(a, torch.zeros((24, 12), device=dev), compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="out row and batch strides"):
        gemm_nn(a, b, compute_dtype=torch.float32, out=torch.zeros((16, 20), device=dev)[:, :16])
    with pytest.raises(ValueError, match="A and B row and batch strides"):
        gemm_nn(torch.zeros((16, 28), device=dev)[:, :24], b, compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="disagree on K"):
        gemm_nn(a, b[:16], compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="bias"):
        gemm_nn(a, b, compute_dtype=torch.float32, epilogue="gates")
    with pytest.raises(ValueError, match="mask"):
        gemm_nn(a, b, compute_dtype=torch.float32, epilogue="mask")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gemm_nn(a, b, compute_dtype=torch.float64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,split_rows", [((12288, 256, 256), 256), ((12288, 24, 256), 256),
                                              ((300, 40, 48), 64), ((96, 136, 16), 32)])
def test_gemm_tn_matches_plain(dev, dtype, shape, split_rows):
    """The K-split TN core (row 7's weight gradients; at the reference width
    and at layer 0's 24 rows, and at ragged M, N, K) against its plain
    version split by split, the sums against float64 a^T @ b, and two runs
    bitwise equal."""
    k, m, n = shape
    a = _card(dev, (k, m), dtype, seed=1)
    b = _card(dev, (k, n), dtype, seed=2, scale=k ** -0.5)
    splits = tn_splits(k, split_rows)
    before = gemm_tn.launches
    got = gemm_tn(a, b, torch.empty((splits, m, n), device=dev), compute_dtype=dtype,
                  split_rows=split_rows)
    again = gemm_tn(a, b, torch.empty((splits, m, n), device=dev), compute_dtype=dtype,
                    split_rows=split_rows)
    assert gemm_tn.launches == before + 2
    assert torch.equal(got, again)
    ref = gemm_tn_plain(a, b, torch.empty((splits, m, n), device=dev), compute_dtype=dtype,
                        split_rows=split_rows)
    assert _rel(got, ref) <= 1e-5
    total = torch.empty((1, m * n), device=dev)
    sum_splits(got.view(splits, 1, m * n), total, "test")
    want = a.double().T @ b.double()
    assert _rel(total.view(m, n), want) <= 1e-5


@pytest.mark.cuda
def test_gemm_tn_refuses_what_it_does_not_take(dev):
    a, b = torch.zeros((64, 16), device=dev), torch.zeros((64, 24), device=dev)
    out = torch.empty((1, 16, 24), device=dev)
    with pytest.raises(ValueError, match="M that are multiples of 8"):
        gemm_tn(torch.zeros((64, 12), device=dev), b, torch.empty((1, 12, 24), device=dev),
                compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="split rows"):
        gemm_tn(a, b, torch.empty((2, 16, 24), device=dev), compute_dtype=torch.float32,
                split_rows=40)
    with pytest.raises(ValueError, match="in torch.bfloat16"):
        gemm_tn(a, b, out, compute_dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gemm_tn(a, b, out, compute_dtype=torch.float64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [300, 12288])
def test_gemm_nn_new_epilogues_match_plain(dev, dtype, m):
    """The bias + relu + mask epilogue (row 12) and the relu-grad epilogue
    with its row tiles' column sums (row 7: residual float32 and in the
    compute dtype, with and without a mask), at a ragged M and at row 7's;
    the column sums bitwise equal across two runs."""
    k, n = 256, 256
    tol = TOL[dtype]
    a = _card(dev, (m, k), dtype, seed=1)
    b = _card(dev, (k, n), dtype, seed=2, scale=k ** -0.5)
    mask = (_card(dev, (m, n), seed=4) > -0.84).to(torch.int8)
    bias = _card(dev, (n,), seed=3, scale=0.1)
    kw = dict(epilogue="bias_relu_mask", bias=bias, mask=mask, scale=1.25, out_dtype=dtype)
    torch.testing.assert_close(gemm_nn(a, b, compute_dtype=dtype, **kw).float(),
                               gemm_nn_plain(a, b, compute_dtype=dtype, **kw).float(),
                               rtol=tol, atol=tol)
    tiles = -(-m // 128)
    for res_dt in (torch.float32, dtype):
        residual = _card(dev, (m, n), res_dt, seed=5)
        for msk in (mask, None):
            outs = []
            for product in (gemm_nn, gemm_nn, gemm_nn_plain):
                cs = torch.empty((tiles, n), device=dev)
                out = torch.empty((m, n), dtype=dtype, device=dev)
                product(a, b, compute_dtype=dtype, epilogue="relu_grad", residual=residual,
                        mask=msk, scale=1.25, colsum=cs, out=out)
                outs.append((out, cs))
            (got, cs), (_, cs2), (ref, ref_cs) = outs
            torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)
            assert torch.equal(cs, cs2)
            assert _rel(cs, ref_cs) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gcn_train_backward_runs_on_the_core(dev, dtype):
    """Row 7 at the inner step's shapes (24 slices x 512 nodes, 24 -> 4 x
    256, masks after layers 0-2 at rate 0.2) against the plain schedule from
    the same residuals: 2 NN and 1 TN launch of the core a layer; dW
    bitwise equal across two calls."""
    cfg = ModelConfig()
    enc = init_encoder(torch.Generator().manual_seed(0), cfg).to(dev).requires_grad_(False)
    weights = [layer.w for layer in enc.layers]
    a_hat = _card(dev, (512, 512), seed=1, scale=512 ** -0.5).abs()
    x = _card(dev, (24, 512, cfg.in_channels), seed=2)
    masks = (_card(dev, (3, 24, 512, 256), seed=3) > -0.84).to(torch.int8)
    h_all = fused_gcn_train._forward(x, a_hat, weights, [layer.b for layer in enc.layers], masks,
                                     1.25, dtype)
    g = _card(dev, h_all[-1].shape, dtype, seed=4)
    before = (gemm_nn.launches, gemm_tn.launches)
    got = fused_gcn_train._backward(g, x, a_hat, weights, masks, h_all, 1.25, dtype)
    assert (gemm_nn.launches, gemm_tn.launches) == (before[0] + 8, before[1] + 4)
    again = fused_gcn_train._backward(g, x, a_hat, weights, masks, h_all, 1.25, dtype)
    ref = fused_gcn_train._backward(g, x, a_hat, weights, masks, h_all, 1.25, dtype,
                                    fused_gcn_train.PLAIN_PIECES)
    assert torch.equal(got[0], again[0])
    assert _rel(got[0], ref[0]) <= TOL[dtype]
    for got_l, again_l, ref_l in zip(got[1] + got[2], again[1] + again[2], ref[1] + ref[2]):
        assert torch.equal(got_l, again_l)
        assert _rel(got_l, ref_l) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nl", [512, 256, 128])
def test_gcn_shard_forward_runs_on_the_core(dev, dtype, nl):
    """Row 12 at full width (hw_full [512, 24, 256], a next layer, a mask)
    against its plain version: two NN launches of the core."""
    a = _shard_inputs(dev, dtype, nl, True, True, n=512, w=24, hid=256, hid_next=256)
    before = gemm_nn.launches
    with torch.no_grad():
        got = fused_gcn_shard.gcn_shard_layer(*a.values(), 0.8, dtype)
    assert gemm_nn.launches == before + 2
    ref = fused_gcn_shard.shard_layer_plain(*a.values(), 0.8, dtype)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.float(), r.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layers,dropout", [(4, 0.2), (4, 0.0), (1, 0.0)])
def test_lstm_split_backward_schedule_at_full_width(dev, dtype, layers, dropout):
    """Row 15 at the inner step's shapes (24 steps, 512 rows, input 256,
    hidden 128) against `split_backward_plain` from the same residuals:
    two NN and two TN launches of the GEMM core a layer, one row-15 launch;
    two calls bitwise equal."""
    fls = fused_lstm_stack
    lstm = init_lstm(torch.Generator().manual_seed(1), 256, 128, layers).to(dev)
    w = [t.detach() for t in fls._split_weights(lstm.layers)]
    x = _card(dev, (24, 512, 256), seed=11)
    masks = None
    if dropout:
        masks = draw_mask(torch.Generator(device=dev).manual_seed(4),
                          (layers - 1, 24, 512, 128), dropout, dev)
    keep = 1.0 - dropout
    g = _card(dev, (512, 128), seed=12)
    with torch.no_grad():
        res = fls.split_forward_plain(x, *w, masks, keep, dtype)[1:]
        split = fls.lstm_stack_split
        before = (gemm_nn.launches, gemm_tn.launches, split.backward_launches,
                  split.backward_gemm_tn_launches)
        got = fls.split_backward(g, x, *res, *w, masks, keep, dtype)
        assert (gemm_nn.launches, gemm_tn.launches, split.backward_launches,
                split.backward_gemm_tn_launches) == (
            before[0] + 2 * layers, before[1] + 2 * layers, before[2] + 1,
            before[3] + 2 * layers)
        again = fls.split_backward(g, x, *res, *w, masks, keep, dtype)
        ref = fls.split_backward_plain(g, x, *res, *w, masks, keep, dtype)
    for i, (a, a2, b) in enumerate(zip(got, again, ref)):
        assert a.shape == b.shape, i
        assert torch.equal(a, a2), i
        if b.numel():
            assert _rel(a, b) <= TOL[dtype], (i, _rel(a, b))


@pytest.mark.cuda
def test_unmerged_gates_training_runs_the_gemm_core(dev, monkeypatch):
    """`_MERGED_GATES=False`: a train step of the hybrid runs rows 14-15 and
    the GEMM core three times an LSTM layer (row 14's input product, row
    15's gates and input gradient) beside the GCN stack's twice a layer
    each way (rows 6 and 7), its TN products twice an LSTM layer (row 15's
    weight gradients) and once a GCN layer (row 7's), never rows 4-5, and
    its gradients match the plain route's."""
    monkeypatch.setattr(fused_lstm_stack, "_MERGED_GATES", False)
    cfg = dataclasses.replace(CFG, lstm_dropout=0.0, gcn_dropout=0.0)
    model = init_model(torch.Generator().manual_seed(3), cfg, device=dev)
    a_hat = _a_hat(dev)
    x = torch.from_numpy(
        np.random.default_rng(4).normal(size=(7, 128, 16)).astype(np.float32)).to(dev)
    fls = fused_lstm_stack
    def counts():
        return (gemm_nn.launches, gemm_tn.launches,
                fls.lstm_stack_split.backward_launches, fls.lstm_stack_train.backward_launches)

    before = counts()
    params = list(model.parameters())
    got = torch.autograd.grad(apply_model(model, a_hat, x, 3, cfg, train=True).sum(), params)
    assert counts() == (before[0] + 3 * cfg.lstm_layers + 4 * cfg.gcn_layers,
                        before[1] + 2 * cfg.lstm_layers + cfg.gcn_layers,
                        before[2] + 1, before[3])
    plain = dataclasses.replace(cfg, use_pallas_gcn=False, lstm_kernel="xla")
    ref = torch.autograd.grad(apply_model(model, a_hat, x, 3, plain, train=True).sum(), params)
    for (name, _), a, b in zip(model.named_parameters(), got, ref):
        assert _rel(a, b) <= 1e-5, (name, _rel(a, b))


# The backward recurrence of rows 5, 15 and 19 (csrc/lstm_scan_bwd.cuh):
# Wh^T resident in a cluster's shared memory, at the widths that take each
# cluster size, and row 5 on its layer-by-layer schedule at full width.
CLUSTER = {(torch.float32, 64): 1, (torch.float32, 128): 2, (torch.float32, 256): 8,
           (torch.bfloat16, 64): 1, (torch.bfloat16, 128): 1, (torch.bfloat16, 256): 4,
           # Hopper's non-portable 16-block clusters, where 8 blocks do not hold Wh
           (torch.float32, 320): 16, (torch.float32, 384): 16, (torch.bfloat16, 448): 16,
           (torch.bfloat16, 512): 16}


def _recurrence_inputs(dev, t_len, rows, hidden, seed):
    draw = np.random.default_rng(seed)
    pre = draw.normal(size=(t_len, rows, 4, hidden))
    act = np.concatenate([1 / (1 + np.exp(-pre[:, :, :2])), np.tanh(pre[:, :, 2:3]),
                          1 / (1 + np.exp(-pre[:, :, 3:]))], axis=2)
    gates = torch.from_numpy(act.reshape(t_len, rows, 4 * hidden).astype(np.float32)).to(dev)
    c = _card(dev, (t_len, rows, hidden), seed=seed + 1)
    g = _card(dev, (t_len, rows, hidden), seed=seed + 2)
    wh = _card(dev, (hidden, 4 * hidden), seed=seed + 3, scale=hidden ** -0.5)
    return g, gates, c, wh


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [64, 128, 256])
def test_backward_recurrence_cluster_sizes_match_plain(dev, dtype, hidden):
    """The recurrence through both C entries (c_all in the compute dtype,
    with dh / dc; c_all float32) against `scan_backward_plain`, at 48 rows:
    clusters of 1, 2, 4 and 8 blocks."""
    fls = fused_lstm_stack
    g, gates, c, wh = _recurrence_inputs(dev, 7, 48, hidden, hidden)
    cs, hcp, rb, _ = fls.recurrence_plan(hidden, 48, dtype.itemsize, fls._sms(dev))
    assert cs == CLUSTER[(dtype, hidden)]
    lib = cuda_build.load()
    assert lib.wf_lstm_stack_recurrence_clusters(cuda_build.dtype_code(dtype), cs, hcp, rb,
                                                 hidden) > 0
    ref, ref_dh, ref_dc = lstm_scan.scan_backward_plain(g, gates, c.to(dtype), wh, dtype,
                                                        carries=True)
    out, dh, dc = torch.empty_like(gates), torch.empty_like(g), torch.empty_like(g)
    before = fls._recurrence_card.launches
    fls._recurrence_card(g, gates, c.to(dtype), wh, dtype, out, dh, dc)
    assert fls._recurrence_card.launches == before + 1
    for a, b in ((out, ref), (dh, ref_dh), (dc, ref_dc)):
        assert _rel(a, b) <= TOL[dtype], _rel(a, b)
    ref19 = lstm_scan.scan_backward_plain(g, gates, c, wh, dtype)
    out19 = fls.launch_recurrence(lib.wf_lstm_scan_bwd, "row 19", g, gates, c, wh, dtype,
                                  torch.empty_like(gates))
    assert _rel(out19, ref19) <= TOL[dtype], _rel(out19, ref19)


@pytest.mark.cuda
def test_backward_recurrence_refuses_a_plan_it_does_not_take(dev):
    """A plan whose weight columns do not hold a block's units, or whose
    tiles overflow shared memory, is refused: nothing launches."""
    g, gates, c, wh = _recurrence_inputs(dev, 3, 8, 128, 1)
    out = torch.empty_like(gates)
    lib = cuda_build.load()
    for plan in ((1, 64, 2), (2, 64, 3), (1, 128, 16)):  # 128 units; rb 3; 256 KB of f32
        err = lib.wf_lstm_stack_recurrence(fused_lstm_stack._SCAN_LAUNCH.pack(
            0, *plan, 1, g.data_ptr(), 0, gates.data_ptr(), 0, c.data_ptr(), 0, wh.data_ptr(), 0,
            out.data_ptr(), 0, 0, 0, 0, 0, 0, 0, 3, 8, 128, cuda_build.stream_ptr(dev), -1))
        with pytest.raises(RuntimeError, match="invalid argument"):
            cuda_build.check(err, f"plan {plan}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layers,dropout", [(4, 0.2), (4, 0.0), (1, 0.0)])
def test_merged_backward_schedule_at_full_width(dev, dtype, layers, dropout):
    """Row 5 with its second-order carries at the inner step's shapes (24
    steps, 512 rows, input 256, hidden 128) against `hvp_bwd_plain` from the
    same residuals: all six outputs; a recurrence, a gemm_nn and two gemm_tn
    launches a layer; two calls bitwise equal. Without
    the carries, the same gradients to the bit and no dgates, dh or dc."""
    fh, train = fused_lstm_hvp, fused_lstm_stack.lstm_stack_train
    lstm = init_lstm(torch.Generator().manual_seed(1), 256, 128, layers).to(dev)
    wcat = [torch.cat([layer.wx, layer.wh]).detach() for layer in lstm.layers]
    b2d = torch.stack([layer.b for layer in lstm.layers]).detach()
    x = _card(dev, (24, 512, 256), seed=11)
    masks = None
    if dropout:
        masks = draw_mask(torch.Generator(device=dev).manual_seed(4),
                          (layers - 1, 24, 512, 128), dropout, dev)
    keep = 1.0 - dropout
    g = _card(dev, (512, 128), seed=12)
    with torch.no_grad():
        _, h_all, c_all, gates = fh.stack_fwd(x, wcat, b2d, masks, keep, dtype)
        def counts():
            return (train.backward_launches, train.backward_recurrence_launches,
                    train.backward_gemm_nn_launches, train.backward_gemm_tn_launches,
                    gemm_nn.launches, gemm_tn.launches)

        before = counts()
        got = fh.stack_bwd(g, x, h_all, c_all, gates, wcat, masks, keep, dtype)
        assert counts() == (before[0] + 1, before[1] + layers, before[2] + layers,
                            before[3] + 2 * layers, before[4] + layers, before[5] + 2 * layers)
        again = fh.stack_bwd(g, x, h_all, c_all, gates, wcat, masks, keep, dtype)
        first = fused_lstm_stack.train_backward(g, x, h_all, c_all, gates, wcat, masks, keep,
                                                dtype)
        ref = fh.hvp_bwd_plain(g, x, h_all, c_all, gates, wcat, masks, keep, dtype)
    assert first[3:] == (None, None, None)
    for i, (a, a2, b) in enumerate(zip(got, again, ref)):
        for al, al2, bl in zip(a, a2, b) if i == 1 else [(a, a2, b)]:
            assert al.shape == bl.shape, i
            assert torch.equal(al, al2), i
            assert _rel(al, bl) <= TOL[dtype], (i, _rel(al, bl))
    for i, (a, f) in enumerate(zip(got[:3], first[:3])):
        for al, fl in zip(a, f) if i == 1 else [(a, f)]:
            assert torch.equal(al, fl), i


# Row 17 on row 5's schedule with a task axis (the recurrence's grid z, the
# core's batched products), and row 6 on the core.


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nv,rows,hidden", [(2, 512, 128), (3, 48, 64), (2, 48, 256)])
def test_backward_recurrence_task_axis_equals_one_task_launches(dev, dtype, nv, rows, hidden):
    """V tasks in one launch (strided views, as row 17's schedule passes
    them) give the bits of V one-task launches with the same plan; the bias
    partials' sum matches the column sums of dgates."""
    fls = fused_lstm_stack
    ins = [_recurrence_inputs(dev, 7, rows, hidden, 20 + v) for v in range(nv)]
    # Task-strided layouts: every task's [T, R, *] slice of a [V, 2, T, R, *] array.
    g, gates, c = (torch.stack([torch.stack([i[k], i[k]]) for i in ins])[:, 1]
                   for k in (0, 1, 2))
    c = c.to(dtype)
    wh = torch.stack([i[3] for i in ins])
    out = torch.empty_like(gates)
    db = torch.empty((nv, 3, 4 * hidden), device=dev)[:, 1]
    before = fls._recurrence_card.launches
    fls._recurrence_card(g, gates, c, wh, dtype, out, db=db)
    assert fls._recurrence_card.launches == before + 1
    plan = fls.recurrence_plan(hidden, rows, dtype.itemsize, fls._sms(dev), nv)
    for v in range(nv):
        one = torch.empty_like(gates[v])
        fls._recurrence_card(g[v], gates[v], c[v], wh[v], dtype, one)
        if fls.recurrence_plan(hidden, rows, dtype.itemsize, fls._sms(dev)) == plan:
            assert torch.equal(out[v], one), v
        assert _rel(out[v], one) <= TOL[dtype]
        assert _rel(db[v], out[v].double().sum(dim=(0, 1))) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,a_off", [((12288, 128, 512), 512), ((12288, 24, 512), 0),
                                         ((300, 40, 48), 7)])
def test_gemm_tn_task_axis_matches_plain_and_one_task_launches(dev, dtype, shape, a_off):
    """The batched TN core (row 17's weight gradients: V = 2 task-strided
    operands, partials written into a [S, V, M, N] buffer viewed task first;
    an A row offset) against its plain version, against V one-task launches
    (equal bits) and, summed, against float64."""
    k, m, n = shape
    nv = 2
    split_rows = fused_lstm_stack.wave_split_rows(k, m, n, nv, fused_lstm_stack._sms(dev))
    splits = tn_splits(k, split_rows)
    a = _card(dev, (nv, 2, k - a_off, m), dtype, seed=1)[:, 0]
    b = _card(dev, (nv, k, n), dtype, seed=2, scale=k ** -0.5)
    part = torch.empty((splits, nv, m, n), device=dev)
    before = gemm_tn.launches
    gemm_tn(a, b, part.transpose(0, 1), compute_dtype=dtype, split_rows=split_rows,
            a_row_offset=a_off)
    assert gemm_tn.launches == before + 1
    ref = gemm_tn_plain(a, b, torch.empty((nv, splits, m, n), device=dev), compute_dtype=dtype,
                        split_rows=split_rows, a_row_offset=a_off)
    assert _rel(part.transpose(0, 1), ref) <= 1e-5
    for v in range(nv):
        one = gemm_tn(a[v], b[v], torch.empty((splits, m, n), device=dev), compute_dtype=dtype,
                      split_rows=split_rows, a_row_offset=a_off)
        assert torch.equal(part[:, v], one), v
    total = torch.empty((nv, m * n), device=dev)
    sum_splits(part.view(splits, nv, m * n), total, "test")
    want = torch.cat([torch.zeros((nv, a_off, m), device=dev, dtype=torch.float64),
                      a.double()], dim=1).transpose(1, 2) @ b.double()
    assert _rel(total.view(nv, m, n), want) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nv,layers,dropout", [(2, 4, 0.2), (2, 1, 0.0), (3, 2, 0.0)])
def test_lstm_tasks_backward_schedule_at_full_width(dev, dtype, nv, layers, dropout):
    """Row 17 at the inner step's shapes (24 steps, 512 rows, input 256,
    hidden 128, V tasks) against its schedule on the plain pieces from the
    same residuals: a recurrence, a gemm_nn and two gemm_tn launches a
    layer; two calls bitwise equal."""
    fls = fused_lstm_stack
    w0, wr, b2d = _task_weights(dev, nv, 256, 128, layers, 30)
    x = _card(dev, (nv, 24, 512, 256), seed=13)
    masks = None
    if dropout:
        masks = draw_mask(torch.Generator(device=dev).manual_seed(4),
                          (nv, layers - 1, 24, 512, 128), dropout, dev)
    keep = 1.0 - dropout
    g = _card(dev, (nv, 512, 128), seed=14)
    tasks = fls.lstm_stack_train_tasks
    with torch.no_grad():
        _, h_all, c_all, gates = fls.tasks_forward(x, masks, keep, dtype, w0, wr, b2d)
        before = (tasks.backward_launches, tasks.backward_recurrence_launches,
                  tasks.backward_gemm_nn_launches, tasks.backward_gemm_tn_launches)
        got = fls.tasks_backward(g, x, h_all, c_all, gates, w0, wr, masks, keep, dtype)
        assert (tasks.backward_launches, tasks.backward_recurrence_launches,
                tasks.backward_gemm_nn_launches, tasks.backward_gemm_tn_launches) == (
            before[0] + 1, before[1] + layers, before[2] + layers, before[3] + 2 * layers)
        again = fls.tasks_backward(g, x, h_all, c_all, gates, w0, wr, masks, keep, dtype)
        ref = fls.tasks_backward_schedule(g, x, h_all, c_all, gates, w0, wr, masks, keep, dtype,
                                          fls.PLAIN_PIECES)
    for i, (a, a2, r) in enumerate(zip(got, again, ref)):
        assert a.shape == r.shape and a.dtype == torch.float32, i
        assert torch.equal(a, a2), i
        if r.numel():
            assert _rel(a, r) <= TOL[dtype], (i, _rel(a, r))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nodes,masked_layers", [(512, 3), (117, 4), (128, 0)])
def test_gcn_train_forward_runs_on_the_core(dev, dtype, nodes, masked_layers):
    """Row 6 at the inner step's widths (24 slices, 24 -> 4 x 256; masks
    after the first `masked_layers` layers) against `forward_schedule` on
    gemm_nn_plain: every layer's stored activation, 2 gemm_nn launches a
    layer; 117 nodes take the zero padding."""
    cfg = ModelConfig()
    enc = init_encoder(torch.Generator().manual_seed(0), cfg).to(dev).requires_grad_(False)
    weights = [layer.w for layer in enc.layers]
    biases = [layer.b for layer in enc.layers]
    a_hat = _card(dev, (nodes, nodes), seed=1).abs()
    a_hat = a_hat / a_hat.sum(dim=1, keepdim=True)  # row-normalised, as the graph's
    x = _card(dev, (24, nodes, cfg.in_channels), seed=2)
    masks = ((_card(dev, (masked_layers, 24, nodes, 256), seed=3) > -0.84).to(torch.int8)
             if masked_layers else None)
    before = (gemm_nn.launches, fused_gcn_train.gcn_stack_train.gemm_nn_launches)
    got = fused_gcn_train._forward(x, a_hat, weights, biases, masks, 1.25, dtype)
    assert (gemm_nn.launches, fused_gcn_train.gcn_stack_train.gemm_nn_launches) == (
        before[0] + 2 * len(weights), before[1] + 2 * len(weights))
    ref = fused_gcn_train.forward_schedule(x, a_hat, weights, biases, masks, 1.25, dtype,
                                           product=gemm_nn_plain)
    for l, (a, r) in enumerate(zip(got, ref)):
        assert a.dtype == dtype and a.shape == (24, nodes, 256), l
        torch.testing.assert_close(a.float(), r.float(), rtol=TOL[dtype], atol=TOL[dtype])


# Row 4 layer by layer (the input products on the core, the forward
# recurrence of csrc/lstm_scan_fwd.cuh, all enqueued by one C call) and row
# 13 on the core and row 7's pieces.


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,layers,dropout", [(512, 4, 0.2), (512, 4, 0.0), (512, 1, 0.0),
                                                 (1024, 4, 0.2)])
def test_lstm_train_forward_at_full_width(dev, dtype, rows, layers, dropout):
    """Row 4 at the inner step's shapes (24 steps, input 256, hidden 128;
    1024 rows: the adaptation step) against its schedule on the plain pieces
    from the same inputs: h_last, h_all, c_all and the gates; L gemm_nn and
    L recurrence launches from one call; the same schedule a launch at a
    time (`FWD_CARD_PIECES`) and a second call give the same bits."""
    fls = fused_lstm_stack
    train = fls.lstm_stack_train
    lstm = init_lstm(torch.Generator().manual_seed(1), 256, 128, layers).to(dev)
    wcat = [torch.cat([layer.wx, layer.wh]).detach() for layer in lstm.layers]
    b2d = torch.stack([layer.b for layer in lstm.layers]).detach()
    x = _card(dev, (rows, 24, 256), seed=11).transpose(0, 1)  # the model's [T, B, C] view
    masks = None
    if dropout:
        masks = draw_mask(torch.Generator(device=dev).manual_seed(4),
                          (layers - 1, 24, rows, 128), dropout, dev)
    keep = 1.0 - dropout
    with torch.no_grad():
        before = (train.launches, train.forward_gemm_nn_launches,
                  train.forward_recurrence_launches, gemm_nn.launches)
        got = fls.train_forward(x, masks, keep, dtype, b2d, wcat)
        assert (train.launches, train.forward_gemm_nn_launches,
                train.forward_recurrence_launches, gemm_nn.launches) == (
            before[0] + 1, before[1] + layers, before[2] + layers, before[3] + layers)
        again = fls.train_forward(x, masks, keep, dtype, b2d, wcat)
        pieces = fls.forward_schedule(x, masks, keep, dtype, b2d, wcat, fls.FWD_CARD_PIECES)
        ref = fls.forward_schedule(x, masks, keep, dtype, b2d, wcat, fls.FWD_PLAIN_PIECES)
    for name, g, a, p, r in zip(("h_last", "h_all", "c_all", "gates"), got, again, pieces, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        assert torch.equal(g, a) and torch.equal(g, p), name
        torch.testing.assert_close(g.float(), r.float(), rtol=TOL[dtype], atol=TOL[dtype],
                                   msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [64, 128, 256])
def test_forward_recurrence_cluster_sizes_match_plain(dev, dtype, hidden):
    """The forward recurrence alone against its plain version at 48 rows, 7
    steps, with a mask (the next layer's input) and the last h: clusters of
    1, 2, 4 and 8 blocks."""
    fls = fused_lstm_stack
    cs, hcp, rb, _ = fls.forward_plan(hidden, 48, dtype.itemsize, fls._sms(dev))
    assert cs == CLUSTER[(dtype, hidden)]
    assert cuda_build.load().wf_lstm_stack_forward_clusters(
        cuda_build.dtype_code(dtype), cs, hcp, rb, hidden) > 0
    xp = _card(dev, (7, 48, 4 * hidden), seed=hidden)
    wh = _card(dev, (hidden, 4 * hidden), seed=hidden + 1, scale=hidden ** -0.5)
    bias = _card(dev, (4 * hidden,), seed=hidden + 2, scale=0.1)
    mask = (_card(dev, (7, 48, hidden), seed=hidden + 3) > -0.84).to(torch.int8)
    outs = {}
    for name, piece in (("kernel", fls._forward_recurrence_card),
                        ("plain", fls._forward_recurrence_plain)):
        gates = xp.clone()
        res = [torch.empty((7, 48, hidden), dtype=dtype, device=dev) for _ in range(3)]
        h_last = torch.empty((48, hidden), device=dev)
        piece(gates, wh, bias, dtype, res[0], res[1], mask=mask, inv_keep=1.25, next_in=res[2],
              h_last=h_last)
        outs[name] = (gates, *res, h_last)
    for i, (a, b) in enumerate(zip(outs["kernel"], outs["plain"])):
        torch.testing.assert_close(a.float(), b.float(), rtol=TOL[dtype], atol=TOL[dtype],
                                   msg=str(i))


@pytest.mark.cuda
def test_forward_recurrence_refuses_a_plan_it_does_not_take(dev):
    """A plan whose weight columns do not hold a block's units, a row tile
    it is not built for, or tiles beyond shared memory: nothing launches."""
    gates = _card(dev, (3, 8, 512))
    wh = _card(dev, (128, 512))
    bias = _card(dev, (512,))
    h = torch.empty((3, 8, 128), device=dev)
    lib = cuda_build.load()
    for plan in ((1, 64, 2), (2, 64, 3), (1, 128, 16)):  # 128 units; rb 3; 256 KB of f32
        err = lib.wf_lstm_stack_forward_recurrence(fused_lstm_stack._SCAN_FWD.pack(
            0, *plan, gates.data_ptr(), gates.data_ptr(), wh.data_ptr(), 512, bias.data_ptr(),
            h.data_ptr(), h.data_ptr(), 0, 0, 1.0, 0, 0, 3, 8, 128, cuda_build.stream_ptr(dev),
            1, *[0] * 8, -1))
        with pytest.raises(RuntimeError, match="invalid argument"):
            cuda_build.check(err, f"plan {plan}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nl", [512, 256, 40])
@pytest.mark.parametrize("cts", ["g2", "g1", "both"])
@pytest.mark.parametrize("has_mask", [True, False])
def test_gcn_shard_backward_runs_on_the_core(dev, dtype, nl, cts, has_mask):
    """Row 13 at full width (hw_full [512, 24, 256] and hid_next 256; NL 40 of
    120 nodes pads the A^T product's K) against its plain statement, each
    cotangent alone and both: the core's NN and TN launches (g2: 2 NN, 1 TN;
    g1: 1 NN; both: 2 NN, 1 TN); two calls bitwise equal."""
    n = 120 if nl == 40 else 512
    a = _shard_inputs(dev, dtype, nl, True, has_mask, n=n, w=24, hid=256, hid_next=256)
    with torch.no_grad():
        h_post, _ = fused_gcn_shard.shard_layer_plain(*a.values(), 0.8, dtype)
    g1 = None if cts == "g2" else _card(dev, h_post.shape, dtype, seed=5)
    g2 = None if cts == "g1" else _card(dev, (nl, 24, 256), dtype, seed=6)
    args = (g1, g2, h_post, a["a_rows"], a["w_next"], a["mask"])
    before = (gemm_nn.launches, gemm_tn.launches)
    got = fused_gcn_shard.backward_schedule(*args, 1.25, dtype, dtype,
                                            fused_gcn_train.CARD_PIECES)
    assert (gemm_nn.launches - before[0], gemm_tn.launches - before[1]) == {
        "g2": (2, 1), "g1": (1, 0), "both": (2, 1)}[cts]
    again = fused_gcn_shard.backward_schedule(*args, 1.25, dtype, dtype,
                                              fused_gcn_train.CARD_PIECES)
    ref = fused_gcn_shard.shard_bwd_plain(*args, 0.8, dtype, dtype)
    for name, g, r, b in zip(("d_hw_full", "db", "dw_next"), got, ref, again):
        assert torch.equal(g, b), name
        if cts == "g1" and name == "dw_next":
            assert not g.any()
            continue
        assert g.shape == r.shape and _rel(g, r) <= TOL[dtype], (name, _rel(g, r))


# Row 14 on row 4's layer-by-layer forward, and row 11 layer by layer on the
# tangent recurrence of csrc/lstm_scan_tan.cu and the GEMM core.


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layers,dropout", [(4, 0.2), (4, 0.0), (1, 0.0)])
def test_lstm_split_forward_at_full_width(dev, dtype, layers, dropout):
    """Row 14 at the inner step's shapes (x [512, 24, 256] as the model's
    [T, B, C] view, hidden 128) against its schedule on the plain pieces and
    `split_forward_plain`, with residuals and without (the eval forward: the
    same last h to the bit); L gemm_nn and L recurrence launches from one
    call; a second call gives the same bits."""
    fls = fused_lstm_stack
    split = fls.lstm_stack_split
    lstm = init_lstm(torch.Generator().manual_seed(2), 256, 128, layers).to(dev)
    w = [t.detach() for t in fls._split_weights(lstm.layers)]
    x = _card(dev, (512, 24, 256), seed=13).transpose(0, 1)
    masks = None
    if dropout:
        masks = draw_mask(torch.Generator(device=dev).manual_seed(5),
                          (layers - 1, 24, 512, 128), dropout, dev)
    keep = 1.0 - dropout
    with torch.no_grad():
        before = (split.launches, split.forward_gemm_nn_launches,
                  split.forward_recurrence_launches, gemm_nn.launches)
        got = fls.split_forward(x, *w, masks, keep, dtype)
        assert (split.launches, split.forward_gemm_nn_launches,
                split.forward_recurrence_launches, gemm_nn.launches) == (
            before[0] + 1, before[1] + layers, before[2] + layers, before[3] + layers)
        again = fls.split_forward(x, *w, masks, keep, dtype)
        last = fls.split_forward(x, *w, masks, keep, dtype, residuals=False)
        ref = fls.split_forward_schedule(x, *w, masks, keep, dtype, fls.FWD_PLAIN_PIECES)
        plain = fls.split_forward_plain(x, *w, masks, keep, dtype)
    assert last[1] is None and torch.equal(last[0], got[0])
    for name, g, a, r, p in zip(("h_last", "h_all", "c_all"), got, again, ref, plain):
        assert g.dtype == r.dtype == p.dtype and g.shape == r.shape, name
        assert torch.equal(g, a), name
        for want in (r, p):
            torch.testing.assert_close(g.float(), want.float(), rtol=TOL[dtype],
                                       atol=TOL[dtype], msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [64, 128, 256])
def test_tangent_recurrence_cluster_sizes_match_plain(dev, dtype, hidden):
    """Row 11's tangent recurrence alone against its plain version at 48
    rows, 7 steps: clusters of 1, 2, 4 and 8 blocks; tdgates and the bias
    tangent."""
    fh = fused_lstm_hvp
    cs, hcp, rb = fh.tangent_plan(hidden, 48, dtype.itemsize, fused_lstm_stack._sms(dev))
    assert cs == CLUSTER[(dtype, hidden)]
    assert cuda_build.load().wf_lstm_tangent_recurrence_clusters(
        cuda_build.dtype_code(dtype), cs, hcp, rb, hidden) > 0
    g, gates, c, wh = _recurrence_inputs(dev, 7, 48, hidden, hidden)
    p, dh, dc = (_card(dev, shape, seed=hidden + i) for i, shape in enumerate(
        ((6, 48, hidden), (7, 48, hidden), (7, 48, hidden)), 10))
    tgates = _card(dev, (7, 48, 4 * hidden), seed=hidden + 20, scale=0.3)
    tc = _card(dev, (7, 48, hidden), seed=hidden + 21)
    outs = {}
    for name, piece in (("kernel", fh._tangent_recurrence_card),
                        ("plain", fh._tangent_recurrence_plain)):
        out, db = torch.empty_like(gates), torch.empty(4 * hidden, device=dev)
        piece(g, p, gates, tgates, c.to(dtype), tc.to(dtype), dh, dc, wh, dtype, out, db)
        outs[name] = (out, db)
    for a, b in zip(outs["kernel"], outs["plain"]):
        assert _rel(a, b) <= TOL[dtype], _rel(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layers,dropout", [(4, 0.2), (4, 0.0), (1, 0.0)])
def test_hvp_backward_schedule_at_full_width(dev, dtype, layers, dropout):
    """Row 11 at the inner step's shapes (24 steps, 512 rows, input 256,
    hidden 128) from rows 4, 10 and 5 at the same point, against its
    schedule on the plain pieces and `hvp_bwd_plain` (the tangents at 1e-4
    relative in float32): per layer one tangent recurrence, two gemm_nn and
    four gemm_tn launches; a second call gives the same bits."""
    fh = fused_lstm_hvp
    bwd = fh.hvp_stack_bwd
    a = _r_op_inputs(dev, 24, 512, 256, 128, layers, dropout, seed=layers)
    m, keep = a["masks"], a["keep"]
    with torch.no_grad():
        _, h_all, c_all, gates = fh.stack_fwd(a["x"], a["wcat"], a["b2d"], m, keep, dtype)
        _, th_all, tc_all, tgates = fh.hvp_stack_fwd(
            a["x"], a["tx"], a["wcat"], a["twcat"], a["b2d"], a["tb2d"], m, keep, dtype,
            res=(h_all, c_all, gates))
        res = fh.stack_bwd(a["g"], a["x"], h_all, c_all, gates, a["wcat"], m, keep, dtype)[3:]
        args = (a["g"], a["tg"], a["x"], a["tx"], h_all, th_all, c_all, tc_all, gates, tgates,
                a["wcat"], a["twcat"], m, keep, dtype)
        before = (bwd.launches, bwd.recurrence_launches, bwd.gemm_nn_launches,
                  bwd.gemm_tn_launches)
        got = fh.hvp_stack_bwd(*args, res=res)
        assert (bwd.launches, bwd.recurrence_launches, bwd.gemm_nn_launches,
                bwd.gemm_tn_launches) == (
            before[0] + 1, before[1] + layers, before[2] + 2 * layers, before[3] + 4 * layers)
        again = fh.hvp_stack_bwd(*args, res=res)
        ref = fh.hvp_backward_schedule(a["tg"], *args[2:], res, fh.PLAIN_TANGENT_PIECES)
        plain = fh.hvp_bwd_plain(a["g"], a["x"], h_all, c_all, gates, a["wcat"], m, keep, dtype,
                                 a["tg"], a["tx"], th_all, tc_all, tgates, a["twcat"])[6:]
    tol = 1e-4 if dtype == torch.float32 else TOL[dtype]
    flat = lambda o: [o[0], *o[1], o[2]]  # noqa: E731
    for i, (g, s, r, p) in enumerate(zip(*map(flat, (got, again, ref, plain)))):
        assert g.shape == r.shape == p.shape, i
        assert torch.equal(g, s), i
        assert _rel(g, r) <= tol and _rel(g, p) <= tol, (i, _rel(g, r), _rel(g, p))



# Row 10 layer by layer: per layer one product of two operand pairs on the
# core and the tangent forward recurrence of csrc/lstm_scan_fwd_tan.cu, all
# enqueued by one C call.


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [64, 128, 256])
@pytest.mark.parametrize("below_top", [True, False])
def test_tangent_forward_recurrence_cluster_sizes_match_plain(dev, dtype, hidden, below_top):
    """Row 10's tangent forward recurrence alone against its plain version
    at 48 rows, 7 steps: clusters of 1, 2, 4 and 8 blocks; the gates'
    tangents, th, tc, and below the top layer the next layer's [tin | in |
    h a step back] with a mask, at the top the last th."""
    fh = fused_lstm_hvp
    cs, hcp, rb = fh.tangent_forward_plan(hidden, 48, dtype.itemsize, fused_lstm_stack._sms(dev))
    assert cs == CLUSTER[(dtype, hidden)] and rb <= 8
    assert cuda_build.load().wf_lstm_tangent_forward_clusters(
        cuda_build.dtype_code(dtype), cs, hcp, rb, hidden) > 0
    _, gates, c, wh = _recurrence_inputs(dev, 7, 48, hidden, hidden)
    ds = _card(dev, (7, 48, 4 * hidden), seed=hidden + 30, scale=0.3)
    h, h_next = (_card(dev, (7, 48, hidden), seed=hidden + i).to(dtype) for i in (31, 34))
    tb = _card(dev, (4 * hidden,), seed=hidden + 32, scale=0.1)
    mask = (_card(dev, (7, 48, hidden), seed=hidden + 33) > -0.84).to(torch.int8)
    outs = {}
    for name, piece in (("kernel", fh._tangent_forward_recurrence_card),
                        ("plain", fh._tangent_forward_recurrence_plain)):
        tgates = ds.clone()
        th, tc = (torch.empty((7, 48, hidden), dtype=dtype, device=dev) for _ in range(2))
        extra = (dict(mask=mask, inv_keep=1.25,
                      next_in=torch.empty((7, 48, 3 * hidden), dtype=dtype, device=dev))
                 if below_top else dict(th_last=torch.empty((48, hidden), device=dev)))
        piece(tgates, gates, c.to(dtype), h, h_next, wh, tb, dtype, th, tc, **extra)
        outs[name] = (tgates, th, tc, extra["next_in" if below_top else "th_last"])
    for i, (a, b) in enumerate(zip(outs["kernel"], outs["plain"])):
        assert _rel(a, b) <= TOL[dtype], (i, _rel(a, b))


@pytest.mark.cuda
def test_tangent_forward_recurrence_refuses_a_plan_it_does_not_take(dev):
    """A plan whose weight columns do not hold a block's units, a row tile
    it is not built for (16: its tiles stop at 8), tiles beyond shared
    memory, a mask without the next input, the next input without the next
    layer's h: nothing launches."""
    t = _card(dev, (3, 8, 512))
    wh = _card(dev, (128, 512))
    h = torch.empty((3, 8, 128), device=dev)
    lib = cuda_build.load()
    mask = torch.ones((3, 8, 128), dtype=torch.int8, device=dev)
    nx = torch.empty((3, 8, 384), device=dev)
    for plan, m, n in (((1, 64, 2), None, None), ((2, 64, 16), None, None),
                       ((1, 128, 8), None, None), ((2, 64, 8), mask, None),
                       ((2, 64, 8), None, nx)):
        err = lib.wf_lstm_tangent_forward_recurrence(fused_lstm_hvp._SCAN_FWD_TAN.pack(
            0, *plan, t.data_ptr(), t.data_ptr(), h.data_ptr(), h.data_ptr(), 0, wh.data_ptr(),
            512, t.data_ptr(), h.data_ptr(), h.data_ptr(), 0 if m is None else m.data_ptr(), 1.0,
            0 if n is None else n.data_ptr(), 0, 3, 8, 128, cuda_build.stream_ptr(dev)))
        with pytest.raises(RuntimeError, match="invalid argument"):
            cuda_build.check(err, f"plan {plan}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,layers,dropout", [(512, 4, 0.2), (512, 4, 0.0), (512, 1, 0.0),
                                                 (1024, 2, 0.2)])
def test_hvp_forward_schedule_at_full_width(dev, dtype, rows, layers, dropout):
    """Row 10 at the inner step's shapes (24 steps, input 256, hidden 128)
    from row 4 at the same point, against its schedule on the plain pieces
    (the tangents at 1e-4 relative in float32): L gemm_nn and L tangent
    recurrence launches from one call; the same schedule a
    launch at a time (`CARD_HVP_FWD_PIECES`) and a second call give the same
    bits. Weights at 0.3 (gates saturated) and at 0.1 (chip_smoke.py's
    scale, near the model's initial weights); at 0.1 also against the
    stage-by-stage `hvp_fwd_plain`. At 0.3 the 96 chained stages amplify the
    schedule's float32 reordering to ~1e-4 of the stage-by-stage sums, and
    bfloat16's rounded c (the kernel reads row 4's c_all, as JAX's residual
    contract stores it) to ~9e-2 of `hvp_fwd_plain`'s unrounded c."""
    fh = fused_lstm_hvp
    fwd = fh.hvp_stack_fwd
    tol = 1e-4 if dtype == torch.float32 else TOL[dtype]
    for w_scale in (0.3, 0.1):
        a = _r_op_inputs(dev, 24, rows, 256, 128, layers, dropout, seed=layers, w_scale=w_scale)
        m, keep = a["masks"], a["keep"]
        args = (a["x"], a["tx"], a["wcat"], a["twcat"], a["b2d"], a["tb2d"], m, keep, dtype)
        with torch.no_grad():
            res = fh.stack_fwd(a["x"], a["wcat"], a["b2d"], m, keep, dtype)[1:]
            before = (fwd.launches, fwd.recurrence_launches, fwd.gemm_nn_launches,
                      gemm_nn.launches)
            got = fh.hvp_stack_fwd(*args, res=res)
            assert (fwd.launches, fwd.recurrence_launches, fwd.gemm_nn_launches,
                    gemm_nn.launches) == (before[0] + 1, before[1] + layers,
                                          before[2] + layers, before[3] + layers)
            again = fh.hvp_stack_fwd(*args, res=res)
            sched = (a["x"], a["tx"], a["wcat"], a["twcat"], a["tb2d"], m, keep, dtype, res)
            pieces = fh.hvp_forward_schedule(*sched, fh.CARD_HVP_FWD_PIECES)
            ref = fh.hvp_forward_schedule(*sched, fh.PLAIN_HVP_FWD_PIECES)
            plain = (fh.hvp_fwd_plain(a["x"], a["wcat"], a["b2d"], m, keep, dtype, a["tx"],
                                      a["twcat"], a["tb2d"])[4:] if w_scale == 0.1 else ref)
        for name, g, s, p, r, q in zip(("th_last", "th_all", "tc_all", "tgates"), got, again,
                                       pieces, ref, plain):
            assert g.dtype == r.dtype and g.shape == r.shape == q.shape, name
            assert torch.equal(g, s) and torch.equal(g, p), name
            assert _rel(g, r) <= tol and _rel(g, q) <= tol, (w_scale, name, _rel(g, r),
                                                             _rel(g, q))


# Row 16 on row 4's layer-by-layer schedule with a task axis (the forward
# recurrence's grid z, the core's products batched over the tasks), and row
# 19's backward from one C call, its weight gradient on the TN core.


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nv,rows,hidden", [(1, 48, 64), (2, 48, 128), (3, 48, 256),
                                            (2, 512, 128), (3, 512, 128), (2, 1024, 128)])
def test_forward_recurrence_task_axis_matches_plain(dev, dtype, nv, rows, hidden):
    """V tasks' recurrences in one launch (task-strided views, as row 16's
    schedule passes them: one layer of [V, L, T, R, *] arrays) against the
    plain piece, with a mask and the last h, at plans of every cluster size;
    each task bitwise equal to its one-task launch where the plan is the
    same, and one task of the task-axis form bitwise equal to the one-task
    form (row 4's launch)."""
    fls = fused_lstm_stack
    plan = fls.forward_plan(hidden, rows, dtype.itemsize, fls._sms(dev), nv)
    t_len = 7
    xp = _card(dev, (nv, 2, t_len, rows, 4 * hidden), seed=hidden)[:, 1]
    wh = _card(dev, (nv, 2, hidden, 4 * hidden), seed=hidden + 1, scale=hidden ** -0.5)[:, 0]
    bias = _card(dev, (nv, 2, 4 * hidden), seed=hidden + 2, scale=0.1)[:, 1]
    mask = (_card(dev, (nv, 2, t_len, rows, hidden), seed=hidden + 3) > -0.84).to(torch.int8)[:, 0]
    outs = {}
    for name, piece in (("kernel", fls._forward_recurrence_card),
                        ("plain", fls._forward_recurrence_plain)):
        gates = xp.clone()
        res = [torch.empty((nv, 2, t_len, rows, hidden), dtype=dtype, device=dev)[:, 1]
               for _ in range(2)] + [torch.empty((nv, t_len, rows, hidden), dtype=dtype,
                                                 device=dev)]
        h_last = torch.empty((nv, rows, hidden), device=dev)
        before = fls._forward_recurrence_card.launches
        piece(gates, wh, bias, dtype, res[0], res[1], mask=mask, inv_keep=1.25, next_in=res[2],
              h_last=h_last)
        if name == "kernel":
            assert fls._forward_recurrence_card.launches == before + 1
        outs[name] = (gates, *res, h_last)
    for i, (a, b) in enumerate(zip(outs["kernel"], outs["plain"])):
        torch.testing.assert_close(a.float(), b.float(), rtol=TOL[dtype], atol=TOL[dtype],
                                   msg=str(i))
    for v in range(nv):
        gates = xp[v].clone()
        res = [torch.empty((t_len, rows, hidden), dtype=dtype, device=dev) for _ in range(3)]
        h_last = torch.empty((rows, hidden), device=dev)
        fls._forward_recurrence_card(gates, wh[v], bias[v], dtype, res[0], res[1],
                                     mask=mask[v], inv_keep=1.25, next_in=res[2], h_last=h_last)
        if nv == 1 or fls.forward_plan(hidden, rows, dtype.itemsize, fls._sms(dev)) == plan:
            for i, (a, b) in enumerate(zip(outs["kernel"], (gates, *res, h_last))):
                assert torch.equal(a[v], b), (v, i)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nv,rows,layers,dropout", [(2, 512, 4, 0.2), (2, 512, 4, 0.0),
                                                    (3, 512, 2, 0.2), (2, 512, 1, 0.0),
                                                    (2, 1024, 4, 0.2)])
def test_lstm_tasks_forward_at_full_width(dev, dtype, nv, rows, layers, dropout):
    """Row 16 at the inner step's shapes (24 steps, input 256, hidden 128, V
    tasks) against its schedule on the plain pieces from the same inputs:
    h_last, h_all, c_all and the gates; L gemm_nn and L recurrence launches
    from one call; the same schedule a launch at a time
    (`FWD_CARD_PIECES`) and a second call give the same bits; each task's
    h_last against row 4 (`train_forward`) on that task's weights."""
    fls = fused_lstm_stack
    tasks = fls.lstm_stack_train_tasks
    w0, wr, b2d = _task_weights(dev, nv, 256, 128, layers, 50)
    x = _card(dev, (nv, 24, rows, 256), seed=15)
    masks = None
    if dropout:
        masks = draw_mask(torch.Generator(device=dev).manual_seed(4),
                          (nv, layers - 1, 24, rows, 128), dropout, dev)
    keep = 1.0 - dropout
    with torch.no_grad():
        before = (tasks.launches, tasks.forward_gemm_nn_launches,
                  tasks.forward_recurrence_launches, gemm_nn.launches)
        got = fls.tasks_forward(x, masks, keep, dtype, w0, wr, b2d)
        assert (tasks.launches, tasks.forward_gemm_nn_launches, tasks.forward_recurrence_launches,
                gemm_nn.launches) == (
            before[0] + 1, before[1] + layers, before[2] + layers, before[3] + layers)
        again = fls.tasks_forward(x, masks, keep, dtype, w0, wr, b2d)
        pieces = fls.tasks_forward_schedule(x, masks, keep, dtype, w0, wr, b2d,
                                            fls.FWD_CARD_PIECES)
        ref = fls.tasks_forward_schedule(x, masks, keep, dtype, w0, wr, b2d, fls.FWD_PLAIN_PIECES)
        one = [fls.train_forward(x[v], None if masks is None else masks[v], keep, dtype, b2d[v],
                                 [w0[v], *wr[v]])[0] for v in range(nv)]
    for name, g, a, p, r in zip(("h_last", "h_all", "c_all", "gates"), got, again, pieces, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        assert torch.equal(g, a) and torch.equal(g, p), name
        torch.testing.assert_close(g.float(), r.float(), rtol=TOL[dtype], atol=TOL[dtype],
                                   msg=name)
    torch.testing.assert_close(got[0], torch.stack(one), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
def test_auto_takes_the_plain_stack_where_no_cluster_holds_wh(dev):
    """Float32 hidden 448 (320 before 16-block clusters) has no cluster
    plan for Wh: a train step of the hybrid under `lstm_kernel="auto"` runs
    the plain stack (rows 4-5 never launch, `plain_routes` counts the call)
    with the plain route's gradients; the forced routes `pallas_stack`
    (rows 4-5) and `pallas` (rows 18-19) launch their kernels on streamed
    plans, each counted, no plain route, the plain route's gradients within
    1e-4 relative."""
    cfg = dataclasses.replace(CFG, lstm_hidden=448, lstm_layers=2)
    model = init_model(torch.Generator().manual_seed(3), cfg, device=dev)
    a_hat = _a_hat(dev)
    x = torch.from_numpy(
        np.random.default_rng(4).normal(size=(7, 128, 16)).astype(np.float32)).to(dev)
    train = fused_lstm_stack.lstm_stack_train
    gen = torch.Generator(device=dev)
    before = (train.launches, train.backward_launches, train.plain_routes)
    params = list(model.parameters())
    got = torch.autograd.grad(apply_model(model, a_hat, x, 3, cfg, train=True,
                                          generator=gen.manual_seed(5)).sum(), params)
    assert (train.launches, train.backward_launches, train.plain_routes) == (
        before[0], before[1], before[2] + 1)
    plain = dataclasses.replace(cfg, lstm_kernel="xla")
    ref = torch.autograd.grad(apply_model(model, a_hat, x, 3, plain, train=True,
                                          generator=gen.manual_seed(5)).sum(), params)
    for (name, _), a, b in zip(model.named_parameters(), got, ref):
        assert torch.equal(a, b), name
    plain = train.plain_routes
    for kernel, entry, n in (("pallas_stack", train, 1),
                             ("pallas", lstm_scan.lstm_recurrence, cfg.lstm_layers)):
        counts = lambda: (entry.launches, entry.backward_launches, entry.streamed_launches,
                          entry.backward_streamed_launches)
        before = counts()
        got = torch.autograd.grad(apply_model(
            model, a_hat, x, 3, dataclasses.replace(cfg, lstm_kernel=kernel), train=True,
            generator=gen.manual_seed(5)).sum(), params)
        assert counts() == tuple(b + n for b in before), kernel
        for (name, _), a, b in zip(model.named_parameters(), got, ref):
            assert _rel(a, b) <= 1e-4, (kernel, name, _rel(a, b))
    assert train.plain_routes == plain


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [448, 132])
def test_eval_routes_take_the_plain_stack_where_unplanned(dev, hidden):
    """Float32 hidden 448 (no cluster holds Wh) and 132 (not a multiple of
    8): the hybrid's eval forward under `lstm_kernel="auto"` and under
    `use_pallas_lstm` (also its train mode at dropout 0) runs the plain
    stack, counted once a call, rows 2 and 20 never launch, and it equals
    the plain route; a forced `pallas_stack` eval forward launches row 2 on
    a streamed plan at 448 (within 1e-4 of the plain route) and raises at
    132."""
    cfg = dataclasses.replace(CFG, lstm_hidden=hidden, lstm_layers=2, lstm_dropout=0.0)
    model = init_model(torch.Generator().manual_seed(3), cfg, device=dev)
    a_hat = _a_hat(dev)
    x = torch.from_numpy(
        np.random.default_rng(4).normal(size=(7, 128, 16)).astype(np.float32)).to(dev)
    fls = fused_lstm_stack
    entries = (fls.lstm_stack_last_all, fused_lstm.fused_lstm_last_hidden,
               fls.lstm_stack_train)
    with torch.no_grad():
        ref = apply_model(model, a_hat, x, 3, dataclasses.replace(cfg, lstm_kernel="xla"))
    for flags in (dict(lstm_kernel="auto"), dict(use_pallas_lstm=True)):
        mc = dataclasses.replace(cfg, **flags)
        before = [e.launches for e in entries], fls.lstm_stack_train.plain_routes
        with torch.no_grad():
            got = apply_model(model, a_hat, x, 3, mc)
        assert ([e.launches for e in entries], fls.lstm_stack_train.plain_routes) == (
            before[0], before[1] + 1), flags
        assert torch.equal(got, ref), flags
    mc = dataclasses.replace(cfg, use_pallas_lstm=True)
    before = fused_lstm.fused_lstm_last_hidden.launches, fls.lstm_stack_train.plain_routes
    apply_model(model, a_hat, x, 3, mc, train=True).sum().backward()
    assert (fused_lstm.fused_lstm_last_hidden.launches, fls.lstm_stack_train.plain_routes) == (
        before[0], before[1] + 1)
    forced = dataclasses.replace(cfg, lstm_kernel="pallas_stack")
    if hidden % 8:
        with torch.no_grad(), pytest.raises(ValueError, match="multiples of 8"):
            apply_model(model, a_hat, x, 3, forced)
        return
    last = fls.lstm_stack_last_all
    before = last.launches, last.streamed_launches, fls.lstm_stack_train.plain_routes
    with torch.no_grad():
        got = apply_model(model, a_hat, x, 3, forced)
    assert (last.launches, last.streamed_launches, fls.lstm_stack_train.plain_routes) == (
        before[0] + 1, before[1] + 1, before[2])
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_lstm_tasks_forward_refuses_what_row4_refuses(dev):
    """Row 16 takes the widths whose Wh a cluster holds: float32 hidden 448
    holds no forward-recurrence plan for V tasks (Wh beyond 16 blocks'
    shared memory; 320 before 16-block clusters), nor a streamed one for one
    task, where row 4 (one task) launches its streamed plan."""
    w0, wr, b = _task_weights(dev, 2, 24, 448, 2, 0)
    x = torch.zeros((2, 8, 7, 24), device=dev)
    with pytest.raises(ValueError, match="forward recurrence holds Wh in at most 16 blocks"):
        fused_lstm_stack.lstm_stack_train_tasks(x, w0, wr, b)
    with pytest.raises(ValueError, match="task-batched LSTM stack"):
        fused_lstm_stack.lstm_stack_train_tasks(x[:1], w0[:1], wr[:1], b[:1])
    train = fused_lstm_stack.lstm_stack_train
    before = train.launches, train.streamed_launches
    with torch.no_grad():
        fused_lstm_stack.lstm_stack_train(init_lstm(torch.Generator().manual_seed(0), 24, 448,
                                                    2).to(dev).layers, x[0])
    assert (train.launches, train.streamed_launches) == (before[0] + 1, before[1] + 1)


WIDE = [(torch.float32, 320), (torch.float32, 384), (torch.bfloat16, 448), (torch.bfloat16, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hidden", WIDE)
def test_recurrences_on_16_block_clusters_match_plain(dev, dtype, hidden):
    """The four cluster recurrences alone at 48 rows where only a 16-block
    cluster holds Wh (float32 H 320 / 384, bfloat16 448 / 512): forward,
    backward (both C entries), tangent backward, tangent forward below the
    top layer and at it, each against its plain version, each plan's
    16-block clusters fitting on the card."""
    test_forward_recurrence_cluster_sizes_match_plain(dev, dtype, hidden)
    test_backward_recurrence_cluster_sizes_match_plain(dev, dtype, hidden)
    test_tangent_recurrence_cluster_sizes_match_plain(dev, dtype, hidden)
    for below_top in (True, False):
        test_tangent_forward_recurrence_cluster_sizes_match_plain(dev, dtype, hidden, below_top)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hidden", [(torch.float32, 320), (torch.float32, 384),
                                          (torch.bfloat16, 512)])
def test_stacks_on_16_block_clusters_match_plain(dev, dtype, hidden):
    """Every LSTM row on 16-block clusters against its plain version at 100
    rows, 7 steps, 2 layers, masks at 0.2: rows 4-5 (forward and every
    gradient), rows 10-11 (tangents 1e-4 relative in float32), rows 16-17
    at V = 2, rows 18-19 (one layer's recurrence and its backward, the
    weight layout in two launches of 8 slices) and rows 2 and 20 (the eval
    forward); each launches."""
    fls, fh = fused_lstm_stack, fused_lstm_hvp
    sms, tol = fls._sms(dev), TOL[dtype]
    for plan in (fls.forward_plan(hidden, 100, dtype.itemsize, sms),
                 fls.recurrence_plan(hidden, 100, dtype.itemsize, sms),
                 fls.forward_plan(hidden, 100, dtype.itemsize, sms, 2),
                 fh.tangent_forward_plan(hidden, 100, dtype.itemsize, sms),
                 fh.tangent_plan(hidden, 100, dtype.itemsize, sms)):
        assert plan[:2] == (16, 32), plan
    lstm = init_lstm(torch.Generator().manual_seed(1), 24, hidden, 2).to(dev)
    x = _card(dev, (100, 7, 24), seed=6)
    masks = draw_mask(torch.Generator(device=dev).manual_seed(4), (1, 7, 100, hidden), 0.2, dev)
    params = [p for layer in lstm.layers for p in (layer.wx, layer.wh, layer.b)]
    train = fls.lstm_stack_train
    before = (train.launches, train.backward_launches)
    got, got_g = _fwd_bwd(lambda x: train(lstm.layers, x, masks=masks, keep=0.8,
                                          compute_dtype=dtype), [x], params)
    assert (train.launches, train.backward_launches) == (before[0] + 1, before[1] + 1)
    ref, ref_g = _fwd_bwd(lambda x: fls.lstm_stack_plain(lstm.layers, x, dtype, masks, 0.8),
                          [x], params)
    torch.testing.assert_close(got, ref, rtol=tol, atol=tol)
    for i, (g, r) in enumerate(zip(got_g, ref_g)):
        assert _rel(g, r) <= tol, ("rows 4-5", i, _rel(g, r))

    a = _r_op_inputs(dev, 7, 100, 24, hidden, 2, 0.2, w_scale=0.1)
    before = (fh.hvp_stack_fwd.launches, fh.hvp_stack_bwd.launches)
    got_p, got_t = r_ops(a, dtype, kernels=True)
    assert (fh.hvp_stack_fwd.launches, fh.hvp_stack_bwd.launches) == (before[0] + 1,
                                                                       before[1] + 1)
    ref_p, ref_t = r_ops(a, dtype, kernels=False)
    for i, (g, r) in enumerate(zip(got_p, ref_p)):
        assert _rel(g, r) <= tol, ("rows 4-5 under rows 10-11", i, _rel(g, r))
    for i, (g, r) in enumerate(zip(got_t, ref_t)):
        assert _rel(g, r) <= (1e-4 if dtype == torch.float32 else tol), ("rows 10-11", i)

    w0, wr, b2d = _task_weights(dev, 2, 24, hidden, 2, 10)
    xv = _card(dev, (2, 100, 7, 24), seed=7)
    mv = draw_mask(torch.Generator(device=dev).manual_seed(5), (2, 1, 7, 100, hidden), 0.2, dev)
    fn = fls.lstm_stack_train_tasks
    before = (fn.launches, fn.backward_launches)
    got, got_g = _fwd_bwd(lambda x, w0, b, wr: fn(x, w0, wr, b, masks=mv, keep=0.8,
                                                  compute_dtype=dtype), [xv, w0, b2d, wr], [])
    assert (fn.launches, fn.backward_launches) == (before[0] + 1, before[1] + 1)
    ref, ref_g = _fwd_bwd(lambda x, w0, b, wr: fls.lstm_stack_tasks_plain(
        x, w0, wr, b, mv, 0.8, dtype), [xv, w0, b2d, wr], [])
    torch.testing.assert_close(got, ref, rtol=tol, atol=tol)
    for i, (g, r) in enumerate(zip(got_g, ref_g)):
        assert _rel(g, r) <= tol, ("rows 16-17", i, _rel(g, r))

    xp = _card(dev, (7, 100, 4 * hidden), seed=8)
    wh = _card(dev, (hidden, 4 * hidden), seed=9, scale=hidden ** -0.5).requires_grad_(True)
    rec = lstm_scan.lstm_recurrence
    before = (rec.launches, rec.backward_launches)
    got, got_g = _fwd_bwd(lambda a: rec(a, wh, compute_dtype=dtype), [xp], [wh])
    assert (rec.launches, rec.backward_launches) == (before[0] + 1, before[1] + 1)
    ref, ref_g = _fwd_bwd(lambda a: lstm_scan.lstm_recurrence_plain(a, wh, dtype), [xp], [wh])
    torch.testing.assert_close(got, ref, rtol=tol, atol=tol)
    for i, (g, r) in enumerate(zip(got_g, ref_g)):
        assert _rel(g, r) <= tol, ("rows 18-19", i, _rel(g, r))

    with torch.no_grad():
        ref = fls.lstm_stack_plain(lstm.layers, x, dtype)
        for entry in (fls.lstm_stack_last_all, fused_lstm.fused_lstm_last_hidden):
            before = entry.launches
            torch.testing.assert_close(entry(lstm.layers, x, compute_dtype=dtype), ref,
                                       rtol=tol, atol=tol)
            assert entry.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [320, 384])
def test_auto_and_forced_routes_take_the_kernels_at_16_block_widths(dev, hidden):
    """Float32 hidden 320 and 384, where 16-block clusters hold Wh: a train
    step of the hybrid under `auto` and `pallas_stack` launches rows 4-5,
    under `pallas` rows 18-19, each with the plain route's gradients, no
    plain route counted; the eval forward under `auto` launches row 2 and
    under `use_pallas_lstm` row 20, equal to the plain route."""
    cfg = dataclasses.replace(CFG, lstm_hidden=hidden, lstm_layers=2)
    model = init_model(torch.Generator().manual_seed(3), cfg, device=dev)
    a_hat = _a_hat(dev)
    x = torch.from_numpy(
        np.random.default_rng(4).normal(size=(7, 128, 16)).astype(np.float32)).to(dev)
    fls = fused_lstm_stack
    gen = torch.Generator(device=dev)
    params = list(model.parameters())

    def grads(mc):
        return torch.autograd.grad(apply_model(model, a_hat, x, 3, mc, train=True,
                                               generator=gen.manual_seed(5)).sum(), params)

    ref = grads(dataclasses.replace(cfg, lstm_kernel="xla"))
    plain = fls.lstm_stack_train.plain_routes
    for kernel, entry in (("auto", fls.lstm_stack_train), ("pallas_stack", fls.lstm_stack_train),
                          ("pallas", lstm_scan.lstm_recurrence)):
        before = (entry.launches, entry.backward_launches)
        got = grads(dataclasses.replace(cfg, lstm_kernel=kernel))
        n = 1 if entry is fls.lstm_stack_train else cfg.lstm_layers
        assert (entry.launches, entry.backward_launches) == (before[0] + n, before[1] + n), kernel
        for (name, _), a, b in zip(model.named_parameters(), got, ref):
            assert _rel(a, b) <= 1e-4, (kernel, name, _rel(a, b))
    with torch.no_grad():
        ref = apply_model(model, a_hat, x, 3, dataclasses.replace(cfg, lstm_kernel="xla"))
        for flags, entry in ((dict(lstm_kernel="auto"), fls.lstm_stack_last_all),
                             (dict(use_pallas_lstm=True), fused_lstm.fused_lstm_last_hidden)):
            before = entry.launches
            got = apply_model(model, a_hat, x, 3, dataclasses.replace(cfg, **flags))
            assert entry.launches == before + 1, flags
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    assert fls.lstm_stack_train.plain_routes == plain


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(7, 100, 32), (7, 3000, 12), (24, 512, 128), (24, 1024, 128),
                                   (1, 48, 64)])
def test_lstm_recurrence_backward_runs_on_the_tn_core(dev, dtype, shape):
    """Row 19's call (one C call) from row 18's residuals against
    `scan_backward_plain` and a plain dwh: dgates and dwh; one launch of the
    TN core; the same schedule a launch at a time
    (`lstm_scan.CARD_PIECES`) and a second call give the same bits. Hidden
    12 (float32 only: the forward refuses it in bfloat16) zero-pads h's
    columns for the TN product."""
    t_len, rows, hidden = shape
    if dtype == torch.bfloat16 and hidden % 8:
        pytest.skip("the forward refuses bfloat16 at a hidden width that is no multiple of 8")
    xp = _card(dev, (t_len, rows, 4 * hidden), seed=hidden)
    wh = _card(dev, (hidden, 4 * hidden), seed=hidden + 1, scale=0.1)
    g = _card(dev, (t_len, rows, hidden), seed=hidden + 2)
    rec = lstm_scan.lstm_recurrence
    with torch.no_grad():
        h_all, c_all, gates = lstm_scan.scan_forward(xp, wh, dtype, True)
        before = (rec.backward_launches, rec.backward_gemm_tn_launches, gemm_tn.launches)
        got = lstm_scan.scan_backward(g, h_all, c_all, gates, wh, dtype)
        assert (rec.backward_launches, rec.backward_gemm_tn_launches, gemm_tn.launches) == (
            before[0] + 1, before[1] + 1, before[2] + 1)
        again = lstm_scan.scan_backward(g, h_all, c_all, gates, wh, dtype)
        pieces = lstm_scan.scan_backward_schedule(g, h_all, c_all, gates, wh, dtype,
                                                  lstm_scan.CARD_PIECES)
        ref_dg = lstm_scan.scan_backward_plain(g, gates, c_all, wh, dtype)
        h_prev = torch.cat([torch.zeros_like(h_all[:1]), h_all[:-1]]).reshape(-1, hidden)
        ref_dwh = (as_operand(h_prev, dtype).double().T
                   @ as_operand(got[0].reshape(-1, 4 * hidden), dtype).double())
    for name, a, s, p in zip(("dgates", "dwh"), got, again, pieces):
        assert a.dtype == torch.float32 and torch.equal(a, s) and torch.equal(a, p), name
    assert got[1].shape == (hidden, 4 * hidden)
    assert _rel(got[0], ref_dg) <= TOL[dtype], _rel(got[0], ref_dg)
    if t_len == 1:  # h_{-1} = 0: no term
        assert not got[1].any()
    else:
        assert _rel(got[1], ref_dwh) <= 1e-5, _rel(got[1], ref_dwh)


def _split_bias_model(dev, cfg, seed=0):
    """The hybrid at `cfg` with torch's two LSTM biases, as an imported
    reference checkpoint gives them (`utils/torch_import`): a real
    torch.nn.LSTM's state dict, bias_hh nonzero."""
    from weatherforecast_stgcn_maml_tpu_torch.models.registry import load_params
    from weatherforecast_stgcn_maml_tpu_torch.utils.torch_import import params_from_state_dicts

    model = init_model(torch.Generator().manual_seed(seed), cfg)
    torch.manual_seed(seed)
    lstm = torch.nn.LSTM(cfg.hidden_channels, cfg.lstm_hidden, cfg.lstm_layers)
    sd = {k: v for k, v in model.state_dict().items() if not k.startswith("lstm.")}
    ref = params_from_state_dicts(
        {**{f"base_stgcn.conv{i + 1}.lin.weight": sd[f"encoder.layers.{i}.w"].t()
            for i in range(cfg.gcn_layers)},
         **{f"base_stgcn.conv{i + 1}.bias": sd[f"encoder.layers.{i}.b"]
            for i in range(cfg.gcn_layers)},
         **{f"lstm.{k}": v.detach() for k, v in lstm.state_dict().items()},
         "output_layer.weight": sd["head.w"].t(), "output_layer.bias": sd["head.b"]},
        {"embedding.weight": sd["koppen"]}, cfg)
    load_params(model, ref)
    return model.to(dev)


@pytest.mark.cuda
def test_imported_split_biases_train_on_rows_4_to_7(dev):
    """A train step of the imported (split-bias) model on the card's kernels
    (rows 4-7, no plain stack) against the plain route with the same masks:
    every gradient within the float32 gate, b_ih and b_hh included, and the
    two biases of a layer given the same gradient."""
    from weatherforecast_stgcn_maml_tpu_torch.models.losses import masked_mse
    from weatherforecast_stgcn_maml_tpu_torch.models.registry import draw_masks

    cfg = dataclasses.replace(CFG, hidden_channels=64, lstm_hidden=32)
    model = _split_bias_model(dev, cfg)
    names, leaves = zip(*model.named_parameters())
    assert "lstm.layers.2.b_hh" in names
    a_hat = _a_hat(dev)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, cfg.window, 128, cfg.feature_channels)).astype(np.float32)).to(dev)
    y = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, cfg.horizon, 128, 12)).astype(np.float32)).to(dev)
    mask = torch.ones(128, device=dev)
    masks = draw_masks(cfg, torch.Generator(device=dev).manual_seed(4), x)
    grads = {}
    train = fused_lstm_stack.lstm_stack_train
    gcn = fused_gcn_train.gcn_stack_train
    for route, mc in (("kernel", cfg),
                      ("plain", dataclasses.replace(cfg, use_pallas_gcn=False, lstm_kernel="xla"))):
        before = (train.launches, train.backward_launches, gcn.launches, gcn.backward_launches,
                  train.plain_routes)
        loss = masked_mse(apply_model(model, a_hat, x, 3, mc, train=True, masks=masks), y, mask)
        grads[route] = dict(zip(names, torch.autograd.grad(loss, leaves)))
        moved = tuple(a - b for a, b in zip(
            (train.launches, train.backward_launches, gcn.launches, gcn.backward_launches,
             train.plain_routes), before))
        assert moved == ((1, 1, 1, 1, 0) if route == "kernel" else (0, 0, 0, 0, 0)), moved
    for k in names:
        assert _rel(grads["kernel"][k], grads["plain"][k]) <= TOL[torch.float32], k
    for l in range(cfg.lstm_layers):
        assert torch.equal(grads["kernel"][f"lstm.layers.{l}.b_ih"],
                           grads["kernel"][f"lstm.layers.{l}.b_hh"])


@pytest.mark.cuda
def test_fleet_step_task_batched_is_bitwise_serial(dev):
    """The fleet's task-batched step at the reference width (3 regions of 2
    windows x 512 nodes, dropout 0, where rows 16-17's plans are rows 4-5's)
    gives each region bitwise its serial step's predictions, loss and
    gradients: row 17's weight gradients split as one task's, the heads
    each their own product."""
    from weatherforecast_stgcn_maml_tpu_torch.models.hybrid import apply_hybrid_tasks
    from weatherforecast_stgcn_maml_tpu_torch.models.losses import masked_mse
    from weatherforecast_stgcn_maml_tpu_torch.train.supervised import functional_apply

    cfg = ModelConfig(gcn_dropout=0.0, lstm_dropout=0.0)
    template = init_model(torch.Generator().manual_seed(3), cfg, device=dev)
    names = [k for k, _ in template.named_parameters()]
    models = [init_model(torch.Generator().manual_seed(10 + v), cfg, device=dev)
              for v in range(3)]
    params = {k: torch.stack([dict(m.named_parameters())[k].detach() for m in models])
              for k in names}
    graph = build_region_graph(np.arange(53, 58.01, 0.25), np.arange(35, 40.01, 0.25))
    a_hat = torch.from_numpy(graph.a_hat).to(dev).expand(3, -1, -1).contiguous()
    mask = torch.from_numpy(graph.node_mask).to(dev)
    x = _card(dev, (3, 2, cfg.window, 512, cfg.feature_channels), seed=1)
    y = _card(dev, (3, 2, cfg.horizon, 512, 12), seed=2)
    koppen = [5, 7, 9]
    # The serial step with `_VBATCH` off, as the fleet's default route runs
    # it (under `_VBATCH` a window batch would run on rows 16-17 itself).
    assert not fused_lstm_stack._VBATCH
    leaves = [params[k].detach().requires_grad_(True) for k in names]
    tasks = fused_lstm_stack.lstm_stack_train_tasks
    before = (tasks.launches, tasks.backward_launches)
    preds = apply_hybrid_tasks(dict(zip(names, leaves)), a_hat, x,
                               torch.tensor(koppen, device=dev), cfg, masks={})
    losses = torch.stack([masked_mse(preds[v], y[v], mask) for v in range(3)])
    grads = torch.autograd.grad(losses.sum(), leaves)
    assert (tasks.launches, tasks.backward_launches) == (before[0] + 1, before[1] + 1)
    for v in range(3):
        one = [params[k][v].detach().requires_grad_(True) for k in names]
        ref = functional_apply(template, dict(zip(names, one)), apply_model, a_hat[v], x[v],
                               koppen[v], cfg, train=True,
                               generator=torch.Generator(device=dev).manual_seed(1))
        loss = masked_mse(ref, y[v], mask)
        assert torch.equal(preds[v].detach(), ref.detach()) and torch.equal(losses[v], loss), v
        for k, g, r in zip(names, grads, torch.autograd.grad(loss, one)):
            assert torch.equal(g[v], r), (v, k, _rel(g[v], r))


@pytest.mark.cuda
def test_fleet_step_region_batched_on_rows_16_17(dev, monkeypatch):
    """The fleet's step over 3 regions (2 windows each, split biases, dropout
    0), two steps: under `_VBATCH` one launch of rows 16 and 17 a step and no
    row 4-5 launch; by default 3 of each of rows 4-5 and none of 16-17. The
    two routes' losses of both steps within the float32 gate, and the first
    step's gradients (each region's Adam first moment after it, 0.1 x the
    clipped gradient) as max|diff| / max|ref|. The updated weights are not
    compared: Adam moves a weight whose gradient is near its eps by about lr
    whatever the gradient's last bits, and such a weight barely moves the
    loss."""
    from weatherforecast_stgcn_maml_tpu_torch.parallel.fleet_mesh import stack_fleet
    from weatherforecast_stgcn_maml_tpu_torch.train.optimizers import adaptation_optimizer
    from weatherforecast_stgcn_maml_tpu_torch.train.supervised import make_region_train_step

    cfg = dataclasses.replace(CFG, hidden_channels=64, lstm_hidden=32, gcn_dropout=0.0,
                              lstm_dropout=0.0)
    template = _split_bias_model(dev, cfg, seed=1)
    tx, lr0 = adaptation_optimizer("Moscow")
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(3, 2, cfg.window, 128, cfg.feature_channels))
                         .astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.normal(size=(3, 2, cfg.horizon, 128, 12)).astype(np.float32)).to(dev)
    a_hat = _a_hat(dev).expand(3, 128, 128).contiguous()
    mask = torch.ones(3, 128, device=dev)
    train, tasks = fused_lstm_stack.lstm_stack_train, fused_lstm_stack.lstm_stack_train_tasks
    step = make_region_train_step(cfg, tx, template)
    out = {}
    for vbatch in (False, True):
        monkeypatch.setattr(fused_lstm_stack, "_VBATCH", vbatch)
        params, _ = stack_fleet([dict(template.named_parameters())] * 3, None, dev)
        states = [tx.init({k: p[v] for k, p in params.items()}) for v in range(3)]
        before = (train.launches, train.backward_launches, tasks.launches, tasks.backward_launches)
        losses, first_mu = [], None
        for _ in range(2):
            states, loss = step(params, states, x, y, a_hat, mask, [1, 2, 3], [lr0] * 3,
                                [None] * 3)
            losses.append(loss)
            first_mu = first_mu or [dict(st.mu) for st in states]
        moved = tuple(a - b for a, b in zip(
            (train.launches, train.backward_launches, tasks.launches, tasks.backward_launches),
            before))
        assert moved == ((0, 0, 2, 2) if vbatch else (6, 6, 0, 0)), moved
        out[vbatch] = torch.stack(losses), first_mu
    torch.testing.assert_close(out[True][0], out[False][0], rtol=1e-5, atol=1e-5)
    for v in range(3):
        for k, mu in out[False][1][v].items():
            assert _rel(out[True][1][v][k], mu) <= TOL[torch.float32], (k, v)


# Widths past the clusters that hold Wh: float32 448 (3-18% of a slice past
# a 16-block cluster's shared memory) and 1024, bfloat16 640.
STREAMED = [(torch.float32, 448), (torch.float32, 1024), (torch.bfloat16, 640)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hidden", STREAMED)
@pytest.mark.parametrize("masked", [True, False])
def test_streamed_recurrences_match_plain(dev, dtype, hidden, masked):
    """The streamed recurrences against their plain versions at 100 rows,
    7 steps, input 24, 2 layers (masks at 0.2, or none): the forward
    recurrence alone (the next layer's masked input and the last h), the
    backward alone through both C entries (with dh / dc and the bias
    partials; c_all float32), rows 4-5 and 14-15 (forward and every
    gradient), rows 18-19 and rows 2 and 20; every plan streams (k_res < K)
    and each entry counts its streamed launches. Gates: float32 forwards
    1e-5, gradients max|diff| / max|ref| <= 1e-5; bfloat16 5e-2."""
    fls, tol = fused_lstm_stack, TOL[dtype]
    rows, t_len, c_in = 100, 7, 24
    sms = fls._sms(dev)
    fwd_plan = fls.forward_plan(hidden, rows, dtype.itemsize, sms)
    bwd_plan = fls.recurrence_plan(hidden, rows, dtype.itemsize, sms)
    assert fwd_plan[3] < hidden and bwd_plan[3] < 4 * hidden, (fwd_plan, bwd_plan)
    lib, code = cuda_build.load(), cuda_build.dtype_code(dtype)
    assert lib.wf_lstm_stack_forward_stream_clusters(code, *fwd_plan[:3], hidden,
                                                     fwd_plan[3]) > 0
    assert lib.wf_lstm_stack_recurrence_stream_clusters(code, *bwd_plan[:3], hidden,
                                                        bwd_plan[3]) > 0
    assert lib.wf_lstm_stack_forward_stream_smem(code, *fwd_plan[1:3], hidden, fwd_plan[3]) == \
        fls.scan_fwd_stream_smem(hidden, *fwd_plan[1:3], dtype.itemsize, fwd_plan[3])
    assert lib.wf_lstm_stack_recurrence_stream_smem(code, *bwd_plan[1:3], hidden,
                                                    bwd_plan[3]) == \
        fls.scan_stream_smem(hidden, *bwd_plan[1:3], dtype.itemsize, bwd_plan[3])

    # The forward recurrence alone (rows 4 and 14's piece).
    xp = _card(dev, (t_len, rows, 4 * hidden), seed=hidden)
    wh = _card(dev, (hidden, 4 * hidden), seed=hidden + 1, scale=hidden ** -0.5)
    bias = _card(dev, (4 * hidden,), seed=hidden + 2, scale=0.1)
    mask = ((_card(dev, (t_len, rows, hidden), seed=hidden + 3) > -0.84).to(torch.int8)
            if masked else None)
    outs = {}
    for name, piece in (("kernel", fls._forward_recurrence_card),
                        ("plain", fls._forward_recurrence_plain)):
        gates = xp.clone()
        res = [torch.empty((t_len, rows, hidden), dtype=dtype, device=dev) for _ in range(3)]
        h_last = torch.empty((rows, hidden), device=dev)
        piece(gates, wh, bias, dtype, res[0], res[1], mask=mask, inv_keep=1.25,
              next_in=res[2] if masked else None, h_last=h_last)
        outs[name] = (gates, res[0], res[1], h_last, *res[2:3 if masked else 2])
    for i, (a, b) in enumerate(zip(outs["kernel"], outs["plain"])):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol, msg=f"forward {i}")

    # The backward recurrence alone (rows 5 and 15's entry, row 19's).
    g, gates, c, wh = _recurrence_inputs(dev, t_len, rows, hidden, hidden)
    ref, ref_dh, ref_dc = lstm_scan.scan_backward_plain(g, gates, c.to(dtype), wh, dtype,
                                                        carries=True)
    out, dh, dc = torch.empty_like(gates), torch.empty_like(g), torch.empty_like(g)
    db = torch.empty((1, 4 * hidden), device=dev)
    fls._recurrence_card(g, gates, c.to(dtype), wh, dtype, out, dh, dc, db=db[0])
    for name, a, b in (("dgates", out, ref), ("dh", dh, ref_dh), ("dc", dc, ref_dc),
                       ("db", db[0], ref.sum(dim=(0, 1)))):
        assert _rel(a, b) <= tol, (name, _rel(a, b))
    out19 = fls.launch_recurrence(lib.wf_lstm_scan_bwd, "row 19", g, gates, c, wh, dtype,
                                  torch.empty_like(gates))
    ref19 = lstm_scan.scan_backward_plain(g, gates, c, wh, dtype)
    assert _rel(out19, ref19) <= tol, _rel(out19, ref19)

    # Rows 4-5, 14-15, 18-19 and 2 / 20 through their entries.
    lstm = init_lstm(torch.Generator().manual_seed(hidden), c_in, hidden, 2).to(dev)
    x = _card(dev, (rows, t_len, c_in), seed=hidden + 4)
    masks = (draw_mask(torch.Generator(device=dev).manual_seed(4), (1, t_len, rows, hidden),
                       0.2, dev) if masked else None)
    keep = 0.8 if masked else 1.0
    params = [p for layer in lstm.layers for p in (layer.wx, layer.wh, layer.b)]
    ref, ref_g = _fwd_bwd(lambda x: fls.lstm_stack_plain(lstm.layers, x, dtype, masks, keep),
                          [x], params)
    for entry in (fls.lstm_stack_train, fls.lstm_stack_split):
        counts = lambda: (entry.launches, entry.backward_launches, entry.streamed_launches,
                          entry.backward_streamed_launches)
        before = counts()
        got, got_g = _fwd_bwd(lambda x: entry(lstm.layers, x, masks=masks, keep=keep,
                                              compute_dtype=dtype), [x], params)
        assert counts() == tuple(b + 1 for b in before), entry.__name__
        torch.testing.assert_close(got, ref, rtol=tol, atol=tol, msg=entry.__name__)
        for i, (a, b) in enumerate(zip(got_g, ref_g)):
            assert _rel(a, b) <= tol, (entry.__name__, i, _rel(a, b))
    xp = _card(dev, (t_len, rows, 4 * hidden), seed=hidden + 5)
    wh = _card(dev, (hidden, 4 * hidden), seed=hidden + 6, scale=hidden ** -0.5)
    wh.requires_grad_(True)
    rec = lstm_scan.lstm_recurrence
    counts = lambda: (rec.launches, rec.backward_launches, rec.streamed_launches,
                      rec.backward_streamed_launches)
    before = counts()
    got, got_g = _fwd_bwd(lambda a: rec(a, wh, compute_dtype=dtype), [xp], [wh])
    assert counts() == tuple(b + 1 for b in before)
    ref, ref_g = _fwd_bwd(lambda a: lstm_scan.lstm_recurrence_plain(a, wh, dtype), [xp], [wh])
    torch.testing.assert_close(got, ref, rtol=tol, atol=tol)
    for i, (a, b) in enumerate(zip(got_g, ref_g)):
        assert _rel(a, b) <= tol, ("rows 18-19", i, _rel(a, b))
    with torch.no_grad():
        ref = fls.lstm_stack_plain(lstm.layers, x, dtype)
        for entry in (fls.lstm_stack_last_all, fused_lstm.fused_lstm_last_hidden):
            before = entry.launches, entry.streamed_launches
            torch.testing.assert_close(entry(lstm.layers, x, compute_dtype=dtype), ref,
                                       rtol=tol, atol=tol)
            assert (entry.launches, entry.streamed_launches) == (before[0] + 1, before[1] + 1)
