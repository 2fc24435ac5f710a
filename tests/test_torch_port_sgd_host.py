"""The whole-tree clip + SGD update's host side (rows 8-9), on the CPU.

The card route with only its C calls swapped for a recording stub (a
fixture: CPU tensors count as a card's, `wf_clip_sgd_plan` and
`wf_clip_sgd_update` record what they are given): the plan cached for a
tree is made once and the packed launch carries the leaves' addresses,
sizes and task count; every check is made again on every call of a cached
tree (a gradient of another shape, dtype or device, a non-contiguous
parameter at the same address, a gradient that requires grad under grad
mode, too many leaves, a task axis that differs), raising as on the first
call. And the plain version in float64 against JAX's `clip_sgd_update`
(its tree route: JAX's Pallas body sums the squares in float32 whatever
the leaves' dtype, so float64 is held against the route that keeps them
in float64), at the 23 leaves of a small model, norms below and above
clip_norm, V = 1 and 3, rtol = atol = 1e-12 (the float32 cases against
the Pallas body in the interpreter are tests/test_torch_port_maml.py's).
"""

import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from weatherforecast_stgcn_maml_tpu.ops import fused_sgd as jax_fused_sgd
from weatherforecast_stgcn_maml_tpu_torch import config as tcfg
from weatherforecast_stgcn_maml_tpu_torch.models.registry import init_model
from weatherforecast_stgcn_maml_tpu_torch.ops import cuda_build, fused_sgd

torch.set_num_threads(1)  # small tensors; more threads oversubscribe side-by-side workers

MODEL = dict(hidden_channels=16, gcn_layers=4, lstm_hidden=8, lstm_layers=4, window=6,
             horizon=3, koppen_dim=4)


class _Stub:
    """The library's two clip + SGD entries, recording their arguments."""

    def __init__(self):
        self.plans, self.launches, self.task_launches = [], [], []

    def wf_clip_sgd_plan(self, n, sizes, tasks):
        self.plans.append((list(sizes[:n]), tasks))
        return 7 * tasks

    def wf_clip_sgd_update(self, launch):
        self.launches.append(launch)
        return 0

    def wf_clip_sgd_update_tasks(self, launch):
        self.task_launches.append(launch)
        return 0


@pytest.fixture()
def stub(monkeypatch):
    lib = _Stub()
    monkeypatch.setattr(fused_sgd, "_on_card", lambda p: True)
    monkeypatch.setattr(fused_sgd, "_library", lambda: lib)
    monkeypatch.setattr(cuda_build, "stream_ptr", lambda dev: 12345)
    monkeypatch.setattr(fused_sgd, "_PLANS", {})
    return lib


def _tree(tasks=1):
    rng = np.random.default_rng(0)
    shapes = [(4, 4), (3,), (2, 5)]
    lead = (tasks,) if tasks > 1 else ()
    params = [torch.from_numpy(rng.normal(size=lead + s).astype(np.float32)) for s in shapes]
    grads = [torch.from_numpy(rng.normal(size=lead + s).astype(np.float32)) for s in shapes]
    return params, grads


def _decode(launch, n):
    head = struct.unpack_from("<qqddqq", launch)
    rest = struct.unpack_from(f"<{3 * n}q", launch, 48)
    assert len(launch) == 48 + 24 * n
    return head, rest[:n], rest[n:2 * n], rest[2 * n:]


@pytest.mark.parametrize("tasks", [1, 3])
def test_plan_is_cached_and_the_launch_packed(stub, tasks):
    params, grads = _tree(tasks)
    counter = "batched_launches" if tasks > 1 else "launches"
    before = getattr(fused_sgd.clip_sgd_update, counter)
    with torch.no_grad():
        for _ in range(3):
            fused_sgd.clip_sgd_update(params, grads, 0.01, 1.0, batched=tasks > 1)
    assert getattr(fused_sgd.clip_sgd_update, counter) == before + 3
    assert stub.plans == [([16, 3, 10], tasks)]  # made once for the tree
    # Row 8 one entry, row 9 (a task axis) its own.
    launches = stub.task_launches if tasks > 1 else stub.launches
    assert len(launches) == 3 and not (stub.launches if tasks > 1 else stub.task_launches)
    (n, v, lr, max_norm, partials, stream), pp, gp, sizes = _decode(launches[-1], 3)
    assert (n, v, lr, max_norm, stream) == (3, tasks, 0.01, 1.0, 12345)
    assert partials != 0
    assert list(pp) == [p.data_ptr() for p in params]
    assert list(gp) == [g.data_ptr() for g in grads]
    assert list(sizes) == [16, 3, 10]
    # New gradients: only their addresses change. A new leaf: a new plan.
    grads = [g.clone() for g in grads]
    params[1] = params[1].clone()
    with torch.no_grad():
        fused_sgd.clip_sgd_update(params, grads, 0.01, 1.0, batched=tasks > 1)
    _, pp, gp, _ = _decode(launches[-1], 3)
    assert list(pp) == [p.data_ptr() for p in params]
    assert list(gp) == [g.data_ptr() for g in grads]
    assert len(stub.plans) == 2


def test_non_contiguous_gradients_are_copied(stub):
    params, grads = _tree()
    grads[0] = grads[0].t().contiguous().t()  # a transposed layout of the same values
    with torch.no_grad():
        fused_sgd.clip_sgd_update(params, grads, 0.01, 1.0)
    _, _, gp, _ = _decode(stub.launches[-1], 3)
    assert gp[0] != grads[0].data_ptr() and gp[1:] == (grads[1].data_ptr(), grads[2].data_ptr())


def _bad_shape(params, grads):
    grads[2] = grads[2].reshape(5, 2)


def _bad_dtype(params, grads):
    grads[1] = grads[1].double()


def _bad_device(params, grads):
    grads[1] = torch.empty(grads[1].shape, device="meta")


def _bad_contiguity(params, grads):
    params[0].t_()  # the same address and shape, no longer contiguous


def _bad_requires_grad(params, grads):
    grads[0] = grads[0].clone().requires_grad_()


@pytest.mark.parametrize("spoil, error, match", [
    (_bad_shape, ValueError, "gradient"),
    (_bad_dtype, TypeError, "device and dtype"),
    (_bad_device, TypeError, "device and dtype"),
    (_bad_contiguity, ValueError, "contiguous"),
    (_bad_requires_grad, RuntimeError, "first-order"),
], ids=["shape", "dtype", "device", "contiguity", "requires_grad"])
def test_cached_tree_rechecks_every_call(stub, spoil, error, match):
    """A fault raises on a fresh tree's first call and on a cached tree's
    later call alike; nothing is launched for it."""
    for warm in (False, True):
        fused_sgd._PLANS.clear()
        params, grads = _tree()
        if warm:
            fused_sgd.clip_sgd_update(params, grads, 0.01, 1.0)  # grad mode on: no grad needed
            assert len(fused_sgd._PLANS) == 1
        launched = len(stub.launches)
        spoil(params, grads)
        with pytest.raises(error, match=match):
            fused_sgd.clip_sgd_update(params, grads, 0.01, 1.0)
        assert len(stub.launches) == launched


def test_tree_refusals_on_every_call(stub):
    many = [torch.zeros(2) for _ in range(fused_sgd.MAX_LEAVES + 1)]
    for _ in range(2):
        with pytest.raises(ValueError, match="at most 64 leaves"):
            fused_sgd.clip_sgd_update(many, [torch.zeros(2) for _ in many], 0.1, 1.0)
    params, grads = _tree(tasks=2)
    fused_sgd.clip_sgd_update(params, grads, 0.1, 1.0, batched=True)
    params[1], grads[1] = torch.zeros(3, 3), torch.zeros(3, 3)
    with pytest.raises(ValueError, match="task axis"):
        fused_sgd.clip_sgd_update(params, grads, 0.1, 1.0, batched=True)
    with pytest.raises(TypeError, match="Python numbers"):
        fused_sgd.clip_sgd_update(params, grads, np.float32(0.1), 1.0)
    assert len(stub.task_launches) == 1 and not stub.launches


def _leaves():
    model = init_model(torch.Generator().manual_seed(0), tcfg.ModelConfig(**MODEL))
    return [p.detach().numpy() for p in model.parameters()]


@pytest.mark.parametrize("tasks", [1, 3])
@pytest.mark.parametrize("scale", [1e-3, 10.0])
def test_plain_update_float64_matches_jax(tasks, scale):
    rng = np.random.default_rng(4)
    leaves = _leaves()
    assert len(leaves) == 23
    shape = (tasks,) if tasks > 1 else ()
    p = [rng.normal(size=shape + a.shape) for a in leaves]
    g = [rng.normal(size=shape + a.shape) * scale
         * (1 + np.arange(tasks)).reshape(shape + (1,) * a.ndim) for a in leaves]
    with jax.enable_x64(True):
        def update(pp, gg):
            return jax_fused_sgd.clip_sgd_update(pp, gg, 0.01, 1.0)

        fn = jax.jit(jax.vmap(update) if tasks > 1 else update)  # one compile, not one an op
        ref = fn([jnp.asarray(a) for a in p], [jnp.asarray(a) for a in g])
        assert ref[0].dtype == jnp.float64
    got = [torch.from_numpy(a.copy()) for a in p]
    fused_sgd.clip_sgd_update_plain(got, [torch.from_numpy(a) for a in g], 0.01, 1.0,
                                    batched=tasks > 1)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-12, atol=1e-12)
