"""The PyTorch port's fused operators against the JAX package, on the CPU.

Same seeded numpy inputs and parameters go through the JAX function and the
port's counterpart. On a CPU tensor the port's wrappers run their plain
PyTorch versions; the CUDA kernels themselves are held against those plain
versions by tests/test_torch_port_cuda.py (on a card) and by chip_smoke.py.

Tolerances: float32 rtol 1e-5 / atol 1e-6 (summation order only), bfloat16
5e-2 (an operand rounding flipped by a last-bit accumulation difference).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from weatherforecast_stgcn_maml_tpu.config import ModelConfig as JaxModelConfig
from weatherforecast_stgcn_maml_tpu.graph import build_region_graph as jax_graph
from weatherforecast_stgcn_maml_tpu.models.lstm import apply_lstm as jax_apply_lstm
from weatherforecast_stgcn_maml_tpu.models.lstm import init_lstm as jax_init_lstm
from weatherforecast_stgcn_maml_tpu.models.stgcn import init_encoder as jax_init_encoder
from weatherforecast_stgcn_maml_tpu.ops import fused_lstm_stack as jax_fls
from weatherforecast_stgcn_maml_tpu.ops.fused_gcn import fused_gcn_stack as jax_gcn_stack
from weatherforecast_stgcn_maml_tpu_torch.config import ModelConfig
from weatherforecast_stgcn_maml_tpu_torch.models.lstm import init_lstm
from weatherforecast_stgcn_maml_tpu_torch.models.stgcn import init_encoder
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_gcn, fused_lstm_stack
from weatherforecast_stgcn_maml_tpu_torch.utils.convert import state_dict_from_params

torch.set_num_threads(1)  # small tensors; more threads oversubscribe side-by-side workers

TOL = {"float32": dict(rtol=1e-5, atol=1e-6), "bfloat16": dict(rtol=5e-2, atol=5e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SMALL = dict(hidden_channels=16, gcn_layers=2, lstm_hidden=8, lstm_layers=2, window=6,
             horizon=3, koppen_dim=4)
C_IN = ModelConfig(**SMALL).in_channels  # 12 weather + 4 time + 4 Koppen


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _a_hat():
    lats = np.arange(10.0, 11.0 + 1e-9, 0.25)
    lons = np.arange(20.0, 21.0 + 1e-9, 0.25)
    return jax_graph(lats, lons).a_hat  # 25 nodes padded to 128


def _encoder():
    jp = _np(jax_init_encoder(jax.random.key(1), JaxModelConfig(**SMALL)))
    enc = init_encoder(torch.Generator().manual_seed(0), ModelConfig(**SMALL))
    enc.load_state_dict(state_dict_from_params(jp))
    return jp, enc


def _lstm(c_in=16, hidden=8, layers=2):
    jp = _np(jax_init_lstm(jax.random.key(2), c_in, hidden, layers))
    lstm = init_lstm(torch.Generator().manual_seed(0), c_in, hidden, layers)
    lstm.load_state_dict(state_dict_from_params(jp))
    return jp, lstm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gcn_stack_plain_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    jp, enc = _encoder()
    a_hat = _a_hat()
    x = np.random.default_rng(0).normal(size=(3, 6, 128, C_IN)).astype(np.float32)
    ref = jax_gcn_stack(jp["layers"], jnp.asarray(a_hat), jnp.asarray(x), compute_dtype=jdt)
    with torch.no_grad():
        got = fused_gcn.fused_gcn_stack(
            enc.layers, torch.from_numpy(a_hat), torch.from_numpy(x), compute_dtype=tdt
        )
    assert got.dtype == torch.float32 and got.shape == (3, 6, 128, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL[dtype])


def test_gcn_stack_padded_nodes_are_relu_of_bias():
    """Padded rows of A_hat are zero, so padded outputs are relu(b) of the
    last layer, not zero: no kernel may special-case them."""
    _, enc = _encoder()
    with torch.no_grad():
        enc.layers[-1].b.copy_(torch.linspace(-1.0, 1.0, 16))
        x = torch.from_numpy(np.random.default_rng(1).normal(size=(6, 128, C_IN)).astype(np.float32))
        out = fused_gcn.fused_gcn_stack(enc.layers, torch.from_numpy(_a_hat()), x)
    np.testing.assert_array_equal(
        out[:, 25:].numpy(), np.broadcast_to(torch.relu(enc.layers[-1].b).detach().numpy(), (6, 103, 16))
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("jax_kernel", ["pallas_stack", "xla"])
def test_lstm_stack_plain_matches_jax(dtype, jax_kernel):
    """Against the Pallas kernel's real body in the interpreter, and the XLA scan."""
    jdt, tdt = DTYPES[dtype]
    jp, lstm = _lstm()
    x = np.random.default_rng(3).normal(size=(40, 6, 16)).astype(np.float32)
    with jax_fls.force_interpret():
        ref = jax_apply_lstm(jp, jnp.asarray(x), compute_dtype=jdt, kernel=jax_kernel)
    with torch.no_grad():
        got = fused_lstm_stack.lstm_stack_last_all(
            lstm.layers, torch.from_numpy(x), compute_dtype=tdt
        )
    assert got.dtype == torch.float32 and got.shape == (40, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL[dtype])


def test_float64_routes_plain_and_stays_float64():
    _, enc = _encoder()
    _, lstm = _lstm()
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(6, 128, C_IN)))
    with torch.no_grad():
        h = fused_gcn.fused_gcn_stack(
            enc.layers, torch.from_numpy(_a_hat()), x, compute_dtype=torch.float64
        )
        out = fused_lstm_stack.lstm_stack_last_all(
            lstm.layers, h.transpose(0, 1), compute_dtype=torch.float64
        )
    assert h.dtype == torch.float64 and out.dtype == torch.float64


def test_wrappers_refuse_inputs_that_need_grad():
    _, enc = _encoder()
    _, lstm = _lstm()
    x = torch.zeros((6, 128, C_IN))
    with pytest.raises(RuntimeError, match="no backward"):
        fused_gcn.fused_gcn_stack(enc.layers, torch.from_numpy(_a_hat()), x)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_lstm_stack.lstm_stack_last_all(lstm.layers, torch.zeros((4, 6, 16)))
