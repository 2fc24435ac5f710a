"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked `cuda` and skips without a card. The file imports
no jax, so it also runs where only PyTorch is installed:

  python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -q

(`--noconftest`: tests/conftest.py sets up jax for the JAX package's tests.)
Tolerances are those of chip_smoke.py: float32 1e-5, bfloat16 5e-2.
"""

import numpy as np
import pytest
import torch

from weatherforecast_stgcn_maml_tpu_torch.config import ModelConfig
from weatherforecast_stgcn_maml_tpu_torch.graph import build_region_graph
from weatherforecast_stgcn_maml_tpu_torch.models.lstm import init_lstm
from weatherforecast_stgcn_maml_tpu_torch.models.stgcn import init_encoder
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_gcn, fused_lstm_stack

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
    before = fused_gcn.fused_gcn_stack.launches
    got = fused_gcn.fused_gcn_stack(enc.layers, a_hat, x, compute_dtype=dtype)
    ref = fused_gcn.gcn_stack_plain(enc.layers, a_hat, x, dtype)
    assert fused_gcn.fused_gcn_stack.launches == before + 1
    torch.testing.assert_close(got, ref, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [100, 3000, 5000])
def test_lstm_kernel_matches_plain(dev, dtype, rows):
    """Row counts that pick each row tile on an H100 (2, 4, 8 rows per
    thread), none a multiple of the tile."""
    lstm = init_lstm(torch.Generator().manual_seed(1), 24, 32, 3).to(dev).requires_grad_(False)
    x = torch.from_numpy(
        np.random.default_rng(6).normal(size=(rows, 7, 24)).astype(np.float32)
    ).to(dev)
    before = fused_lstm_stack.lstm_stack_last_all.launches
    got = fused_lstm_stack.lstm_stack_last_all(lstm.layers, x, compute_dtype=dtype)
    ref = fused_lstm_stack.lstm_stack_plain(lstm.layers, x, dtype)
    assert fused_lstm_stack.lstm_stack_last_all.launches == before + 1
    torch.testing.assert_close(got, ref, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
def test_gcn_kernel_rejects_unaligned_nodes(dev):
    enc = init_encoder(torch.Generator().manual_seed(0), CFG).to(dev).requires_grad_(False)
    with pytest.raises(ValueError, match="multiples of 128"):
        fused_gcn.fused_gcn_stack(
            enc.layers, torch.eye(100, device=dev),
            torch.zeros((2, 100, CFG.in_channels), device=dev),
        )
