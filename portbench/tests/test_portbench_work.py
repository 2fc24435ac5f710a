"""`work.py`'s counts against hand-worked values."""

import pytest

from portbench import work

SMALL = {"family": "hybrid", "window": 2, "hidden_channels": 4, "gcn_layers": 2,
         "num_weather_vars": 12, "num_time_vars": 4, "koppen_dim": 8, "lstm_hidden": 2,
         "lstm_layers": 1, "horizon": 1, "compute_dtype": "float32"}


def test_gcn_flops_small():
    # 3 nodes, k = 1: nnz 6. Layer 0: X W 2*2*3*24*4 = 1152, A (XW) 2*6*4*2 = 96;
    # layer 1: 2*2*3*4*4 = 192 and 96. Forward 1536.
    assert work.gcn_flops(SMALL, 3, 1, False) == 1536
    # Backward: layer 0 dX for the 8 Koppen channels 2*2*3*8*4 = 384, dW 1152,
    # A^T g 96; layer 1: 192 + 192 + 96.
    assert work.gcn_flops(SMALL, 3, 1, True) == 1536 + 384 + 1152 + 96 + 192 + 192 + 96


def test_lstm_and_head_flops_small():
    # One layer: 2 * 3 rows * 2 steps * (4 in + 2 hidden) * 4 gates * 2 = 576.
    assert work.lstm_flops(SMALL, 3, False) == 576
    assert work.lstm_flops(SMALL, 3, True) == 3 * 576
    assert work.head_flops(SMALL, 3, False) == 2 * 3 * 2 * 12
    assert work.lstm_flops(dict(SMALL, family="stgcn"), 3, False) == 0


def test_bytes_small():
    # Encoder in: x 2*3*24, weights 24*4 + 4*4 + 2*4, out 2*3*4 floats; A as
    # 6 (value, index) pairs.
    io = 2 * 3 * 24 + (24 * 4 + 4 * 4 + 2 * 4) + 2 * 3 * 4
    assert work.gcn_bytes(SMALL, 3, 1, False) == 4 * io + 8 * 6
    # LSTM: x 3*2*4, weights (4 + 2 + 1) * 8, out 3*2 floats.
    assert work.lstm_bytes(SMALL, 3, False) == 4 * (3 * 2 * 4 + 7 * 8 + 3 * 2)


def test_full_size_per_window():
    """The cells' sizes: 441 nodes, k = 4, ModelConfig()."""
    full = dict(SMALL, window=24, hidden_channels=256, gcn_layers=4, lstm_hidden=128,
                lstm_layers=4, horizon=8)
    assert work.lstm_flops(full, 441, False) == pytest.approx(12.485394432e9, rel=1e-9)
    assert work.gcn_flops(full, 441, 4, False) == pytest.approx(4.400234496e9, rel=1e-9)
    assert work.window_flops(full, 441, 4, True) == pytest.approx(50.494316544e9, rel=1e-9)


def test_least_seconds():
    assert work.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert work.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert work.least_seconds(989e12, 0, "bfloat16") == pytest.approx(1.0)
