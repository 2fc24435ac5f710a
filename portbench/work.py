"""The work that the inputs need, from shapes alone, whatever implements it,
and the peaks of the card it is held against.

Counted: the real nodes (not the padded rows), the graph aggregation as
2 x nnz(A_hat) x C a time slice (a sparse product, not a dense N x N one),
and the products of every layer at 2 flops a multiply-add; elementwise
work (bias, activations, dropout, gates) is under 1% and not counted. A
backward costs two products for each forward one (the input's and the
weight's gradient), but layer 0 of the encoder needs its input's gradient
only for the Koppen channels, and the aggregation none for A_hat. Bytes
count each input of a stack once (activations in, weights, A_hat as
nnz values and indices) and each output once.
"""

from __future__ import annotations

import json
import os

_PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def peaks() -> dict:
    """{"float32_flops", "bfloat16_flops", "bytes_per_s"} of one H100 SXM."""
    with open(_PEAKS) as f:
        return json.load(f)


def nnz(nodes: int, k: int) -> int:
    """Entries of A_hat: k in-edges and the self loop a node."""
    return nodes * (k + 1)


def gcn_flops(model: dict, nodes: int, k: int, backward: bool) -> float:
    """The encoder over one window (W slices of `nodes` real nodes)."""
    w, hid = model["window"], model["hidden_channels"]
    c_in = model["num_weather_vars"] + model["num_time_vars"] + model["koppen_dim"]
    total = 0.0
    for l in range(model["gcn_layers"]):
        c = c_in if l == 0 else hid
        xw = 2.0 * w * nodes * c * hid
        agg = 2.0 * nnz(nodes, k) * hid * w
        total += xw + agg
        if backward:
            d_in = model["koppen_dim"] if l == 0 else c  # the input's gradient
            total += 2.0 * w * nodes * d_in * hid + xw + agg  # dX, dW, A^T g
    return total


def lstm_flops(model: dict, nodes: int, backward: bool) -> float:
    """The LSTM stack over one window's `nodes` sequences of W steps."""
    if model["family"] != "hybrid":
        return 0.0
    w, h, hid = model["window"], model["lstm_hidden"], model["hidden_channels"]
    total = 0.0
    for l in range(model["lstm_layers"]):
        c = hid if l == 0 else h
        total += 2.0 * nodes * w * (c + h) * 4 * h
    return total * (3.0 if backward else 1.0)


def head_flops(model: dict, nodes: int, backward: bool) -> float:
    c = model["lstm_hidden"] if model["family"] == "hybrid" else model["hidden_channels"]
    f = 2.0 * nodes * c * model["num_weather_vars"] * model["horizon"]
    return f * (3.0 if backward else 1.0)


def window_flops(model: dict, nodes: int, k: int, backward: bool) -> float:
    """One window's forward (and backward) through the whole model."""
    return (gcn_flops(model, nodes, k, backward) + lstm_flops(model, nodes, backward)
            + head_flops(model, nodes, backward))


def gcn_bytes(model: dict, nodes: int, k: int, backward: bool) -> float:
    """The encoder stack's inputs and outputs over one window, float32."""
    w, hid, layers = model["window"], model["hidden_channels"], model["gcn_layers"]
    c_in = model["num_weather_vars"] + model["num_time_vars"] + model["koppen_dim"]
    weights = c_in * hid + (layers - 1) * hid * hid + layers * hid
    io = w * nodes * c_in + weights + w * nodes * hid
    total = 4.0 * io + 8.0 * nnz(nodes, k)
    if backward:  # in: the output's gradient; out: every weight's, Koppen's
        total += 4.0 * (w * nodes * hid + weights + w * nodes * model["koppen_dim"])
    return total


def lstm_bytes(model: dict, nodes: int, backward: bool) -> float:
    if model["family"] != "hybrid":
        return 0.0
    w, h, hid = model["window"], model["lstm_hidden"], model["hidden_channels"]
    weights = sum(((hid if l == 0 else h) + h + 1) * 4 * h for l in range(model["lstm_layers"]))
    total = 4.0 * (nodes * w * hid + weights + nodes * h)
    if backward:
        total += 4.0 * (nodes * h + weights + nodes * w * hid)
    return total


def peak_dtype(model: dict) -> str:
    """The peak a configuration is held against: bfloat16's for bfloat16
    compute, float32's (outside the tensor cores) otherwise."""
    return "bfloat16" if model["compute_dtype"] == "bfloat16" else "float32"


def peak_flops(model: dict) -> float:
    return peaks()[f"{peak_dtype(model)}_flops"]


def least_seconds(flops: float, nbytes: float, dtype: str = "float32") -> float:
    """max(flops / peak flops, bytes / peak bandwidth)."""
    pk = peaks()
    return max(flops / pk[f"{dtype}_flops"], nbytes / pk["bytes_per_s"])
