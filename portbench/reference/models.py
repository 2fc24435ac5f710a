"""The plain reference of both configurations' forward passes, in plain
torch with no kernel, cache or batching of the program.

hybrid (Yalt8826/WeatherForecast_STGCN_MAML `hybrid_model.py`): the Koppen
embedding of the box's class appended to every node's 16 features; 4 GCN
layers relu(A_hat @ (h @ W) + b), dropout after every one but the last;
the nodes' 24 encoder outputs through a 4-layer LSTM (gates i, f, g, o,
dropout on every inter-layer output; `torch.nn.LSTM` layers, as the
reference repo's); dropout on the top layer's last hidden state; a dense
head to 8 steps x 12 variables.
stgcn (`model.py`): the same encoder with dropout after every layer, its
last time slice through a dense head.

Dropout masks are the program's draws, worked out again from the same
seed: each train forward draws, from the step's generator, uniform floats
in the program's order and shapes (`draw_masks`), at the padded node count,
and keeps an element where the draw is below 1 - rate. Departure from the
published description: the masks are drawn this way, and an element kept
is scaled by 1 / keep, as torch's dropout does.
"""

from __future__ import annotations

import torch


def draw_masks(model: dict, gen: torch.Generator | None, n_pad: int, device) -> dict:
    """One train forward's masks {site: bool}, at n_pad nodes; {} without a
    generator (the differentiable eval function)."""
    if gen is None:
        return {}
    w, hid = model["window"], model["hidden_channels"]

    def draw(shape, rate):
        return torch.rand(shape, generator=gen, device=device) < 1.0 - rate

    masks = {}
    if model["family"] == "hybrid":
        if model["gcn_dropout"] > 0 and model["gcn_layers"] > 1:
            masks["encoder"] = draw((model["gcn_layers"] - 1, w, n_pad, hid),
                                    model["gcn_dropout"])
        if model["lstm_dropout"] > 0:
            h = model["lstm_hidden"]
            if model["lstm_layers"] > 1:
                masks["lstm"] = draw((model["lstm_layers"] - 1, w, n_pad, h),
                                     model["lstm_dropout"])
            masks["head"] = draw((n_pad, h), model["lstm_dropout"])
    elif model["gcn_dropout"] > 0:
        masks["encoder"] = draw((model["gcn_layers"], w, n_pad, hid), model["gcn_dropout"])
    return masks


def _drop(h, mask, keep):
    return h * mask.to(h.dtype) / keep


def forward(model: dict, p: dict, a_hat, x, koppen: int, masks: dict | None = None):
    """Predictions [..., H, N, 12] of windows x [..., W, N, 16] on the real
    nodes (a_hat [N, N]); `masks` at the padded count, cut to N here."""
    masks = masks or {}
    n = x.shape[-2]
    emb = p["koppen"][koppen]
    h = torch.cat([x, emb.expand(*x.shape[:-1], emb.shape[-1])], dim=-1)
    enc = masks.get("encoder")
    keep_gcn = 1.0 - model["gcn_dropout"]
    for l in range(model["gcn_layers"]):
        h = torch.relu(a_hat @ (h @ p[f"encoder.layers.{l}.w"]) + p[f"encoder.layers.{l}.b"])
        if enc is not None and l < enc.shape[0]:
            h = _drop(h, enc[l, ..., :n, :], keep_gcn)
    out_shape = (model["horizon"], model["num_weather_vars"])
    if model["family"] == "stgcn":
        y = h[..., -1, :, :] @ p["head.w"] + p["head.b"]  # [..., N, H * 12]
        return y.reshape(*y.shape[:-1], *out_shape).transpose(-3, -2)
    feat = lstm(model, p, h, masks.get("lstm"))
    if "head" in masks:
        feat = _drop(feat, masks["head"][:n], 1.0 - model["lstm_dropout"])
    y = feat @ p["head.w"] + p["head.b"]  # [..., N, H * 12]
    return y.reshape(*y.shape[:-1], *out_shape).transpose(-3, -2)


def lstm(model: dict, p: dict, h, masks):
    """The stacked LSTM over each node's sequence: h [..., W, N, C] -> the
    top layer's last hidden state [..., N, H]; masks [L-1, W, N_pad, H].
    Each layer is one `torch.nn.LSTM` layer (the reference repo's module:
    cuDNN on a card, float32 math with TF32 off), weights wx^T, wh^T and
    bias b as its b_ih with b_hh zero; the masks go between layers."""
    hidden, keep = model["lstm_hidden"], 1.0 - model["lstm_dropout"]
    lead, (w, n, c) = h.shape[:-3], h.shape[-3:]
    # [..., W, N, C] -> time-major [W, (...) N, C]: every window's nodes are rows.
    seq = h.reshape(-1, w, n, c).transpose(0, 1).reshape(w, -1, c)
    for l in range(model["lstm_layers"]):
        if l > 0 and masks is not None:
            seq = _drop(seq, masks[l - 1, :, :n, :], keep)
        wx, wh, b = (p[f"lstm.layers.{l}.{k}"] for k in ("wx", "wh", "b"))
        cell = _layer(wx.shape[0], hidden, wx.dtype, wx.device)
        seq, _ = torch.func.functional_call(cell, {
            "weight_ih_l0": wx.t().contiguous(), "weight_hh_l0": wh.t().contiguous(),
            "bias_ih_l0": b,
            "bias_hh_l0": torch.zeros_like(b)}, (seq,))
    return seq[-1].reshape(*lead, n, hidden)


_LAYERS: dict = {}


def _layer(c_in: int, hidden: int, dtype, device) -> torch.nn.LSTM:
    """A one-layer torch.nn.LSTM whose parameters are replaced at each call
    (`functional_call`); kept in training mode, as cuDNN's backward needs."""
    key = (c_in, hidden, dtype, str(device))
    if key not in _LAYERS:
        _LAYERS[key] = torch.nn.LSTM(c_in, hidden, device=device, dtype=dtype).train()
    return _LAYERS[key]


def masked_mse(pred, y):
    """Mean squared error over every step, node and variable (real nodes
    only)."""
    return torch.mean(torch.square(pred - y))
