"""Hybrid STGCN->LSTM forecaster, the flagship model.

The GCN encoder runs per time slice, then every node's sequence of encoder
features goes through the stacked LSTM, and a dense head maps the last
hidden state to H steps x 12 variables. The Koppen climate embedding is
looked up inside the model from the integer class code.

Module tree (the JAX pytree's names):
  encoder.layers.{l}.{w,b}, lstm.layers.{l}.{wx,wh,b}, head.{w,b}, koppen
"""

from __future__ import annotations

import torch
from torch import nn

from weatherforecast_stgcn_maml_tpu_torch.config import ModelConfig
from weatherforecast_stgcn_maml_tpu_torch.models.common import (
    apply_dense,
    apply_mask,
    draw_mask,
    fold_row_masks,
    fold_slice_masks,
    init_dense,
    resolve_dtype,
    train_masks,
)
from weatherforecast_stgcn_maml_tpu_torch.models.lstm import apply_lstm, init_lstm
from weatherforecast_stgcn_maml_tpu_torch.models.stgcn import (
    apply_encoder,
    init_encoder,
    koppen_features,
)
from weatherforecast_stgcn_maml_tpu_torch.ops.fused_lstm import fused_lstm_last_hidden


class HybridModel(nn.Module):
    def __init__(self, encoder, lstm, head, koppen: torch.Tensor):
        super().__init__()
        self.encoder = encoder
        self.lstm = lstm
        self.head = head
        self.koppen = nn.Parameter(koppen)


def init_hybrid(generator: torch.Generator, cfg: ModelConfig) -> HybridModel:
    return HybridModel(
        init_encoder(generator, cfg),
        init_lstm(generator, cfg.hidden_channels, cfg.lstm_hidden, cfg.lstm_layers),
        init_dense(generator, cfg.lstm_hidden, cfg.num_weather_vars * cfg.horizon),
        torch.randn((cfg.koppen_classes, cfg.koppen_dim), generator=generator),
    )


def hybrid_masks(cfg: ModelConfig, generator, w: int, n: int, device) -> dict:
    """Dropout masks of one hybrid train forward, drawn in the JAX
    package's order: encoder (after every conv but the last), LSTM (every
    inter-layer output, time-major), head input [N, lstm_hidden]."""
    masks = {}
    if cfg.gcn_dropout > 0.0 and cfg.gcn_layers > 1:
        shape = (cfg.gcn_layers - 1, w, n, cfg.hidden_channels)
        masks["encoder"] = draw_mask(generator, shape, cfg.gcn_dropout, device)
    if cfg.lstm_dropout > 0.0:
        if cfg.lstm_layers > 1:
            shape = (cfg.lstm_layers - 1, w, n, cfg.lstm_hidden)
            masks["lstm"] = draw_mask(generator, shape, cfg.lstm_dropout, device)
        masks["head"] = draw_mask(
            generator, (n, cfg.lstm_hidden), cfg.lstm_dropout, device
        )
    return masks


def apply_hybrid(
    params: HybridModel,
    a_hat: torch.Tensor,
    x: torch.Tensor,
    koppen_code,
    cfg: ModelConfig,
    *,
    train: bool = False,
    generator: torch.Generator | None = None,
    masks: dict | None = None,
) -> torch.Tensor:
    """Forward pass.

    Args:
      a_hat: [N, N] dense normalized adjacency (padded), float32.
      x: [..., W, N, 16] window features (12 z-scored weather + 4 time);
        leading window-batch dims fold into the encoder's time slices and
        the LSTM's rows. Train mode takes one window [W, N, 16] or a batch
        [B, W, N, 16].
      koppen_code: int climate class (0 = unknown/padding).
      generator: draws the train-mode dropout masks (`hybrid_masks`, per
        window) when `masks` is not given; with neither, train mode has no
        dropout.
      masks: {"encoder", "lstm", "head"} int8 masks (any may be absent),
        one window's, with a leading B axis for a window batch.
    Returns:
      [..., H, N, 12] multi-step forecasts in normalized units.
    """
    if cfg.lstm_wavefront:
        raise NotImplementedError(
            "model.lstm_wavefront selects an LSTM route that is not ported"
        )
    dtype = resolve_dtype(cfg.compute_dtype)
    lead = x.shape[:-3]
    w, n = x.shape[-3], x.shape[-2]

    masks = train_masks(cfg, x, train, generator, masks, hybrid_masks)
    if train and x.dim() == 4:
        # Per-window masks, folded as the batch folds at each site.
        folds = {"encoder": fold_slice_masks, "lstm": fold_row_masks,
                 "head": lambda m: m.reshape(-1, m.shape[-1])}
        masks = {k: folds[k](m) for k, m in masks.items()}

    h = apply_encoder(
        params.encoder, a_hat, koppen_features(params, x, koppen_code), cfg,
        train=train, masks=masks.get("encoder"),
    )
    if cfg.stop_base_gradients:
        h = h.detach()
    # [..., W, N, hidden] -> [(...)*N, W, hidden]: nodes (of every window)
    # become the LSTM's rows, row b*N + node.
    h = h.transpose(-3, -2).reshape(-1, w, h.shape[-1])
    if cfg.use_pallas_lstm and (not train or cfg.lstm_dropout == 0.0):
        # The eval stack's kernel (row 20): no dropout to apply.
        feat = fused_lstm_last_hidden(params.lstm.layers, h, compute_dtype=dtype)
    else:
        feat = apply_lstm(
            params.lstm, h, train=train, masks=masks.get("lstm"),
            dropout_rate=cfg.lstm_dropout, compute_dtype=dtype, kernel=cfg.lstm_kernel,
        )
    if masks.get("head") is not None:
        feat = apply_mask(feat, masks["head"], 1.0 - cfg.lstm_dropout)
    out = apply_dense(params.head, feat, compute_dtype=dtype)  # [rows, H*12]
    out = out.reshape(*lead, n, cfg.horizon, cfg.num_weather_vars)
    return out.transpose(-3, -2)  # [..., H, N, 12]
