"""STGCN backbone: stacked per-timestep graph convolutions + forecast head.

The encoder (conv stack without the head, ReLU after every conv) is shared
with the hybrid model. In train mode dropout follows every conv but the last
(the hybrid's feature extraction) or every conv (the standalone STGCN,
`final_dropout`); its masks are drawn by the caller or from a generator.
"""

from __future__ import annotations

import torch
from torch import nn

from weatherforecast_stgcn_maml_tpu_torch.config import ModelConfig
from weatherforecast_stgcn_maml_tpu_torch.models.common import (
    apply_dense,
    draw_mask,
    fold_slice_masks,
    init_dense,
    resolve_dtype,
    train_masks,
)
from weatherforecast_stgcn_maml_tpu_torch.models.gcn import init_gcn_layer
from weatherforecast_stgcn_maml_tpu_torch.ops.fused_gcn import (
    fused_gcn_stack,
    gcn_stack_plain,
)
from weatherforecast_stgcn_maml_tpu_torch.ops.fused_gcn_train import (
    gcn_stack_train,
    gcn_stack_train_plain,
)


class Encoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


def init_encoder(generator: torch.Generator, cfg: ModelConfig) -> Encoder:
    layers = []
    d_in = cfg.in_channels
    for _ in range(cfg.gcn_layers):
        layers.append(init_gcn_layer(generator, d_in, cfg.hidden_channels))
        d_in = cfg.hidden_channels
    return Encoder(layers)


def apply_encoder(
    params: Encoder,
    a_hat: torch.Tensor,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    train: bool = False,
    masks: torch.Tensor | None = None,
) -> torch.Tensor:
    """Spatial encoder over [..., W, N, C_in] -> [..., W, N, hidden].

    `cfg.use_pallas_gcn` selects the fused stack, the CUDA kernels on a
    card (in train mode the training stack and its backward, also at
    dropout 0, where it computes the same function as the eval stack);
    False runs the plain layerwise route. In train mode the leading dims
    fold into one axis of time slices, and `masks` (int8 {0, 1} [n, slices,
    N, hidden], or None) drop the outputs of layers 0..n-1.
    """
    dtype = resolve_dtype(cfg.compute_dtype)
    if not train:
        if cfg.use_pallas_gcn:
            return fused_gcn_stack(params.layers, a_hat, x, compute_dtype=dtype)
        return gcn_stack_plain(params.layers, a_hat, x, dtype)
    keep = 1.0 - cfg.gcn_dropout
    slices = x.reshape(-1, *x.shape[-2:])
    if cfg.use_pallas_gcn:
        h = gcn_stack_train(
            params.layers, a_hat, slices, masks=masks, keep=keep, compute_dtype=dtype
        )
    else:
        h = gcn_stack_train_plain(params.layers, a_hat, slices, masks, keep, dtype)
    return h.reshape(*x.shape[:-1], h.shape[-1])


class StgcnForecaster(nn.Module):
    """Standalone STGCN with an in-model Koppen embedding (`family="stgcn"`)."""

    def __init__(self, encoder: Encoder, head: nn.Module, koppen: torch.Tensor):
        super().__init__()
        self.encoder = encoder
        self.head = head
        self.koppen = nn.Parameter(koppen)


def init_stgcn_forecaster(generator: torch.Generator, cfg: ModelConfig) -> StgcnForecaster:
    encoder = init_encoder(generator, cfg)
    head = init_dense(
        generator, cfg.hidden_channels, cfg.num_weather_vars * cfg.horizon
    )
    koppen = torch.randn((cfg.koppen_classes, cfg.koppen_dim), generator=generator)
    return StgcnForecaster(encoder, head, koppen)


def koppen_features(params: nn.Module, x: torch.Tensor, koppen_code) -> torch.Tensor:
    """Append the Koppen embedding of `koppen_code` to every node of x
    [..., W, N, C]: -> [..., W, N, C + koppen_dim]."""
    emb = params.koppen[koppen_code].to(x.dtype)
    return torch.cat([x, emb.expand(*x.shape[:-1], emb.shape[-1])], dim=-1)


def apply_stgcn_forecaster(
    params: StgcnForecaster,
    a_hat: torch.Tensor,
    x: torch.Tensor,
    koppen_code,
    cfg: ModelConfig,
    *,
    train: bool = False,
    generator: torch.Generator | None = None,
    masks: dict | None = None,
) -> torch.Tensor:
    """[..., W, N, 16] features + Koppen code -> [..., H, N, 12] forecasts:
    the encoder's last time slice through the dense head.

    Train mode takes one window [W, N, 16] or a batch [B, W, N, 16]; its
    dropout masks are `masks` ({"encoder": [gcn_layers, W, N, hidden]},
    with a leading B axis for a batch) or, without them, drawn from
    `generator` per window (no dropout when both are None).
    """
    dtype = resolve_dtype(cfg.compute_dtype)
    masks = train_masks(cfg, x, train, generator, masks, stgcn_masks)
    if train and x.dim() == 4 and "encoder" in masks:
        masks = {"encoder": fold_slice_masks(masks["encoder"])}
    h = apply_encoder(
        params.encoder, a_hat, koppen_features(params, x, koppen_code), cfg,
        train=train, masks=masks.get("encoder"),
    )
    out = apply_dense(params.head, h[..., -1, :, :], compute_dtype=dtype)
    out = out.reshape(*out.shape[:-1], cfg.horizon, cfg.num_weather_vars)
    return out.transpose(-3, -2)  # [..., H, N, 12]


def stgcn_masks(cfg: ModelConfig, generator, w: int, n: int, device) -> dict:
    """Dropout masks of one standalone-STGCN train forward: after every conv."""
    if cfg.gcn_dropout <= 0.0:
        return {}
    shape = (cfg.gcn_layers, w, n, cfg.hidden_channels)
    return {"encoder": draw_mask(generator, shape, cfg.gcn_dropout, device)}

