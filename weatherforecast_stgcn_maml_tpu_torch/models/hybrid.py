"""Hybrid STGCN->LSTM forecaster, the flagship model.

The GCN encoder runs per time slice, then every node's sequence of encoder
features goes through the stacked LSTM, and a dense head maps the last
hidden state to H steps x 12 variables. The Koppen climate embedding is
looked up inside the model from the integer class code.

Module tree (the JAX pytree's names):
  encoder.layers.{l}.{w,b}, lstm.layers.{l}.{wx,wh,b}, head.{w,b}, koppen
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
from torch import nn

from weatherforecast_stgcn_maml_tpu_torch.config import ModelConfig
from weatherforecast_stgcn_maml_tpu_torch.models.common import (
    apply_dense,
    apply_mask,
    as_operand,
    draw_mask,
    fold_row_masks,
    fold_slice_masks,
    init_dense,
    lstm_bias,
    resolve_dtype,
    train_masks,
)
from weatherforecast_stgcn_maml_tpu_torch.models.lstm import apply_lstm, init_lstm
from weatherforecast_stgcn_maml_tpu_torch.models.stgcn import (
    apply_encoder,
    init_encoder,
    koppen_features,
)
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm_stack
from weatherforecast_stgcn_maml_tpu_torch.ops.fused_lstm import fused_lstm_last_hidden
from weatherforecast_stgcn_maml_tpu_torch.ops.fused_lstm_stack import (
    lstm_stack_plain,
    lstm_stack_tasks_plain,
    lstm_stack_train_tasks,
)


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
        # The eval stack's kernel (row 20): no dropout to apply. Where the
        # card's schedule does not take the stack (eval: `eval_planned`;
        # train mode: `stack_planned`, row 15's backward), the plain stack,
        # counted, as JAX's `fused_lstm_last_hidden` takes its XLA route
        # where `fits_vmem` fails.
        rows, c_in = h.shape[0], h.shape[-1]
        if (fused_lstm_stack.stack_planned(cfg.lstm_hidden, rows, dtype, h.device, c_in=c_in)
                if train else
                fused_lstm_stack.eval_planned(c_in, cfg.lstm_hidden, rows, dtype, h.device)):
            feat = fused_lstm_last_hidden(params.lstm.layers, h, compute_dtype=dtype)
        else:
            fused_lstm_stack.lstm_stack_train.plain_routes += 1
            feat = lstm_stack_plain(params.lstm.layers, h, dtype)
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


def _task_params(params: dict, v: int, n_layers: int, koppen: torch.Tensor) -> SimpleNamespace:
    """Task v's encoder layers as apply_encoder reads them, and `koppen`,
    every task's Koppen embedding row [V, koppen_dim], for
    koppen_features(task, x, v)."""
    layers = [SimpleNamespace(w=params[f"encoder.layers.{l}.w"][v],
                              b=params[f"encoder.layers.{l}.b"][v]) for l in range(n_layers)]
    return SimpleNamespace(encoder=SimpleNamespace(layers=layers), koppen=koppen)


def apply_hybrid_tasks(
    params: dict, a_hat: torch.Tensor, x: torch.Tensor, koppen_code: torch.Tensor,
    cfg: ModelConfig, *, masks: dict | None = None,
) -> torch.Tensor:
    """Train-mode forward of V tasks at once, each at its own parameters.

    Args:
      params: {name: [V, ...]}, the names of `named_parameters()`, every
        leaf with a leading task axis (the layout jax.vmap gives the JAX
        package's tree over the tasks of a micro-batch, or over the regions
        of a fleet).
      a_hat: [V, N, N]; x: [V, W, N, 16], one window a task, or [V, B, W,
        N, 16], a batch of B windows a task (a fleet region's batch: its
        windows fold into the task's LSTM rows, row b*N + node, as
        `apply_hybrid` folds a batch); koppen_code: [V].
      masks: {"encoder", "lstm", "head"}, each task's masks of its window
        (`hybrid_masks`), with a leading B axis for a batch, stacked on a
        leading V axis; any may be absent.
    Returns:
      [V, H, N, 12] (or [V, B, H, N, 12]): V calls of
      `apply_hybrid(train=True)` with the same masks. Per task the Koppen
      features and the encoder (its training kernels, rows 6-7, as in the
      JAX package, whose vmap of them runs the tasks one after another);
      then every task's LSTM stack in one launch each way
      (`lstm_stack_train_tasks`, rows 16-17; its plain version under
      `lstm_kernel="xla"`), and the head as one batched product.
    """
    if cfg.lstm_kernel not in ("auto", "pallas_stack", "xla") or (
            cfg.use_pallas_lstm and cfg.lstm_dropout == 0.0):
        raise ValueError(
            f"no task-batched forward for lstm_kernel={cfg.lstm_kernel!r} with "
            f"use_pallas_lstm={cfg.use_pallas_lstm}")
    masks = masks or {}
    dtype = resolve_dtype(cfg.compute_dtype)
    nv, lead, w, n = x.shape[0], x.shape[1:-3], x.shape[-3], x.shape[-2]
    # Every task's embedding row in one gather: indexing with one task's
    # code (a tensor on the card) would wait for the device.
    koppen = params["koppen"][torch.arange(nv, device=koppen_code.device), koppen_code]
    feats = []
    for v in range(nv):
        task = _task_params(params, v, cfg.gcn_layers, koppen)
        enc_masks = masks["encoder"][v] if "encoder" in masks else None
        if lead and enc_masks is not None:
            enc_masks = fold_slice_masks(enc_masks)
        h = apply_encoder(task.encoder, a_hat[v], koppen_features(task, x[v], v),
                          cfg, train=True, masks=enc_masks)
        # [(B,) W, N, hidden] -> [(B*)N, W, hidden]: the nodes (of every
        # window) are the LSTM's rows.
        feats.append(h.transpose(-3, -2).reshape(-1, w, h.shape[-1]))
    h = torch.stack(feats)
    if cfg.stop_base_gradients:
        h = h.detach()
    n_layers = cfg.lstm_layers
    wcat = [torch.cat([params[f"lstm.layers.{l}.wx"], params[f"lstm.layers.{l}.wh"]], dim=1)
            for l in range(n_layers)]
    wcatr = (torch.stack(wcat[1:], dim=1) if n_layers > 1
             else wcat[0].new_zeros((nv, 0, 2 * cfg.lstm_hidden, 4 * cfg.lstm_hidden)))
    b2d = torch.stack([
        lstm_bias({k.rsplit(".", 1)[1]: p for k, p in params.items()
                   if k.startswith(f"lstm.layers.{l}.")}) for l in range(n_layers)], dim=1)
    keep = 1.0 - cfg.lstm_dropout
    lstm_masks = masks.get("lstm")
    if lstm_masks is not None:
        lstm_masks = (torch.stack([fold_row_masks(m) for m in lstm_masks]) if lead
                      else lstm_masks.contiguous())
    lstm_keep = keep if lstm_masks is not None else 1.0
    if cfg.lstm_kernel == "xla":
        feat = lstm_stack_tasks_plain(h, wcat[0], wcatr, b2d, lstm_masks, lstm_keep, dtype)
    else:
        feat = lstm_stack_train_tasks(h, wcat[0], wcatr, b2d, masks=lstm_masks, keep=lstm_keep,
                                      compute_dtype=dtype)  # [V, N, lstm_hidden]
    if "head" in masks:
        feat = apply_mask(feat, masks["head"].reshape(nv, -1, masks["head"].shape[-1]), keep)
    out = torch.matmul(as_operand(feat, dtype), as_operand(params["head.w"], dtype))
    out = out + params["head.b"][:, None]
    out = out.reshape(nv, *lead, n, cfg.horizon, cfg.num_weather_vars)
    return out.transpose(-3, -2)  # [V, (B,) H, N, 12]
