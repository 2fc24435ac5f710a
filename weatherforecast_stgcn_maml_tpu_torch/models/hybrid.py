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
from weatherforecast_stgcn_maml_tpu_torch.models.lstm import apply_lstm, init_lstm, lstm_wavefront
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
        the LSTM's rows (a train-mode batch under `_VBATCH` without
        `_ROWFOLD` runs its LSTM one window a task instead,
        `window_batch_unfolded`). Train mode takes one window [W, N, 16] or
        a batch [B, W, N, 16].
      koppen_code: int climate class (0 = unknown/padding).
      generator: draws the train-mode dropout masks (`hybrid_masks`, per
        window) when `masks` is not given; with neither, train mode has no
        dropout.
      masks: {"encoder", "lstm", "head"} int8 masks (any may be absent),
        one window's, with a leading B axis for a window batch.
    Returns:
      [..., H, N, 12] multi-step forecasts in normalized units.
    """
    dtype = resolve_dtype(cfg.compute_dtype)
    lead = x.shape[:-3]
    w, n = x.shape[-3], x.shape[-2]

    masks = train_masks(cfg, x, train, generator, masks, hybrid_masks)
    unfolded = train and x.dim() == 4 and window_batch_unfolded(cfg, x.shape[0], n, x.device)
    if train and x.dim() == 4:
        # Per-window masks, folded as the batch folds at each site (the
        # unfolded LSTM takes its masks a window each, as they are).
        folds = {"encoder": fold_slice_masks, "head": lambda m: m.reshape(-1, m.shape[-1]),
                 "lstm": (lambda m: m.contiguous()) if unfolded else fold_row_masks}
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
    elif cfg.lstm_wavefront:
        # Whatever `lstm_kernel` says, in eval mode too, as in the JAX
        # package (row 20 above comes first).
        feat = lstm_wavefront(params.lstm, h, masks=masks.get("lstm"),
                              keep=1.0 - cfg.lstm_dropout if "lstm" in masks else 1.0,
                              compute_dtype=dtype)
    elif unfolded:
        # One window a task, the weights shared: rows 16-17 (`_VBATCH`
        # without `_ROWFOLD`), the window's nodes a task's rows.
        feat = _lstm_tasks(*_shared_lstm_weights(params.lstm.layers, x.shape[0]),
                           h.reshape(x.shape[0], n, w, -1), cfg, masks.get("lstm"),
                           dtype).reshape(-1, cfg.lstm_hidden)
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


def task_params(params: dict, v: int, n_layers: int, koppen: torch.Tensor) -> SimpleNamespace:
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
      `lstm_kernel="xla"`), and the heads task by task.
    """
    if cfg.lstm_kernel not in ("auto", "pallas_stack", "xla") or (
            cfg.use_pallas_lstm and cfg.lstm_dropout == 0.0):
        raise ValueError(
            f"no task-batched forward for lstm_kernel={cfg.lstm_kernel!r} with "
            f"use_pallas_lstm={cfg.use_pallas_lstm}")
    masks = masks or {}
    nv, lead, w, n = x.shape[0], x.shape[1:-3], x.shape[-3], x.shape[-2]
    # Every task's embedding row in one gather: indexing with one task's
    # code (a tensor on the card) would wait for the device.
    koppen = params["koppen"][torch.arange(nv, device=koppen_code.device), koppen_code]
    feats = []
    for v in range(nv):
        task = task_params(params, v, cfg.gcn_layers, koppen)
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
    task_masks = {}
    if "lstm" in masks:
        task_masks["lstm"] = (torch.stack([fold_row_masks(m) for m in masks["lstm"]]) if lead
                              else masks["lstm"].contiguous())
    if "head" in masks:
        task_masks["head"] = masks["head"].reshape(nv, -1, masks["head"].shape[-1])
    out = tasks_lstm_head(params, h, task_masks, cfg)
    out = out.reshape(nv, *lead, n, cfg.horizon, cfg.num_weather_vars)
    return out.transpose(-3, -2)  # [V, (B,) H, N, 12]


def tasks_lstm_head(params: dict, h: torch.Tensor, masks: dict, cfg: ModelConfig) -> torch.Tensor:
    """The LSTM stacks and heads of V tasks at their own parameters (`params`
    {name: [V, ...]}): h [V, R, W, C] (the encoder's features, R rows a
    task) -> [V, R, horizon * 12]. Every task's stack in one launch each
    way (rows 16-17; their plain version under `lstm_kernel="xla"`), the
    heads task by task. masks: "lstm" [V, L-1, W, R, H], "head"
    [V, R, H], either may be absent. `apply_hybrid_tasks` and the node-
    sharded `parallel.spatial.hybrid_local_forward_tasks` end here."""
    dtype = resolve_dtype(cfg.compute_dtype)
    nv, n_layers = h.shape[0], cfg.lstm_layers
    wcat = [torch.cat([params[f"lstm.layers.{l}.wx"], params[f"lstm.layers.{l}.wh"]], dim=1)
            for l in range(n_layers)]
    wcatr = (torch.stack(wcat[1:], dim=1) if n_layers > 1
             else wcat[0].new_zeros((nv, 0, 2 * cfg.lstm_hidden, 4 * cfg.lstm_hidden)))
    b2d = torch.stack([
        lstm_bias({k.rsplit(".", 1)[1]: p for k, p in params.items()
                   if k.startswith(f"lstm.layers.{l}.")}) for l in range(n_layers)], dim=1)
    feat = _lstm_tasks(wcat[0], wcatr, b2d, h, cfg, masks.get("lstm"), dtype)
    if "head" in masks:
        feat = apply_mask(feat, masks["head"], 1.0 - cfg.lstm_dropout)
    # The heads task by task, each the serial route's product (a batched
    # product may round otherwise): a task's output is bitwise its own call's.
    return torch.stack([
        torch.matmul(as_operand(feat[v], dtype), as_operand(params["head.w"][v], dtype))
        + params["head.b"][v] for v in range(nv)])


def _shared_lstm_weights(layers, nv: int):
    """(wcat0 [V, C + H, 4H], wcatr [V, L-1, 2H, 4H], b2d [V, L, 4H]) of
    one stack's layers broadcast over V tasks that share them: each array
    built once and expanded, task stride 0 (no copy a task), so the
    weights' gradients come back summed over the tasks."""
    hidden = layers[0].wh.shape[0]
    wcat = [torch.cat([layer.wx, layer.wh]) for layer in layers]
    wcatr = (torch.stack(wcat[1:]) if len(wcat) > 1
             else wcat[0].new_zeros((0, 2 * hidden, 4 * hidden)))
    b2d = torch.stack([layer.b for layer in layers])
    return tuple(t.expand(nv, *t.shape) for t in (wcat[0], wcatr, b2d))


def _lstm_tasks(wcat0, wcatr, b2d, h, cfg: ModelConfig, masks, dtype) -> torch.Tensor:
    """V tasks' stacks, h [V, R, W, C] -> [V, R, H]: `lstm_stack_train_tasks`
    (rows 16-17), or its plain version under `lstm_kernel="xla"`."""
    keep = 1.0 - cfg.lstm_dropout if masks is not None else 1.0
    if cfg.lstm_kernel == "xla":
        return lstm_stack_tasks_plain(h, wcat0, wcatr, b2d, masks, keep, dtype)
    return lstm_stack_train_tasks(h, wcat0, wcatr, b2d, masks=masks, keep=keep,
                                  compute_dtype=dtype)


def lockstep_stack(model_cfg: ModelConfig) -> str | None:
    """The LSTM stack a task-batched train forward runs (`apply_hybrid_tasks`),
    or None where the model's tasks (or a fleet's regions) run one after
    another. Under `_VBATCH`, the hybrid family on the merged fused stack
    ("fused": where the JAX flag sends a vmap over tasks to its task-batched
    kernels, see ops/fused_lstm_stack.py) and on the plain stack ("plain":
    `lstm_kernel="xla"`, the same arithmetic with no kernel, so that the two
    compare with the same dropout masks). None under `model.lstm_wavefront`:
    the wavefront has no task-batched kernel (the JAX flag acts only on the
    fused stack's vmap rules)."""
    if not fused_lstm_stack._VBATCH or model_cfg.family != "hybrid" or model_cfg.lstm_wavefront:
        return None
    if model_cfg.use_pallas_lstm and model_cfg.lstm_dropout == 0.0:
        return None  # the train-mode row 20 route
    if model_cfg.lstm_kernel == "xla":
        return "plain"
    if model_cfg.lstm_kernel not in ("auto", "pallas_stack") or not fused_lstm_stack._MERGED_GATES:
        return None
    return "fused"


def lockstep_planned(model_cfg: ModelConfig, tasks: int, rows: int, device) -> bool:
    """Whether the fused stack's recurrences have a cluster plan for `tasks`
    tasks of `rows` rows (`stack_planned`), as the JAX package's
    task-batched kernels run only where `vbatch_supported` holds."""
    return fused_lstm_stack.stack_planned(model_cfg.lstm_hidden, rows,
                                          resolve_dtype(model_cfg.compute_dtype), device, tasks)


def window_batch_unfolded(cfg: ModelConfig, windows: int, nodes: int, device) -> bool:
    """Whether a train-mode forward over a batch of `windows` windows (the
    adaptation step's) runs its LSTM unfolded, one window a task with the
    weights shared (rows 16-17, `_lstm_tasks` over `_shared_lstm_weights`):
    under `_VBATCH` with `_ROWFOLD` off, more than one window, the fused
    stack (`lockstep_stack`) and a plan for the windows' rows
    (`lockstep_planned`), as the JAX package's vmap over windows reaches
    its task-batched kernels there. Elsewhere the windows fold into the
    LSTM's rows (rows 4-5 at B x N rows, JAX's `_ROWFOLD` route); where only
    the plan fails it folds too, counted in
    `window_batch_unfolded.folded_fallbacks`, as the JAX package falls back
    where `vbatch_supported` fails."""
    if fused_lstm_stack._ROWFOLD or windows < 2 or lockstep_stack(cfg) != "fused":
        return False
    if lockstep_planned(cfg, windows, nodes, device):
        return True
    window_batch_unfolded.folded_fallbacks += 1
    return False


window_batch_unfolded.folded_fallbacks = 0  # unfolded window batches folded for want of a plan
