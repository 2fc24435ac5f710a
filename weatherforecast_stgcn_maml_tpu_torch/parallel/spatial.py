"""Node-sharded (spatial) model parallelism for both model families.

Counterpart of `weatherforecast_stgcn_maml_tpu/parallel/spatial.py`. Each
rank of an sp group holds NL = N / sp of the padded nodes: its rows of the
window features, of the adjacency ([NL, N]) and of the node mask. Every
dense layer, LSTM step and the head are node-local; a graph convolution
needs every node's transformed features, so each GCN layer all-gathers
h @ W over the group (the only communication: with the transform applied
before the gather that is the least any node-sharded GCN must exchange),
and the masked loss ends with one all-reduce.

The encoder runs node-major ([NL, W, C], see ops/fused_gcn_shard.py): on
the sandwich route (rows 12-13) on a CUDA tensor in float32 / bfloat16
when `model.use_pallas_gcn`, else on the plain layerwise route.

Dropout: each rank draws masks for its own NL rows only (full-N masks per
rank would put back the per-device memory the sp axis removes), from a
`torch.Generator` of its own: `shard_generator(key, sp_index)` seeds it
from the caller's key (a tuple of ints: the JAX rng's counterpart) and
the rank's sp index, as JAX folds the axis index into its key. One hybrid
forward draws, in order, the encoder masks [gcn_layers - 1, NL, W, hid]
(node-major), the LSTM's [lstm_layers - 1, W, NL, H] (time-major) and the
head's [NL, H]; one standalone-STGCN forward draws the encoder masks
[gcn_layers, NL, W, hid] (after every conv).
"""

from __future__ import annotations

import dataclasses

import torch

from weatherforecast_stgcn_maml_tpu_torch.config import ModelConfig
from weatherforecast_stgcn_maml_tpu_torch.models.common import (
    apply_dense,
    apply_mask,
    as_operand,
    draw_mask,
    resolve_dtype,
)
from weatherforecast_stgcn_maml_tpu_torch.models.hybrid import task_params, tasks_lstm_head
from weatherforecast_stgcn_maml_tpu_torch.models.lstm import apply_lstm, lstm_wavefront
from weatherforecast_stgcn_maml_tpu_torch.models.stgcn import koppen_features
from weatherforecast_stgcn_maml_tpu_torch.ops.fused_gcn_shard import gcn_shard_encoder
from weatherforecast_stgcn_maml_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_nodes,
    all_reduce_sum,
    all_reduce_tensors,
    node_rows,
    shard_generator,
)


def local_masks(cfg: ModelConfig, generator, w: int, nl: int, device) -> dict:
    """This rank's dropout masks of one train forward (see the module
    docstring for their order and layouts); {} without a generator."""
    if generator is None:
        return {}
    masks = {}
    if cfg.family == "stgcn":
        if cfg.gcn_dropout > 0.0:
            masks["encoder"] = draw_mask(
                generator, (cfg.gcn_layers, nl, w, cfg.hidden_channels), cfg.gcn_dropout,
                device)
        return masks
    if cfg.gcn_dropout > 0.0 and cfg.gcn_layers > 1:
        masks["encoder"] = draw_mask(
            generator, (cfg.gcn_layers - 1, nl, w, cfg.hidden_channels), cfg.gcn_dropout, device)
    if cfg.lstm_dropout > 0.0:
        if cfg.lstm_layers > 1:
            masks["lstm"] = draw_mask(
                generator, (cfg.lstm_layers - 1, w, nl, cfg.lstm_hidden), cfg.lstm_dropout,
                device)
        masks["head"] = draw_mask(generator, (nl, cfg.lstm_hidden), cfg.lstm_dropout, device)
    return masks


def psum_masked_mse(preds_local, targets_local, mask_local, group) -> torch.Tensor:
    """Node-sharded `models.losses.masked_mse`: local partial sums, one
    all-reduce. masked_mse([H, N, C]) = sum(se * mask) / (H * C *
    max(sum(mask), 1)); both sums distribute over node shards.

    The value is the whole loss, the same on every rank (for reporting and
    the sampler). Its backward, through `all_reduce_sum`, starts each rank
    from its own share, num_r / (max(cnt, 1) * H * C) with the all-reduced
    count: backpropagating the summed value on every rank would count the
    gradient sp times over (JAX gets this from psum's transpose)."""
    se = torch.square(preds_local - targets_local) * mask_local[:, None]
    tot = all_reduce_sum(torch.stack([se.sum(), mask_local.sum().to(se.dtype)]), group)
    scale = preds_local.shape[0] * preds_local.shape[-1]
    return tot[0] / (torch.clamp(tot[1], min=1.0) * scale)


def _spatial_encoder(layers, a_rows, h_local, cfg: ModelConfig, group, masks=None):
    """GCN stack over node-sharded activations: h_local [NL, W, C_in]
    node-major, a_rows [NL, N] -> [NL, W, hidden]. `masks` (int8 [n, NL, W,
    hidden]) drop the outputs of layers 0..n-1."""
    dtype = resolve_dtype(cfg.compute_dtype)
    keep = 1.0 - cfg.gcn_dropout
    if cfg.use_pallas_gcn and h_local.device.type == "cuda" and dtype != torch.float64:
        return gcn_shard_encoder(layers, a_rows, h_local, group, masks=masks, keep=keep,
                                 compute_dtype=dtype)
    nl, w, _ = h_local.shape
    n = a_rows.shape[1]
    h = h_local
    for l, layer in enumerate(layers):
        hw = torch.matmul(as_operand(h, dtype), as_operand(layer.w, dtype))
        # One all-gather per layer: [NL, W, C_out] -> [N, W, C_out].
        hw_full = all_gather_nodes(hw, group)
        h = torch.matmul(
            as_operand(a_rows, dtype), as_operand(hw_full, dtype).reshape(n, -1)
        ).reshape(nl, w, -1) + layer.b
        h = torch.relu(h)
        if masks is not None and l < masks.shape[0]:
            h = apply_mask(h, masks[l], keep)
    return h


def node_local(cfg: ModelConfig) -> ModelConfig:
    """`cfg` as the JAX package's node-local forward reads it: the LSTM is
    `apply_lstm`'s whatever `model.lstm_wavefront` says (the shardmap meta
    step, the spatial forward and train step)."""
    return dataclasses.replace(cfg, lstm_wavefront=False) if cfg.lstm_wavefront else cfg


def hybrid_local_forward(
    params, a_rows, x_local, koppen, cfg: ModelConfig, group, *, train: bool = False,
    generator: torch.Generator | None = None, masks: dict | None = None,
) -> torch.Tensor:
    """The hybrid forward on this rank's node rows: x_local [W, NL, C],
    a_rows [NL, N] -> [H, NL, 12]; the stgcn family goes to
    `stgcn_local_forward`.

    In train mode the dropout masks are `masks` (this rank's, as
    `local_masks` lays them out) or drawn from `generator`; with neither
    there is no dropout. The fused LSTM kernels run per rank: the node axis
    is the LSTM's row axis. `cfg.lstm_wavefront` selects the wavefront
    LSTM, as `models.hybrid.apply_hybrid` does (the GSPMD step, whose JAX
    counterpart runs models/hybrid.py); the routes whose JAX counterpart is
    the node-local forward, which knows no wavefront, pass
    `node_local(cfg)`."""
    if cfg.family != "hybrid":
        return stgcn_local_forward(params, a_rows, x_local, koppen, cfg, group, train=train,
                                   generator=generator, masks=masks)
    w, nl = x_local.shape[:2]
    dtype = resolve_dtype(cfg.compute_dtype)
    if not train:
        masks = {}
    elif masks is None:
        masks = local_masks(cfg, generator, w, nl, x_local.device)
    h = koppen_features(params, x_local, koppen).transpose(0, 1)  # [NL, W, C_in]
    h = _spatial_encoder(params.encoder.layers, a_rows, h, cfg, group, masks.get("encoder"))
    if cfg.stop_base_gradients:
        h = h.detach()
    if cfg.lstm_wavefront:
        feat = lstm_wavefront(params.lstm, h, masks=masks.get("lstm"),
                              keep=1.0 - cfg.lstm_dropout if "lstm" in masks else 1.0,
                              compute_dtype=dtype)
    else:
        feat = apply_lstm(
            params.lstm, h.contiguous(), train=train, masks=masks.get("lstm"),
            dropout_rate=cfg.lstm_dropout, compute_dtype=dtype, kernel=cfg.lstm_kernel,
        )
    if masks.get("head") is not None:
        feat = apply_mask(feat, masks["head"], 1.0 - cfg.lstm_dropout)
    out = apply_dense(params.head, feat, compute_dtype=dtype)
    return out.reshape(nl, cfg.horizon, cfg.num_weather_vars).transpose(0, 1)


def hybrid_local_forward_tasks(
    params: dict, a_rows, x_local, koppen_code, cfg: ModelConfig, group, *,
    masks: dict | None = None,
) -> torch.Tensor:
    """Train-mode forward of V tasks at their own parameters on this rank's
    node rows, the node-sharded `models.hybrid.apply_hybrid_tasks`:
    params {name: [V, ...]}, a_rows [V, NL, N], x_local [V, W, NL, C],
    koppen_code [V] -> [V, H, NL, 12]. `masks` {"encoder", "lstm",
    "head"}: each task's `local_masks`, stacked on a leading V axis (any
    may be absent).

    Per task the node-sharded encoder (`_spatial_encoder`: rows 12-13 on a
    card, one all-gather a layer; the JAX package's vmap of them runs the
    tasks one after another too); then every task's LSTM stack over its NL
    rows in one launch each way (rows 16-17) and the heads as one product
    (`tasks_lstm_head`)."""
    masks = masks or {}
    nv, w, nl = x_local.shape[:3]
    koppen = params["koppen"][torch.arange(nv, device=koppen_code.device), koppen_code]
    feats = []
    for v in range(nv):
        task = task_params(params, v, cfg.gcn_layers, koppen)
        h = koppen_features(task, x_local[v], v).transpose(0, 1)  # [NL, W, C_in]
        feats.append(_spatial_encoder(task.encoder.layers, a_rows[v], h, cfg, group,
                                      masks["encoder"][v] if "encoder" in masks else None))
    h = torch.stack(feats)  # [V, NL, W, hidden]
    if cfg.stop_base_gradients:
        h = h.detach()
    out = tasks_lstm_head(params, h, {k: masks[k] for k in ("lstm", "head") if k in masks}, cfg)
    return out.reshape(nv, nl, cfg.horizon, cfg.num_weather_vars).transpose(1, 2)


def stgcn_local_forward(
    params, a_rows, x_local, koppen, cfg: ModelConfig, group, *, train: bool = False,
    generator: torch.Generator | None = None, masks: dict | None = None,
) -> torch.Tensor:
    """The standalone STGCN forward (`models.stgcn.apply_stgcn_forecaster`)
    on this rank's node rows: x_local [W, NL, C], a_rows [NL, N] ->
    [H, NL, 12]. The node-sharded encoder (one all-gather a layer, dropout
    after every conv in train mode), then the dense head on the last time
    slice, which is node-local. Masks as `hybrid_local_forward` takes
    them (`local_masks`' layout)."""
    if cfg.family != "stgcn":
        raise ValueError(f"unknown model family {cfg.family!r} for the node-sharded forward")
    w, nl = x_local.shape[:2]
    if not train:
        masks = {}
    elif masks is None:
        masks = local_masks(cfg, generator, w, nl, x_local.device)
    h = koppen_features(params, x_local, koppen).transpose(0, 1)  # [NL, W, C_in]
    h = _spatial_encoder(params.encoder.layers, a_rows, h, cfg, group, masks.get("encoder"))
    out = apply_dense(params.head, h[:, -1], compute_dtype=resolve_dtype(cfg.compute_dtype))
    return out.reshape(nl, cfg.horizon, cfg.num_weather_vars).transpose(0, 1)


def _local_inputs(mesh: Mesh, a_hat, x, *rest):
    """This rank's rows: a_hat [N, N] -> [NL, N], x [W, N, C] -> [W, NL, C],
    then each of `rest` ([H, N, C] windows or an [N] mask)."""
    return (node_rows(a_hat, 0, mesh), node_rows(x, -2, mesh),
            *(node_rows(t, -2 if t.dim() > 1 else -1, mesh) for t in rest))


def make_spatial_forward(model_cfg: ModelConfig, mesh: Mesh):
    """Node-sharded forward (inference): `fwd(params, a_hat, x,
    koppen) -> this rank's [H, NL, 12]` from the full a_hat [N, N] and
    window x [W, N, C] (each rank keeps its rows; rank r of the sp group
    holds rows r * NL ... (r + 1) * NL - 1). Dropout is off."""

    @torch.no_grad()
    def fwd(params, a_hat, x, koppen):
        a_rows, x_local = _local_inputs(mesh, a_hat, x)
        return hybrid_local_forward(params, a_rows, x_local, koppen, node_local(model_cfg),
                                    mesh.sp_group)

    return fwd


def make_spatial_train_step(model_cfg: ModelConfig, mesh: Mesh, tx):
    """Node-sharded training step: `step(state, x, y, a_hat, node_mask,
    koppen, lr, key) -> (state, loss)` on one window (x [W, N, C], y
    [H, N, 12], the full arrays; each rank cuts its rows).

    Forward and backward run on this rank's rows with per-rank dropout
    masks (`shard_generator(key, sp_index)`, None = no dropout); the
    parameter gradients are the sum over the sp group of every rank's
    partial; then `tx` (train/optimizers.py's protocol, `update(grads,
    opt_state, params, lr)`) updates the replicated parameters the same way
    on every rank. `state` is a train.supervised.SupervisedState."""
    from weatherforecast_stgcn_maml_tpu_torch.train.supervised import SupervisedState

    def step(state, x, y, a_hat, node_mask, koppen, lr, key):
        named = list(state.params.named_parameters())
        a_rows, x_local, y_local, mask_local = _local_inputs(mesh, a_hat, x, y, node_mask)
        gen = shard_generator(key, mesh.sp_index, x.device)
        preds = hybrid_local_forward(state.params, a_rows, x_local, koppen,
                                     node_local(model_cfg), mesh.sp_group, train=True,
                                     generator=gen)
        loss = psum_masked_mse(preds, y_local, mask_local, mesh.sp_group)
        grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for (_, p), g in zip(named, grads)]
        grads = all_reduce_tensors(grads, mesh.sp_group)
        opt_state = tx.update(dict(zip((k for k, _ in named), grads)), state.opt_state,
                              dict(named), lr)
        return SupervisedState(state.params, opt_state), loss.detach()

    return step


def spatial_mse(mesh: Mesh):
    """Node-sharded masked MSE from full [H, N, C] predictions and targets
    and the [N] node mask: each rank sums its rows, one all-reduce."""

    def mse(preds, targets, node_mask):
        return psum_masked_mse(node_rows(preds, -2, mesh), node_rows(targets, -2, mesh),
                               node_rows(node_mask, -1, mesh), mesh.sp_group)

    return mse
