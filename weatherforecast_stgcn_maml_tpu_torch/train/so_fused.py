"""The support loss's gradient as a forward-differentiable composition, for
the fused Hessian transpose of second-order MAML (`so_impl="fhvp"`).

`make_grad_loss_fused(model, cfg)` returns grad_loss(q, aux, masks): the
gradient of one inner step's support loss at the parameters q, written as a
manual VJP composition, so that `torch.func.jvp(grad_loss)(q; ct)` is the
Hessian-vector product train/so_grad.py needs:

  pre   Koppen embedding + the GCN encoder on its plain layerwise route (its
        CUDA Function, rows 6-7, is first-order only) + the merged LSTM
        weights, under `torch.func.vjp`;
  stack `fwd_op` (row 4; jvp row 10), ops/fused_lstm_hvp.py;
  post  head dropout, dense head, masked MSE, under `torch.func.vjp`;
  back  `bwd_op` (row 5; jvp row 11), then pre's VJP.

Its value is the gradient of the same stochastic loss the inner step
differentiates: the caller passes that step's dropout masks (encoder, LSTM,
head, as `models.registry.draw_masks` drew them) and they are injected, never
redrawn. The stack ops run the hand-written kernels on a CUDA tensor at
float32 / bfloat16 (a shape they do not take raises) and their plain
versions on a CPU tensor or under float64. The standalone STGCN has no LSTM
stack, and `lstm_kernel="xla"` pins the plain stack: there grad_loss is
`torch.func.grad` of the plain loss, as the JAX package falls back to
jax.grad of its XLA loss. `lstm_kernel="pallas"` (the per-layer recurrence)
and `use_pallas_lstm` take the stack ops here, as in the JAX package
(`fused_hvp_chunk`): their kernels are first-order only. Where no cluster
plan holds the stack's Wh (`fused_lstm_stack.stack_planned`: float32 H >
396, bfloat16 H > 512; rows 10-11's tangent plans share those shared-memory
budgets, with row tiles of at most 8, so they exist wherever those do)
grad_loss is the plain loss's gradient too, as the JAX package takes
jax.grad of its XLA loss where no chunk of its R-kernels fits.

Its node-sharded twin for the dp x sp mesh, the same composition on one
rank's node rows, is parallel/meta_sp.make_local_grad_loss_fused (JAX keeps
it in this module; here it sits in the Parallel layer, above the mesh's
collectives, and takes `_vjp_sandwich` and `_stack_weights` from here).

Counterpart of `weatherforecast_stgcn_maml_tpu/train/so_fused.py`
(`make_grad_loss_fused`, `_vjp_sandwich`). Its row-chunked route
(`hvp_chunk_size` / `chunked_stack_ops`) fits the R-kernels into a TPU
core's VMEM and changes only the order of the weight-gradient sums; the CUDA
kernels stream any row count, so it has no counterpart here.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from weatherforecast_stgcn_maml_tpu_torch.config import ModelConfig
from weatherforecast_stgcn_maml_tpu_torch.models.common import apply_dense, apply_mask, resolve_dtype
from weatherforecast_stgcn_maml_tpu_torch.models.losses import masked_mse
from weatherforecast_stgcn_maml_tpu_torch.models.registry import apply_model, functional_apply
from weatherforecast_stgcn_maml_tpu_torch.models.stgcn import apply_encoder, koppen_features
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm_stack
from weatherforecast_stgcn_maml_tpu_torch.ops.fused_lstm_hvp import bwd_op, fwd_op


def support_loss(model: nn.Module, cfg: ModelConfig, forward=apply_model, mse=masked_mse):
    """loss(q, aux, masks): the masked MSE of one train-mode forward of the
    window aux = (x, y, a_hat, koppen, node_mask) at the parameters q with
    the dropout masks `masks`. `forward` and `mse` are a task route's
    (train/maml.TaskRoute): by default one device's whole window; on a
    dp x sp rank its node rows, the loss summed over sp."""

    def loss(q, aux, masks):
        xb, yb, a_hat, koppen, node_mask = aux
        preds = functional_apply(model, q, forward, a_hat, xb, koppen, cfg,
                                 train=True, masks=masks)
        return mse(preds, yb, node_mask)

    return loss


def plain_route(cfg: ModelConfig) -> ModelConfig:
    """The twice-differentiable route: the plain encoder and LSTM stack. The
    kernel routes' Functions (rows 4-7, 18-20) are first-order only."""
    return dataclasses.replace(cfg, use_pallas_gcn=False, lstm_kernel="xla",
                               use_pallas_lstm=False)


def make_grad_loss_fused(model: nn.Module, cfg: ModelConfig):
    """grad_loss(q, aux, masks) -> {name: gradient}, the gradient of
    `support_loss(model, cfg)` at q, forward-differentiable through the
    second-order stack kernels (see the module docstring)."""
    plain = torch.func.grad(support_loss(model, plain_route(cfg)))
    if cfg.family != "hybrid" or cfg.lstm_kernel == "xla":
        return plain
    dtype = resolve_dtype(cfg.compute_dtype)
    enc_cfg = dataclasses.replace(cfg, use_pallas_gcn=False)
    keep = 1.0 - cfg.lstm_dropout

    def grad_loss(q, aux, masks):
        xb, yb, a_hat, koppen, node_mask = aux
        n = xb.shape[1]
        if not fused_lstm_stack.stack_planned(cfg.lstm_hidden, n, dtype, xb.device):
            fused_lstm_stack.lstm_stack_train.plain_routes += 1
            return plain(q, aux, masks)
        lstm_masks = masks.get("lstm")

        def pre(m):
            h = apply_encoder(m.encoder, a_hat, koppen_features(m, xb, koppen), enc_cfg,
                              train=True, masks=masks.get("encoder"))
            if cfg.stop_base_gradients:
                h = h.detach()
            # h [W, N, hidden] is already the stack's [T, B, C] layout.
            return h, *_stack_weights(m)

        def post(m, feat):
            if "head" in masks:
                feat = apply_mask(feat, masks["head"], keep)
            out = apply_dense(m.head, feat, compute_dtype=dtype)
            preds = out.reshape(n, cfg.horizon, cfg.num_weather_vars).transpose(0, 1)
            return masked_mse(preds, yb, node_mask)

        return _vjp_sandwich(model, q, pre, post, lstm_masks, keep, dtype)

    return grad_loss


def _stack_weights(m):
    """The merged stack's operands of the model m: (b2d [L, 4H], Wcat_0,
    ..., Wcat_{L-1}), Wcat_l = [Wx_l; Wh_l]."""
    layers = m.lstm.layers
    return (torch.stack([lay.b for lay in layers]),
            *(torch.cat([lay.wx, lay.wh]) for lay in layers))


def _vjp_sandwich(model, q, pre, post, lstm_masks, keep, dtype):
    """The gradient at q of post(q, stack(pre(q))) as a manual VJP: pre and
    post under `torch.func.vjp`, the stack through `fwd_op` / `bwd_op`
    (rows 4-5, jvp rows 10-11). pre(m) -> (x [T, B, C], b2d, *wcat);
    post(m, h_last) -> the loss."""
    lstm_keep = keep if lstm_masks is not None else 1.0
    (x_tbc, b2d, *wcat), pre_vjp = torch.func.vjp(
        lambda q: functional_apply(model, q, pre), q)
    h_last, h_all, c_all, gates = fwd_op(x_tbc, wcat, b2d, lstm_masks, lstm_keep, dtype)
    loss, post_vjp = torch.func.vjp(
        lambda q, feat: functional_apply(model, q, post, feat), q, h_last)
    dq_post, dfeat = post_vjp(torch.ones_like(loss))
    dx, dwcat, db = bwd_op(dfeat, x_tbc, h_all, c_all, gates, wcat, lstm_masks,
                           lstm_keep, dtype)
    (dq_pre,) = pre_vjp((dx, db, *dwcat))
    return {k: dq_pre[k] + dq_post[k] for k in q}
