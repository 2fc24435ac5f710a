"""Eval forward over a window batch, and the serving `predict` built on it."""

from __future__ import annotations

import torch

from weatherforecast_stgcn_maml_tpu_torch.config import ModelConfig
from weatherforecast_stgcn_maml_tpu_torch.models.registry import apply_model


def batched_forward(params, a_hat, x, koppen, model_cfg: ModelConfig) -> torch.Tensor:
    """The model's eval forward over a [B, W, N, C] window batch ->
    [B, H, N, 12].

    The weights are shared across windows, so the batch folds into the
    encoder's slices and the LSTM's rows: one kernel launch each for the
    whole batch.
    """
    return apply_model(params, a_hat, x, koppen, model_cfg)


def make_predict(model_cfg: ModelConfig):
    """Build `predict(params, x, a_hat, koppen) -> [B, H, N, 12]` (eval mode,
    no autograd)."""

    @torch.inference_mode()
    def predict(params, x, a_hat, koppen):
        return batched_forward(params, a_hat, x, koppen, model_cfg)

    return predict
