"""Model-family registry: one init/apply dispatch for every engine.

Families (ModelConfig.family): "hybrid" (models/hybrid.py) and "stgcn"
(models/stgcn.py). Both share the apply signature
  apply(params, a_hat, x, koppen_code, cfg, *, train, generator, masks)
    -> [..., H, N, 12]
"""

from __future__ import annotations

import torch
from torch import nn

from weatherforecast_stgcn_maml_tpu_torch.config import ModelConfig
from weatherforecast_stgcn_maml_tpu_torch.models.common import train_masks
from weatherforecast_stgcn_maml_tpu_torch.models.hybrid import (
    apply_hybrid,
    hybrid_masks,
    init_hybrid,
)
from weatherforecast_stgcn_maml_tpu_torch.models.lstm import split_lstm_biases
from weatherforecast_stgcn_maml_tpu_torch.models.stgcn import (
    apply_stgcn_forecaster,
    init_stgcn_forecaster,
    stgcn_masks,
)

_FAMILIES = {
    "hybrid": (init_hybrid, apply_hybrid, hybrid_masks),
    "stgcn": (init_stgcn_forecaster, apply_stgcn_forecaster, stgcn_masks),
}


def _family(cfg: ModelConfig):
    try:
        return _FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(
            f"unknown model family {cfg.family!r}; known: {sorted(_FAMILIES)}"
        ) from None


def init_model(
    generator: torch.Generator, cfg: ModelConfig, *, device: torch.device | str = "cpu"
) -> torch.nn.Module:
    """Random float32 parameters drawn from `generator` (a CPU generator),
    moved to `device`."""
    return _family(cfg)[0](generator, cfg).to(device)


def apply_model(
    params, a_hat, x, koppen_code, cfg: ModelConfig, *, train=False,
    generator: torch.Generator | None = None, masks: dict | None = None,
):
    return _family(cfg)[1](
        params, a_hat, x, koppen_code, cfg, train=train, generator=generator,
        masks=masks,
    )


def load_params(model: nn.Module, state_dict) -> None:
    """model.load_state_dict(state_dict), first giving the LSTM layers
    torch's two biases where the state_dict carries them (`b_ih`, `b_hh`,
    as a reference checkpoint does)."""
    if any(k.endswith(".b_ih") for k in state_dict) and hasattr(model, "lstm"):
        split_lstm_biases(model.lstm)
    model.load_state_dict(state_dict)


def draw_masks(cfg: ModelConfig, generator: torch.Generator | None, x: torch.Tensor) -> dict:
    """The dropout masks a train-mode forward of x draws from `generator`
    ({} without one), for passing to `apply_model(..., masks=)` instead."""
    return train_masks(cfg, x, True, generator, None, _family(cfg)[2])


def window_masks(cfg: ModelConfig, generator: torch.Generator | None, w: int, n: int,
                 device) -> dict:
    """One window's dropout masks at W x N nodes, as `draw_masks` draws them
    for a window [W, N, C] ({} without a generator)."""
    return {} if generator is None else _family(cfg)[2](cfg, generator, w, n, device)


class _Bound(nn.Module):
    def __init__(self, model: nn.Module, fn):
        super().__init__()
        self.model, self.fn = model, fn

    def forward(self, *args, **kwargs):
        return self.fn(self.model, *args, **kwargs)


def functional_apply(model: nn.Module, params: dict, fn, *args, **kwargs):
    """fn(model, *args, **kwargs) with the model's parameters taken from
    `params` ({name: tensor}, the names of `model.named_parameters()`), as
    `torch.func.functional_call` runs a module: differentiable w.r.t. those
    tensors under autograd and the torch.func transforms."""
    return torch.func.functional_call(
        _Bound(model, fn), {f"model.{k}": v for k, v in params.items()}, args, kwargs
    )
