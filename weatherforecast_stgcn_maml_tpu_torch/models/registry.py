"""Model-family registry: one init/apply dispatch for every engine.

Families (ModelConfig.family): "hybrid" (models/hybrid.py) and "stgcn"
(models/stgcn.py). Both share the apply signature
  apply(params, a_hat, x, koppen_code, cfg, *, train, generator, masks)
    -> [..., H, N, 12]
"""

from __future__ import annotations

import torch

from weatherforecast_stgcn_maml_tpu_torch.config import ModelConfig
from weatherforecast_stgcn_maml_tpu_torch.models.hybrid import apply_hybrid, init_hybrid
from weatherforecast_stgcn_maml_tpu_torch.models.stgcn import (
    apply_stgcn_forecaster,
    init_stgcn_forecaster,
)

_FAMILIES = {
    "hybrid": (init_hybrid, apply_hybrid),
    "stgcn": (init_stgcn_forecaster, apply_stgcn_forecaster),
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
