"""Export the port's parameters to the reference `.pt` schema.

Counterpart of `weatherforecast_stgcn_maml_tpu/utils/torch_export.py` and
the inverse of `utils/torch_import.py`: a model meta-trained or adapted
here goes back to a reference user as a checkpoint their engines load,
written with `torch.save` in the reference's key layout (meta; adapted
with the normalization `stats`).

Mapping (port -> reference), the importer's transposed:
  * `encoder.layers.{i}.w` [in, out] -> `base_stgcn.conv{i+1}.lin.weight`
    [out, in], `b` -> `base_stgcn.conv{i+1}.bias`;
  * `lstm.layers.{k}.wx` [in, 4H] -> `lstm.weight_ih_l{k}` [4H, in], `wh`
    -> `weight_hh_l{k}`; a fused bias `b` -> `bias_ih_l{k}` = b and
    `bias_hh_l{k}` = zeros (torch adds them, so the sum is kept); split
    biases `b_ih` / `b_hh` round-trip exactly;
  * `head.w` / `head.b` -> `output_layer.weight` (transposed) / `.bias`;
  * `koppen` [31, 8] -> `koppen_embed_state_dict["embedding.weight"]`.

The reference STGCN's own `output_layer`, dead weight in the hybrid but
present in its state dict, is written as zeros so that a strict
`load_state_dict` on the reference side succeeds.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from weatherforecast_stgcn_maml_tpu_torch.config import ModelConfig

EXPORTED_BY = "weatherforecast_stgcn_maml_tpu_torch"


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", torch.float32).contiguous().clone()


def state_dicts_from_params(params: Mapping[str, torch.Tensor], cfg: ModelConfig):
    """The hybrid model's state_dict -> (hybrid_state_dict,
    koppen_state_dict) of float32 CPU tensors in the reference's layout."""
    hybrid: dict[str, torch.Tensor] = {}
    for i in range(cfg.gcn_layers):
        hybrid[f"base_stgcn.conv{i + 1}.lin.weight"] = _f32(
            params[f"encoder.layers.{i}.w"].t())
        hybrid[f"base_stgcn.conv{i + 1}.bias"] = _f32(params[f"encoder.layers.{i}.b"])
    out_dim = cfg.num_weather_vars * cfg.horizon
    hybrid["base_stgcn.output_layer.weight"] = torch.zeros(
        (out_dim, cfg.hidden_channels), dtype=torch.float32)
    hybrid["base_stgcn.output_layer.bias"] = torch.zeros(out_dim, dtype=torch.float32)
    for l in range(cfg.lstm_layers):
        pre = f"lstm.layers.{l}."
        hybrid[f"lstm.weight_ih_l{l}"] = _f32(params[pre + "wx"].t())
        hybrid[f"lstm.weight_hh_l{l}"] = _f32(params[pre + "wh"].t())
        if pre + "b" in params:
            b = _f32(params[pre + "b"])
            hybrid[f"lstm.bias_ih_l{l}"] = b
            hybrid[f"lstm.bias_hh_l{l}"] = torch.zeros_like(b)
        else:
            hybrid[f"lstm.bias_ih_l{l}"] = _f32(params[pre + "b_ih"])
            hybrid[f"lstm.bias_hh_l{l}"] = _f32(params[pre + "b_hh"])
    hybrid["output_layer.weight"] = _f32(params["head.w"].t())
    hybrid["output_layer.bias"] = _f32(params["head.b"])
    koppen = {"embedding.weight": _f32(params["koppen"])}
    return hybrid, koppen


def export_torch_checkpoint(
    path: str,
    params: Mapping[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    stats=None,
    region: tuple | None = None,
    region_name: str | None = None,
    extra_meta: dict | None = None,
) -> str:
    """Write a reference-schema `.pt` checkpoint: with `stats` / `region*`
    the adapted schema, otherwise the meta schema (without the reference's
    optimizer and scheduler states, which it never reloads)."""
    hybrid_sd, koppen_sd = state_dicts_from_params(params, cfg)
    total_params = int(sum(v.numel() for v in hybrid_sd.values())
                       + sum(v.numel() for v in koppen_sd.values()))
    ckpt: dict = {
        "hybrid_model_state_dict": hybrid_sd,
        "koppen_embed_state_dict": koppen_sd,
        "model_version": "5.0",
        "total_params": total_params,
        "config": {
            "input_channels": cfg.in_channels,
            "hidden_channels": cfg.hidden_channels,
            "output_channels": cfg.num_weather_vars,
            "window_size": cfg.window,
            "forecast_horizon": cfg.horizon,
        },
        "hybrid_config": {
            "lstm_hidden_size": cfg.lstm_hidden,
            "lstm_num_layers": cfg.lstm_layers,
            "lstm_dropout": cfg.lstm_dropout,
        },
        "exported_by": EXPORTED_BY,
    }
    if stats is not None:
        sd = stats.to_dict() if hasattr(stats, "to_dict") else dict(stats)
        ckpt["stats"] = {
            "mean": np.asarray(sd["mean"], np.float32),
            "std": np.asarray(sd["std"], np.float32),
        }
    if region is not None:
        ckpt["region"] = tuple(region)
        ckpt["adaptation_type"] = "v5_regional_adaptation_adaptive"
        ckpt["climate_type"] = "Adapted_Region"
    if region_name is not None:
        ckpt["region_name"] = region_name
    if extra_meta:
        ckpt.update(extra_meta)
    torch.save(ckpt, path)
    return path
