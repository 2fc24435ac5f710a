"""Import a reference PyTorch checkpoint into the port's parameters.

Counterpart of `weatherforecast_stgcn_maml_tpu/utils/torch_import.py`. A
user of the reference holds `.pt` checkpoints (meta: the reference's
training script; adapted: its adaptation script, with the region's
normalization `stats`) with the keys `hybrid_model_state_dict`,
`koppen_embed_state_dict`, `config`, `hybrid_config` and, adapted,
`stats`. This module maps their tensors onto the hybrid model's
state_dict (`models/hybrid.py`), so a trained reference model can be
served, validated and fine-tuned here.

Mapping (reference -> port):
  * GCNConv `lin.weight` [out, in] -> `encoder.layers.{i}.w` [in, out]
    (transposed); its `bias` -> `encoder.layers.{i}.b`.
  * LSTM `weight_ih_l{k}` [4H, in] -> `lstm.layers.{k}.wx` [in, 4H]
    (transposed; the same gate order i, f, g, o), `weight_hh_l{k}` ->
    `wh`; `bias_ih_l{k}` / `bias_hh_l{k}` -> two parameters `b_ih` /
    `b_hh`. The forward reads their sum, but each keeps its own Adam state
    and weight decay when the imported weights are fine-tuned, as in the
    reference's training loop (`models/lstm.LSTMLayer`).
  * `output_layer.weight` [H*12, lstm_hidden] -> `head.w` (transposed).
  * Koppen `embedding.weight` [31, 8] -> `koppen`.
  * The reference STGCN's own `output_layer` is dead weight in the hybrid
    and is not read.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from weatherforecast_stgcn_maml_tpu_torch.config import ModelConfig
from weatherforecast_stgcn_maml_tpu_torch.data.preprocess import NormStats


def _f32(t) -> torch.Tensor:
    t = t.detach().cpu() if isinstance(t, torch.Tensor) else torch.from_numpy(np.asarray(t))
    return t.to(torch.float32).contiguous()


def params_from_state_dicts(
    hybrid_state: dict, koppen_state: dict, cfg: ModelConfig
) -> dict[str, torch.Tensor]:
    """The hybrid model's state_dict (float32 on the CPU, split LSTM
    biases) from the reference's two state dicts."""
    out: dict[str, torch.Tensor] = {}
    for i in range(1, cfg.gcn_layers + 1):
        w = _f32(hybrid_state[f"base_stgcn.conv{i}.lin.weight"]).t().contiguous()
        key_b = f"base_stgcn.conv{i}.bias"
        out[f"encoder.layers.{i - 1}.w"] = w
        out[f"encoder.layers.{i - 1}.b"] = (
            _f32(hybrid_state[key_b]) if key_b in hybrid_state
            else torch.zeros(w.shape[1], dtype=torch.float32)
        )
    for l in range(cfg.lstm_layers):
        out[f"lstm.layers.{l}.wx"] = _f32(hybrid_state[f"lstm.weight_ih_l{l}"]).t().contiguous()
        out[f"lstm.layers.{l}.wh"] = _f32(hybrid_state[f"lstm.weight_hh_l{l}"]).t().contiguous()
        out[f"lstm.layers.{l}.b_ih"] = _f32(hybrid_state[f"lstm.bias_ih_l{l}"])
        out[f"lstm.layers.{l}.b_hh"] = _f32(hybrid_state[f"lstm.bias_hh_l{l}"])
    out["head.w"] = _f32(hybrid_state["output_layer.weight"]).t().contiguous()
    out["head.b"] = _f32(hybrid_state["output_layer.bias"])
    out["koppen"] = _f32(koppen_state["embedding.weight"])
    return out


def model_config_from_checkpoint(ckpt: dict) -> ModelConfig:
    """A ModelConfig from the reference checkpoint's `config` and
    `hybrid_config` blocks, with the reference validator's defaults where
    they are absent."""
    config = ckpt.get("config", {})
    hybrid = ckpt.get("hybrid_config", {})
    return ModelConfig(
        hidden_channels=int(config.get("hidden_channels", 256)),
        window=int(config.get("window_size", 24)),
        horizon=int(config.get("forecast_horizon", 8)),
        lstm_hidden=int(hybrid.get("lstm_hidden_size", 128)),
        lstm_layers=int(hybrid.get("lstm_num_layers", 4)),
        lstm_dropout=float(hybrid.get("lstm_dropout", 0.2)),
    )


def _numpy_safe_globals() -> list:
    """The numpy reconstruction machinery an adapted checkpoint's stats
    need (arrays, dtypes, scalars), and nothing else. numpy 2 keeps
    `_reconstruct` and `scalar` in `numpy._core.multiarray`, numpy 1 in
    `numpy.core.multiarray`, and a pickle names the module of the numpy
    that wrote it: both names are allowed, so that files from either major
    load under either."""
    core = np._core if hasattr(np, "_core") else np.core
    ma = core.multiarray
    safe = [np.ndarray, np.dtype, ma._reconstruct, ma.scalar]
    for mod in ("numpy.core.multiarray", "numpy._core.multiarray"):
        if mod != ma._reconstruct.__module__:
            safe += [(ma._reconstruct, f"{mod}._reconstruct"), (ma.scalar, f"{mod}.scalar")]
    dtypes = getattr(np, "dtypes", None)
    if dtypes is not None:
        safe += [getattr(dtypes, n) for n in dir(dtypes) if n.endswith("DType")]
    return safe


def import_torch_checkpoint(path: str, *, allow_unsafe_pickle: bool = False):
    """Load a reference .pt checkpoint -> (state_dict, ModelConfig,
    NormStats | None, meta).

    The layer counts and the Koppen table's shape come from the tensors
    themselves (a non-default architecture imports as it is); `meta` holds
    the checkpoint's model_version, epoch, best_loss, region_name and
    val_loss where present.

    The load is torch's safe `weights_only=True` with the numpy allowlist
    above; a checkpoint that needs more of pickle is refused unless the
    caller opts in with `allow_unsafe_pickle=True`, for a trusted file."""
    if allow_unsafe_pickle:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    else:
        try:
            with torch.serialization.safe_globals(_numpy_safe_globals()):
                ckpt = torch.load(path, map_location="cpu", weights_only=True)
        except Exception as e:
            raise RuntimeError(
                f"safe (weights_only) load of {path!r} failed: {e}\n"
                "If you trust this file, retry with "
                "allow_unsafe_pickle=True (executes pickle bytecode)."
            ) from e
    cfg = model_config_from_checkpoint(ckpt)
    hybrid_state = ckpt["hybrid_model_state_dict"]
    koppen_state = ckpt["koppen_embed_state_dict"]
    n_convs = sum(
        1 for k in hybrid_state
        if k.startswith("base_stgcn.conv") and k.endswith(".lin.weight")
    )
    n_lstm = sum(1 for k in hybrid_state if k.startswith("lstm.weight_ih_l"))
    kop_classes, kop_dim = koppen_state["embedding.weight"].shape
    cfg = dataclasses.replace(
        cfg,
        gcn_layers=n_convs or cfg.gcn_layers,
        lstm_layers=n_lstm or cfg.lstm_layers,
        koppen_classes=int(kop_classes),
        koppen_dim=int(kop_dim),
    )
    params = params_from_state_dicts(hybrid_state, koppen_state, cfg)
    stats = None
    if isinstance(ckpt.get("stats"), dict) and "mean" in ckpt["stats"]:
        stats = NormStats(
            mean=np.asarray(ckpt["stats"]["mean"], np.float32).reshape(-1),
            std=np.asarray(ckpt["stats"]["std"], np.float32).reshape(-1),
        )
    meta = {
        k: ckpt[k]
        for k in ("model_version", "epoch", "best_loss", "region_name", "val_loss")
        if k in ckpt
    }
    return params, cfg, stats, meta
