"""Checkpoints: a PyTorch state_dict plus the JSON metadata sidecar.

Layout of a checkpoint directory:
  <dir>/params.pt     the model's state_dict (plain tensors; loads with
                      torch.load(..., weights_only=True))
  <dir>/opt_state.pt  optional: the meta optimizer's state {count, mu, nu}
                      (meta-training's checkpoints, read back on resume)
  <dir>/meta.json     metadata: config dict (model.family), norm stats, tags

The sidecar carries the same schema the JAX package writes beside its Orbax
arrays, so `meta.json` reads the same in both. Orbax arrays need jax to
read; a JAX checkpoint is brought over by loading its parameter tree as
numpy arrays and converting it (utils/convert.py).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Mapping

import numpy as np
import torch

PARAMS_FILE = "params.pt"
OPT_STATE_FILE = "opt_state.pt"


def _to_jsonable(x):
    if isinstance(x, dict):
        return {k: _to_jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    return x


def _cpu(tensors: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: v.detach().cpu().contiguous() for k, v in tensors.items()}


def save_checkpoint(
    path: str, state_dict: Mapping[str, torch.Tensor], meta: dict | None = None,
    opt_state: Mapping | None = None,
) -> str:
    """Save a state_dict + JSON `meta` (+ an optimizer state {count, mu,
    nu}), replacing a checkpoint at `path` (written to a sibling tmp dir
    first, then swapped in)."""
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    torch.save(_cpu(state_dict), os.path.join(tmp, PARAMS_FILE))
    if opt_state is not None:
        torch.save(
            {
                "count": int(opt_state["count"]),
                "mu": _cpu(opt_state["mu"]),
                "nu": _cpu(opt_state["nu"]),
            },
            os.path.join(tmp, OPT_STATE_FILE),
        )
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(_to_jsonable(meta or {}), f, indent=2)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> tuple[dict[str, torch.Tensor], dict]:
    """Load (state_dict on the CPU, meta) from `path`."""
    path = os.path.abspath(path)
    params = os.path.join(path, PARAMS_FILE)
    if not os.path.exists(params):
        raise FileNotFoundError(
            f"checkpoint {path} holds no {PARAMS_FILE}; a checkpoint written by "
            "the JAX package is converted with utils/convert.py"
        )
    state_dict = torch.load(params, map_location="cpu", weights_only=True)
    return state_dict, load_meta(path)


def load_opt_state(path: str) -> dict | None:
    """The optimizer state {count, mu, nu} (on the CPU) saved with a
    checkpoint, or None."""
    file = os.path.join(os.path.abspath(path), OPT_STATE_FILE)
    if not os.path.exists(file):
        return None
    return torch.load(file, map_location="cpu", weights_only=True)


def checkpoint_exists(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(os.path.join(path, "meta.json"))


def load_meta(path: str) -> dict:
    """Read only the JSON metadata of a checkpoint."""
    with open(os.path.join(os.path.abspath(path), "meta.json")) as f:
        return json.load(f)


def check_family(meta: dict, expected_family: str, path: str) -> None:
    """Fail clearly when a checkpoint holds another model family than the
    config expects."""
    saved = (meta.get("config") or {}).get("model", {}).get("family")
    if saved is not None and saved != expected_family:
        raise ValueError(
            f"checkpoint {path} holds a {saved!r}-family model but the "
            f"current config expects {expected_family!r}; pass "
            f"-o model.family={saved} (and matching architecture overrides)"
        )
