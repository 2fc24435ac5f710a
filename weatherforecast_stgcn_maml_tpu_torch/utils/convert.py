"""Convert between the JAX package's parameter pytree and the port's
state_dict.

The JAX tree is nested dicts and lists of arrays, given here as numpy
arrays (e.g. `jax.tree.map(np.asarray, params)`):
  {"encoder": {"layers": [{"w", "b"}, ...]}, "lstm": {"layers": [{"wx",
   "wh", "b"}, ...]}, "head": {"w", "b"}, "koppen"}
The state_dict flattens it with dotted keys (`lstm.layers.0.wx`); list
indices become key parts. Layouts are the same on both sides (`w` stored
[in, out]), so conversion copies leaves. LSTM layers imported from torch
checkpoints carry split `b_ih`/`b_hh` biases; they fuse into `b` here,
the bias every forward uses.

A task-stacked tree, every leaf with a leading task axis V (the layout
jax.vmap gives the tree over the tasks of a micro-batch), converts the same
way with the axis kept: the port's stacked leaves {name: [V, ...]}, as the
lockstep meta step (`train/maml.lockstep_batch_grad`) holds them.

An optax AdamW state (`ScaleByAdamState`: count, mu, nu with the
parameters' tree) converts the same way into the port's optimizer state.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from weatherforecast_stgcn_maml_tpu_torch.models.common import lstm_bias
from weatherforecast_stgcn_maml_tpu_torch.train.optimizers import AdamState


def state_dict_from_params(params: Mapping, dtype=np.float32) -> dict[str, torch.Tensor]:
    """JAX parameter pytree (numpy leaves) -> flat state_dict (float32, or
    `dtype`)."""
    out: dict[str, torch.Tensor] = {}

    def walk(prefix: str, node: Any) -> None:
        if isinstance(node, Mapping):
            if "wh" in node and "b" not in node:
                node = {"wx": node["wx"], "wh": node["wh"], "b": lstm_bias(node)}
            for k, v in node.items():
                walk(f"{prefix}{k}.", v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}{i}.", v)
        else:
            out[prefix[:-1]] = torch.from_numpy(np.array(node, dtype=dtype))

    walk("", params)
    return out


def params_from_state_dict(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """Flat state_dict -> JAX parameter pytree with numpy leaves."""
    root: dict = {}
    for key, value in state_dict.items():
        parts = key.split(".")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value.detach().cpu().numpy()

    def listify(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        items = {k: listify(v) for k, v in node.items()}
        if items and all(k.isdigit() for k in items):
            return [items[str(i)] for i in range(len(items))]
        return items

    return listify(root)


def opt_state_from_optax(adam_state, dtype=np.float32) -> AdamState:
    """optax `ScaleByAdamState` (count, and mu / nu as parameter trees with
    numpy leaves) -> the port's AdamState (train/optimizers.py), so both
    packages continue from one mid-run state."""
    return AdamState(
        count=int(np.asarray(adam_state.count)),
        mu=state_dict_from_params(adam_state.mu, dtype),
        nu=state_dict_from_params(adam_state.nu, dtype),
    )
