"""Multi-process initialisation: one OS process (rank) per device, joined by
torch.distributed.

Counterpart of `weatherforecast_stgcn_maml_tpu/parallel/distributed.py`:

  * `initialize()` joins the process group from explicit arguments or the
    environment: the JAX package's `COORDINATOR_ADDRESS` ("host:port"),
    `NUM_PROCESSES` and `PROCESS_ID`, or torchrun's `MASTER_ADDR`,
    `MASTER_PORT`, `WORLD_SIZE` and `RANK`. With none of them set it is a
    no-op returning False; a partial set raises RuntimeError.
  * `ensure_process_group()` is what `meta-train --mesh` calls: it joins
    the configured group or, in a single process, forms a group of one
    (on a free localhost port), so a mesh of one rank makes the same
    collective calls as a larger one.
  * `global_mesh()` is a 1-D dp mesh over every rank.
  * A rank's device is `cuda:LOCAL_RANK` (`local_device`) unless the caller
    asks for the CPU or names a card.

Backends (`default_backend`): NCCL when every rank owns a card, gloo on
the CPU or when the ranks share one named card. Nothing here runs at
import.
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

_TORCHRUN = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def default_backend(device: torch.device) -> str:
    """NCCL for ranks that own a card each (cuda, cuda:LOCAL_RANK); gloo on
    the CPU, and for ranks put on one named card (cuda:N), which NCCL
    refuses and gloo carries."""
    return "nccl" if device.type == "cuda" and device.index is None else "gloo"


def _check_complete(configured: dict) -> bool:
    """True if every value is set, False if none is; raise if some are."""
    if all(v is None for v in configured.values()):
        return False
    missing = [k for k, v in configured.items() if v is None]
    if missing:
        # A partially configured launch must fail loudly: running N
        # unrelated single-process jobs would train N copies and clobber
        # each other's checkpoints.
        raise RuntimeError(
            f"partial multi-process configuration: {missing} unset while "
            f"{[k for k, v in configured.items() if v is not None]} set; set all "
            f"of {'/'.join(configured)} (or none, for a single-process run)"
        )
    return True


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str = "gloo",
) -> bool:
    """Join the process group if a multi-process topology is configured.

    Returns True when the group is initialised (also when it already was),
    False for a single-process run with nothing configured."""
    if dist.is_initialized():
        return True
    env = os.environ
    coordinator_address = coordinator_address or env.get("COORDINATOR_ADDRESS")
    if num_processes is None and "NUM_PROCESSES" in env:
        num_processes = int(env["NUM_PROCESSES"])
    if process_id is None and "PROCESS_ID" in env:
        process_id = int(env["PROCESS_ID"])
    jax_style = {"COORDINATOR_ADDRESS": coordinator_address,
                 "NUM_PROCESSES": num_processes, "PROCESS_ID": process_id}
    if _check_complete(jax_style):
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id,
        )
        return True
    if _check_complete({k: env.get(k) for k in _TORCHRUN}):
        # env:// lets torchrun's agent host the store it already serves.
        dist.init_process_group(backend, init_method="env://")
        return True
    return False


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def ensure_process_group(backend: str) -> bool:
    """Join the configured group, or form a group of one. Returns True if
    this call created the group (the caller then destroys it)."""
    if dist.is_initialized():
        return False
    if not initialize(backend=backend):
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0
        )
    return True


def local_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: `cuda:LOCAL_RANK` (0 when unset), or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"a rank runs on cuda or cpu, not {device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; ask for the CPU to run a CPU mesh")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def global_mesh(axis: str = "dp", device: torch.device | None = None):
    """1-D dp mesh over every rank of the process group."""
    from weatherforecast_stgcn_maml_tpu_torch.config import MeshConfig
    from weatherforecast_stgcn_maml_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(MeshConfig(data_axis=axis), device)
