"""Adapted-checkpoint location. Regional adaptation itself (fine-tuning) is
not ported yet; serving only reads the checkpoints it writes."""

from __future__ import annotations

import os


def adapted_ckpt_path(out_dir: str, region_name: str, box) -> str:
    """`<out_dir>/adapted/<name>_<lat_min>_<lat_max>_<lon_min>_<lon_max>`,
    coordinates %g-canonicalized so int and float boxes share one path."""
    safe = region_name.replace("/", "_")
    coords = "_".join(f"{float(v):g}" for v in box)
    return os.path.join(out_dir, "adapted", f"{safe}_{coords}")
