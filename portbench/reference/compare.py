"""The numbers that decide `correct`: gaps between what the program produced
and what the reference works out from the same inputs."""

from __future__ import annotations

import numpy as np
import torch


def rel_gap(prog, ref) -> float:
    """Largest |prog - ref| / |ref| over matching scalars (losses)."""
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    if prog.shape != ref.shape or not np.all(np.isfinite(prog)):
        return float("inf")
    return float(np.max(np.abs(prog - ref) / np.maximum(np.abs(ref), 1e-30)))


def leaf_norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """{leaf: |‖prog_leaf‖ - ‖ref_leaf‖| / max(‖ref_leaf‖, the median leaf's
    ‖ref‖)} over the leaves in `keep` (all by default); inf for every leaf
    where the two trees differ in their leaves."""
    pn, rn = leaf_norms(prog), leaf_norms(ref)
    names = [k for k in rn if keep is None or k in keep]
    if set(pn) != set(rn) or not names:
        return {"leaves differ": float("inf")}
    median = float(np.median([rn[k] for k in names]))
    gaps = {k: abs(pn[k] - rn[k]) / max(rn[k], median, 1e-30) for k in names}
    return {k: (v if np.isfinite(v) else float("inf")) for k, v in gaps.items()}


def moving_leaves(ref_grad: dict, share: float = 1e-3) -> set:
    """The leaves whose reference gradient norm is at least `share` of the
    median leaf's: the others move under Adam by round-off alone."""
    norms = leaf_norms(ref_grad)
    median = float(np.median(list(norms.values())))
    return {k for k, v in norms.items() if v >= share * median}


def max_rel_error(prog: np.ndarray, ref: np.ndarray) -> float:
    """max |prog - ref| / max |ref| of one answer (inf if shapes differ or
    the answer is not finite)."""
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    if prog.shape != ref.shape or not np.all(np.isfinite(prog)):
        return float("inf")
    return float(np.max(np.abs(prog - ref)) / max(np.max(np.abs(ref)), 1e-30))
