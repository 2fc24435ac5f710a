"""Spatial graph construction as a dense normalized adjacency.

The region's lat/lon grid becomes a directed kNN graph, then the dense
GCN-normalized adjacency `A_hat = D^-1/2 (A + I) D^-1/2`, padded with zero
rows and columns to a multiple of 128 nodes so that every region of a box
size shares one shape. The native host pipeline (`native`: the JAX
package's C++ functions, built at first use) computes both where it is on;
the numpy route beside each breaks ties by index as it does, so the graph
equals the JAX package's for the same grid on either route.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from weatherforecast_stgcn_maml_tpu_torch import native

NODE_ALIGN = 128  # padded node counts are multiples of this


def round_up(x: int, multiple: int = NODE_ALIGN) -> int:
    return -(-x // multiple) * multiple


def grid_node_positions(lats: np.ndarray, lons: np.ndarray) -> np.ndarray:
    """Node positions [N, 2] = (lat, lon) in row-major (lat-outer) order,
    matching the [T, lat, lon, C] -> [T, N, C] feature reshape."""
    lat_g, lon_g = np.meshgrid(np.asarray(lats), np.asarray(lons), indexing="ij")
    return np.stack([lat_g.ravel(), lon_g.ravel()], axis=-1)


def knn_edges(positions: np.ndarray, k: int = 4) -> np.ndarray:
    """Directed kNN edge list [E, 2] of (src, dst) pairs, self excluded.

    Each node receives messages from its k nearest neighbors in Euclidean
    (lat, lon) degree space; ties go to the lower node index.
    """
    pos = np.asarray(positions, dtype=np.float64)
    n = pos.shape[0]
    if k >= n:
        raise ValueError(f"k_neighbors={k} must be < num_nodes={n}")
    native_edges = native.knn_edges_native(pos, k)
    if native_edges is not None:
        return native_edges
    d2 = np.sum((pos[:, None, :] - pos[None, :, :]) ** 2, axis=-1)
    np.fill_diagonal(d2, np.inf)
    nbr = np.argsort(d2, axis=1, kind="stable")[:, :k]
    dst = np.repeat(np.arange(n), k)
    src = nbr.reshape(-1)
    return np.stack([src, dst], axis=-1)


def _sym_normalize(a: np.ndarray) -> np.ndarray:
    """D^-1/2 A D^-1/2; zero-degree rows (padding) stay all-zero."""
    deg = a.sum(axis=1)
    inv_sqrt = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)), 0.0)
    return inv_sqrt[:, None] * a * inv_sqrt[None, :]


def normalized_adjacency(edges: np.ndarray, num_nodes: int, pad_to: int) -> np.ndarray:
    """Dense float32 `A_hat` with `A[dst, src] = 1` per directed edge, degrees
    on A + I. Rows and columns beyond `num_nodes` are exactly zero."""
    n = num_nodes
    if pad_to < n:
        raise ValueError(f"pad_to={pad_to} < num_nodes={n}")
    a_native = native.normalized_adjacency_native(np.asarray(edges), n, pad_to)
    if a_native is not None:
        return a_native
    a = np.zeros((pad_to, pad_to), dtype=np.float64)
    if len(edges):
        e = np.asarray(edges)
        a[e[:, 1], e[:, 0]] = 1.0
    a[np.arange(n), np.arange(n)] += 1.0
    return _sym_normalize(a).astype(np.float32)


@dataclass(frozen=True)
class RegionGraph:
    """Static per-region graph artifacts.

    Attributes:
      a_hat: [Np, Np] dense normalized adjacency (padded).
      node_mask: [Np] float32, 1.0 for real nodes, 0.0 for padding.
      num_nodes: number of real nodes N.
      positions: [N, 2] (lat, lon) of real nodes.
    """

    a_hat: np.ndarray
    node_mask: np.ndarray
    num_nodes: int
    positions: np.ndarray

    @property
    def padded_nodes(self) -> int:
        return self.a_hat.shape[0]


def build_region_graph(
    lats: np.ndarray, lons: np.ndarray, *, k_neighbors: int = 4,
    pad_to: int | None = None,
) -> RegionGraph:
    """Build the dense-adjacency graph for a lat/lon grid region, N padded to
    `pad_to` (meta-training's tasks share one node count) or, by default, up
    to the next multiple of 128."""
    positions = grid_node_positions(lats, lons)
    n = positions.shape[0]
    size = pad_to if pad_to is not None else round_up(n)
    edges = knn_edges(positions, k=k_neighbors)
    a_hat = normalized_adjacency(edges, n, size)
    mask = np.zeros((size,), dtype=np.float32)
    mask[:n] = 1.0
    return RegionGraph(a_hat=a_hat, node_mask=mask, num_nodes=n, positions=positions)
