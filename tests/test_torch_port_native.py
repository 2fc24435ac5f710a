"""The port's native host pipeline (`weatherforecast_stgcn_maml_tpu_torch.
native`) against the JAX package's (`weatherforecast_stgcn_maml_tpu.native`,
built from its source with its Makefile's flags, by `tests/_host_route.
build_jax_native`) and against the port's numpy route.

  * each of the five functions equals JAX's bit for bit (the same C++
    source) on JAX test_native.py's inputs: random positions, a regular grid
    (ties everywhere), NaNs with an all-NaN column, window anchors, and both
    refuse an anchor out of range;
  * each equals the port's numpy route: exactly for the graph and the
    gather, within float32 rounding for the fill, the stats and the z-score
    (the C++ sums in double, multiplies by 1/std);
  * `graph.build_region_graph`, `data/preprocess.prepare_features` and the
    task builder's windows of the port equal JAX's bit for bit with both
    libraries on, on Moscow's synthetic region (441 nodes, NaNs, fresh and
    given stats), and the caller's region is left unchanged;
  * the build: keyed by the source, written by rename (three processes
    building at once load one library), a failing compiler raises with its
    output, no compiler leaves the numpy route and `available()` False.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from weatherforecast_stgcn_maml_tpu import native as jax_native
from weatherforecast_stgcn_maml_tpu.data import preprocess as jax_pre
from weatherforecast_stgcn_maml_tpu.data.synthetic import synthetic_region_for_box as jax_box
from weatherforecast_stgcn_maml_tpu.graph import build_region_graph as jax_graph
from weatherforecast_stgcn_maml_tpu.graph import grid_node_positions
from weatherforecast_stgcn_maml_tpu.graph import knn_edges as jax_knn
from weatherforecast_stgcn_maml_tpu.train.tasks import _materialize as jax_materialize
from weatherforecast_stgcn_maml_tpu_torch import graph as tgraph
from weatherforecast_stgcn_maml_tpu_torch import native
from weatherforecast_stgcn_maml_tpu_torch.config import NUM_WEATHER_VARS
from weatherforecast_stgcn_maml_tpu_torch.data import preprocess as tpre
from weatherforecast_stgcn_maml_tpu_torch.data.synthetic import synthetic_region_for_box
from weatherforecast_stgcn_maml_tpu_torch.data.windows import WindowSpec
from weatherforecast_stgcn_maml_tpu_torch.train import tasks as ttasks

from tests._host_route import build_jax_native

torch.set_num_threads(1)  # small tensors; more threads oversubscribe side-by-side workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOSCOW = (53.0, 58.0, 35.0, 40.0)  # 21 x 21 = 441 nodes


@pytest.fixture(autouse=True)
def both_on():
    """Both libraries built and on; each test that wants a numpy route turns
    it on for its call alone."""
    assert build_jax_native(), "the JAX package's native library did not build"
    assert native.build(), "the port's native library did not build"
    jax_native.set_enabled(True)
    native.set_enabled(True)
    yield
    jax_native.set_enabled(True)
    native.set_enabled(True)


def _port_numpy(fn):
    native.set_enabled(False)
    try:
        return fn()
    finally:
        native.set_enabled(True)


def _equal(a, b):
    """Bitwise equal arrays (NaN where NaN)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("case", ["random", "grid ties"])
def test_knn_and_adjacency_match_jax_and_numpy(case):
    """`knn_edges_native` / `normalized_adjacency_native` and the port's
    `knn_edges` / `normalized_adjacency` on them: JAX's bits, and the numpy
    route's edges exactly, its adjacency to float32 rounding."""
    if case == "random":
        pos, k, n, pad = np.random.default_rng(0).uniform(0, 10, size=(60, 2)), 4, 60, 64
    else:
        pos, k, n, pad = grid_node_positions(np.arange(5.0) * 0.25, np.arange(5.0) * 0.25), 4, 25, 32
    edges = native.knn_edges_native(pos, k)
    _equal(edges, jax_native.knn_edges_native(pos, k))
    _equal(tgraph.knn_edges(pos, k), edges)
    _equal(_port_numpy(lambda: tgraph.knn_edges(pos, k)), edges)
    a_hat = native.normalized_adjacency_native(edges, n, pad)
    _equal(a_hat, jax_native.normalized_adjacency_native(edges, n, pad))
    _equal(tgraph.normalized_adjacency(edges, n, pad), a_hat)
    np.testing.assert_allclose(_port_numpy(lambda: tgraph.normalized_adjacency(edges, n, pad)),
                               a_hat, rtol=1e-6, atol=1e-7)
    assert not a_hat[n:].any() and not a_hat[:, n:].any()


def test_nan_fill_stats_and_normalize_match_jax_and_numpy():
    """The fused NaN fill and stats (a column all NaN: filled with 0) and
    the in-place z-score: JAX's bits, the numpy route's to float32
    rounding; a layout or dtype they do not take returns None / False."""
    rng = np.random.default_rng(2)
    data = rng.normal(5.0, 2.0, size=(50, 8, NUM_WEATHER_VARS)).astype(np.float32)
    data[rng.random(data.shape) < 0.2] = np.nan
    data[..., 3] = np.nan
    mine, theirs = data.copy(), data.copy()
    mean, std = native.nan_fill_stats_native(mine)
    jmean, jstd = jax_native.nan_fill_stats_native(theirs)
    _equal(mine, theirs)
    _equal(mean, jmean)
    _equal(std, jstd)
    assert not np.isnan(mine).any() and (mine[..., 3] == 0).all()
    filled = tpre.fill_nans_with_mean(data.copy())
    stats = tpre.compute_stats(filled)
    np.testing.assert_allclose(mine, filled, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(mean, stats.mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(std, stats.std, rtol=1e-4, atol=1e-5)

    assert native.normalize_native(mine, mean, std)
    assert jax_native.normalize_native(theirs, jmean, jstd)
    _equal(mine, theirs)
    np.testing.assert_allclose(mine, (filled - mean) / std, rtol=1e-5, atol=1e-5)
    assert native.nan_fill_stats_native(data.astype(np.float64)) is None
    assert native.nan_fill_stats_native(np.asfortranarray(data[0])) is None
    assert not native.normalize_native(data.astype(np.float64), mean, std)


def test_gather_windows_matches_jax_and_refuses_anchors_out_of_range():
    """The window gather: JAX's bits and the port's torch gather exactly;
    an anchor below `window` or past T-1-horizon raises before any copy."""
    feats = np.random.default_rng(4).normal(size=(40, 12, 16)).astype(np.float32)
    spec = WindowSpec(window=6, horizon=3)
    anchors = np.array([6, 9, 30])
    x, y = native.gather_windows_native(feats, anchors, 6, 3, NUM_WEATHER_VARS)
    jx, jy = jax_native.gather_windows_native(feats, anchors, 6, 3, NUM_WEATHER_VARS)
    assert x.shape == (3, 6, 12, 16) and y.shape == (3, 3, 12, 12)
    _equal(x, jx)
    _equal(y, jy)
    tx, ty = ttasks._materialize(feats, anchors, spec)
    nx, ny = _port_numpy(lambda: ttasks._materialize(feats, anchors, spec))
    for gx, gy in ((tx, ty), (nx, ny)):
        _equal(gx.numpy(), x)
        _equal(gy.numpy(), y)
    zeros = np.zeros((20, 4, 16), np.float32)
    for bad in ([3], [18]):
        for lib in (native, jax_native):
            with pytest.raises(ValueError, match="anchor out of range"):
                lib.gather_windows_native(zeros, np.array(bad), 6, 3, 12)
    assert native.gather_windows_native(zeros, np.array([6, 16]), 6, 3, 12) is not None
    assert native.gather_windows_native(zeros.astype(np.float64), np.array([6]), 6, 3, 12) is None


def test_disabled_library_returns_none():
    native.set_enabled(False)
    assert not native.available()
    assert native.knn_edges_native(np.zeros((4, 2)), 2) is None
    assert native.normalized_adjacency_native(np.zeros((0, 2), np.int64), 2, 2) is None
    assert native.nan_fill_stats_native(np.zeros((2, 2), np.float32)) is None
    assert not native.normalize_native(np.zeros((2, 2), np.float32), np.zeros(2), np.ones(2))
    assert native.gather_windows_native(np.zeros((9, 1, 2), np.float32), [3], 3, 1, 1) is None


@pytest.mark.parametrize("stats_given", [False, True], ids=["fresh stats", "given stats"])
def test_moscow_graph_and_features_equal_jax_bitwise(stats_given):
    """Moscow's synthetic region (441 nodes, 5% NaNs): the port's
    `build_region_graph` and `prepare_features` equal JAX's bit for bit on
    both native libraries (fresh stats from the fused pass, or saved stats
    reused), the region untouched; the port's numpy route agrees to float32
    rounding."""
    kw = dict(num_timesteps=120, seed=11, name="Moscow", nan_fraction=0.05)
    region, jregion = synthetic_region_for_box(MOSCOW, **kw), jax_box(MOSCOW, **kw)
    _equal(region.weather, jregion.weather)
    before = region.weather.copy()
    g = tgraph.build_region_graph(region.lats, region.lons, k_neighbors=4)
    jg = jax_graph(jregion.lats, jregion.lons, k_neighbors=4)
    assert g.num_nodes == jg.num_nodes == 441 and g.padded_nodes == 512
    _equal(g.a_hat, jg.a_hat)
    _equal(g.node_mask, jg.node_mask)
    stats = None
    if stats_given:
        stats = tpre.NormStats(mean=np.linspace(-1.0, 290.0, 12).astype(np.float32),
                               std=np.linspace(0.5, 9.0, 12).astype(np.float32))
    jstats = None if stats is None else jax_pre.NormStats(mean=stats.mean, std=stats.std)
    f, s = tpre.prepare_features(region, stats=stats)
    jf, js = jax_pre.prepare_features(jregion, stats=jstats)
    _equal(f, jf)
    _equal(s.mean, js.mean)
    _equal(s.std, js.std)
    _equal(region.weather, before)
    nf, ns = _port_numpy(lambda: tpre.prepare_features(region, stats=stats))
    np.testing.assert_allclose(ns.mean, s.mean, rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(nf, f, rtol=2e-3, atol=2e-2)


def test_task_windows_equal_jax_bitwise():
    """The task builder's window materialization (`train/tasks._materialize`,
    the native gather) on Moscow's padded features equals JAX's
    `_materialize`."""
    region = synthetic_region_for_box(MOSCOW, num_timesteps=80, seed=3, name="Moscow")
    feats = tpre.pad_nodes(tpre.prepare_features(region)[0], 512)
    spec = WindowSpec(window=24, horizon=8)
    anchors = 24 + np.resize(np.arange(30), 15)
    x, y = ttasks._materialize(feats, anchors, spec)
    jx, jy = jax_materialize(feats, anchors, spec)
    _equal(x.numpy(), jx)
    _equal(y.numpy(), jy)


def test_jax_knn_on_the_port_library_route():
    """JAX's `knn_edges` (its library on) and the port's give one graph on a
    regular grid of Moscow's spacing."""
    pos = grid_node_positions(np.arange(53.0, 58.01, 0.25), np.arange(35.0, 40.01, 0.25))
    _equal(tgraph.knn_edges(pos, 4), jax_knn(pos, 4))


_BUILD_ONE = """
import sys
sys.path.insert(0, {repo!r})
from weatherforecast_stgcn_maml_tpu_torch import native
native.BUILD_ROOT = {root!r}
assert native.available()
print(native._lib._name)
"""


def test_builds_at_once_load_one_library(tmp_path):
    """Three processes that find no library build it at once, each into a
    temporary file renamed over the target: all three load the same path,
    keyed by the source, and no temporary file is left."""
    root = str(tmp_path / "build")
    code = _BUILD_ONE.format(repo=REPO, root=root)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1
    (path,) = paths
    assert os.path.basename(os.path.dirname(path)).startswith("native-")
    assert os.listdir(os.path.dirname(path)) == ["libwf_native.so"]


def test_a_failing_compiler_raises_and_no_compiler_takes_numpy(tmp_path, monkeypatch):
    """A compiler that fails raises with its output (nothing is loaded); no
    compiler at all leaves `available()` False and every function on its
    numpy route."""
    bad = tmp_path / "wf_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_ROOT", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="failed to build the native host pipeline"):
        native.build()
    assert native._lib is None

    monkeypatch.setattr(native, "_compiler", lambda: None)
    monkeypatch.setattr(native, "_no_compiler", False)
    assert not native.build() and not native.available()
    assert native.knn_edges_native(np.zeros((4, 2)), 2) is None
    pos = np.random.default_rng(0).uniform(0, 10, size=(20, 2))
    _equal(tgraph.knn_edges(pos, 3), jax_knn(pos, 3))
