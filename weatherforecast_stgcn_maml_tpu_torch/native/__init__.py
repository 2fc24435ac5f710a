"""ctypes bindings of the native host pipeline (`csrc/wf_native.cpp`).

Five single-pass C++ host functions: the kNN graph (`knn_edges_native`),
its normalized adjacency (`normalized_adjacency_native`), the fused NaN fill
and statistics (`nan_fill_stats_native`), the in-place z-score
(`normalize_native`) and the window gather (`gather_windows_native`).
`graph.knn_edges`, `graph.normalized_adjacency`,
`data/preprocess.prepare_features` and `train/tasks.build_task` call them
where the library is on and take their numpy route where a function returns
None (or False), as the JAX package's `native` does with the same arguments,
dtypes and in-place contracts.

The library is built from `csrc/wf_native.cpp` with `g++ -O3 -std=c++17
-fPIC -shared` (the JAX package's `native/Makefile` flags) at first use,
into `.cuda_build/native-<key>/` at the root of the checkout, keyed by a
hash of the source, the flags and the compiler's version; it is written to
a temporary file and renamed, so processes that build at once never load
half a file. Where no compiler exists the numpy route runs and `available()`
says False; a compiler that fails raises with its output. Nothing is built
or loaded at import time. `set_enabled(False)` forces the numpy route (the
tests compare both).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "wf_native.cpp")
BUILD_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".cuda_build",
)
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")
_FUNCTIONS = ("wf_knn_edges", "wf_normalized_adjacency", "wf_nan_fill_stats", "wf_normalize",
              "wf_gather_windows")

_lib = None
_no_compiler = False
_enabled = True
build_log = ""  # the compiler's output of the build this process ran


def _compiler() -> str | None:
    return shutil.which("g++")


def _target(cxx: str) -> str:
    h = hashlib.sha256()
    with open(_SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(subprocess.run([cxx, "--version"], capture_output=True, text=True,
                            check=True).stdout.encode())
    return os.path.join(BUILD_ROOT, f"native-{h.hexdigest()[:16]}", "libwf_native.so")


def _compile(cxx: str, target: str) -> None:
    global build_log
    os.makedirs(os.path.dirname(target), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(target))
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, _SOURCE], capture_output=True,
                              text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed to build the native host pipeline:\n{build_log}")
        os.replace(tmp, target)  # atomic: a concurrent process never loads half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    """The loaded library, built first where needed; None without a compiler."""
    global _lib, _no_compiler
    if _lib is not None or _no_compiler:
        return _lib
    cxx = _compiler()
    if cxx is None:
        _no_compiler = True
        return None
    target = _target(cxx)
    if not os.path.exists(target):
        _compile(cxx, target)
    lib = ctypes.CDLL(target)
    for name in _FUNCTIONS:
        getattr(lib, name).restype = None
    _lib = lib
    return lib


def build() -> bool:
    """Build (or find) and load the library; whether it is loaded."""
    return _load() is not None


def available() -> bool:
    """Whether the native route runs: enabled, and the library loads."""
    return _enabled and _load() is not None


def set_enabled(flag: bool) -> None:
    global _enabled
    _enabled = flag


def _i64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def _f32(a):
    return np.ascontiguousarray(a, dtype=np.float32)


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def knn_edges_native(positions: np.ndarray, k: int) -> np.ndarray | None:
    """Directed kNN edges [N*k, 2] (src, dst) of positions [N, 2], ties by
    index, or None where the library is off."""
    if not available():
        return None
    pos = np.ascontiguousarray(positions, dtype=np.float64)
    n = pos.shape[0]
    out = np.empty((n * k, 2), dtype=np.int64)
    _load().wf_knn_edges(_ptr(pos), ctypes.c_int64(n), ctypes.c_int64(k), _ptr(out))
    return out


def normalized_adjacency_native(edges: np.ndarray, num_nodes: int,
                                pad_to: int) -> np.ndarray | None:
    """Dense float32 D^-1/2 (A + I) D^-1/2 [pad_to, pad_to], or None."""
    if not available():
        return None
    e = _i64(edges)
    out = np.empty((pad_to, pad_to), dtype=np.float32)
    _load().wf_normalized_adjacency(_ptr(e), ctypes.c_int64(len(e)), ctypes.c_int64(num_nodes),
                                    ctypes.c_int64(pad_to), _ptr(out))
    return out


def nan_fill_stats_native(data: np.ndarray):
    """In-place NaN fill of float32 C-contiguous [..., C]; returns (mean[C],
    std[C]), or None (library off, or another dtype or layout)."""
    if not available():
        return None
    if not (data.dtype == np.float32 and data.flags.c_contiguous):
        return None
    c = data.shape[-1]
    mean = np.empty(c, np.float32)
    std = np.empty(c, np.float32)
    _load().wf_nan_fill_stats(_ptr(data), ctypes.c_int64(data.size // c), ctypes.c_int64(c),
                              _ptr(mean), _ptr(std))
    return mean, std


def normalize_native(data: np.ndarray, mean: np.ndarray, std: np.ndarray) -> bool:
    """In-place z-score of float32 C-contiguous [..., C]; False where it did
    not run."""
    if not available():
        return False
    if not (data.dtype == np.float32 and data.flags.c_contiguous):
        return False
    c = data.shape[-1]
    _load().wf_normalize(_ptr(data), ctypes.c_int64(data.size // c), ctypes.c_int64(c),
                         _ptr(_f32(mean)), _ptr(_f32(std)))
    return True


def gather_windows_native(features: np.ndarray, anchors: np.ndarray, window: int, horizon: int,
                          y_channels: int):
    """(x [S, W, N, C], y [S, H, N, yc]) window batches of float32
    C-contiguous features [T, N, C], or None. An anchor outside [window,
    T-1-horizon] raises: the C++ gather copies blindly."""
    if not available():
        return None
    f = features
    if not (f.dtype == np.float32 and f.flags.c_contiguous):
        return None
    t, n, c = f.shape
    a = _i64(anchors)
    s = len(a)
    if s and (a.min() < window or a.max() + horizon >= t):
        raise ValueError(
            f"anchor out of range: need window <= a <= T-1-horizon "
            f"(window={window}, horizon={horizon}, T={t}, "
            f"anchors [{a.min()}, {a.max()}])"
        )
    x = np.empty((s, window, n, c), np.float32)
    y = np.empty((s, horizon, n, y_channels), np.float32)
    _load().wf_gather_windows(
        _ptr(f), ctypes.c_int64(t), ctypes.c_int64(n), ctypes.c_int64(c), _ptr(a),
        ctypes.c_int64(s), ctypes.c_int64(window), ctypes.c_int64(horizon),
        ctypes.c_int64(y_channels), _ptr(x), _ptr(y))
    return x, y
