"""One host route for both packages in a test that compares them.

The JAX package's `native` and the port's build the same C++ source, so
where both libraries load, their graphs, features and windows are equal bit
for bit: `use_same_host_route()` turns both on. Where either does not load
(no compiler), it turns both off, onto their numpy routes. A port CLI run in
a subprocess takes its library wherever it loads, as both are on here.
`restore_host_routes()` enables both again, as each package starts.

`build_jax_native()` builds the JAX package's library for these tests. Its
own `build()` runs `make -C native`, which writes `native/libwf_native.so`
in place: xdist workers that reach it at once could load half a file. Here
each compile goes to a temporary file that is then renamed.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

from weatherforecast_stgcn_maml_tpu import native as jax_native
from weatherforecast_stgcn_maml_tpu_torch import native as port_native

_JAX_SOURCE = os.path.join(jax_native._NATIVE_DIR, "wf_native.cpp")
_JAX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")  # native/Makefile's
_FUNCTIONS = ("wf_knn_edges", "wf_normalized_adjacency", "wf_nan_fill_stats", "wf_normalize",
              "wf_gather_windows")


def build_jax_native() -> bool:
    """The JAX package's library loaded into its module, as its `build()`
    leaves it (the same source and `native/Makefile` flags), but compiled
    into `.cuda_build/jax-native-<key>/` (key: the source and the flags)
    through a temporary file and a rename; whether it loaded. False without
    a compiler or where the compiler fails, as `build()` answers."""
    if jax_native._lib is not None:
        return True
    cxx = shutil.which("g++")
    if cxx is None:
        return False
    with open(_JAX_SOURCE, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(_JAX_FLAGS).encode()).hexdigest()[:16]
    target = os.path.join(port_native.BUILD_ROOT, f"jax-native-{key}", "libwf_native.so")
    if not os.path.exists(target):
        os.makedirs(os.path.dirname(target), exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(target))
        os.close(fd)
        try:
            if subprocess.run([cxx, *_JAX_FLAGS, "-o", tmp, _JAX_SOURCE],
                              capture_output=True).returncode != 0:
                return False
            os.replace(tmp, target)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(target)
    for name in _FUNCTIONS:
        getattr(lib, name).restype = None
    jax_native._lib = lib
    return True


def use_same_host_route() -> bool:
    """Both packages on their native host pipeline, or both on numpy;
    whether the native one runs."""
    on = port_native.build() and build_jax_native()
    jax_native.set_enabled(on)
    port_native.set_enabled(on)
    return on


def restore_host_routes() -> None:
    jax_native.set_enabled(True)
    port_native.set_enabled(True)
