"""Build and load the port's CUDA kernels.

`nvcc` compiles every `csrc/*.cu` to an object, one process per source,
all started together, and links them into one shared library with a plain C
interface, loaded with ctypes. The library lands in `.cuda_build/<key>/` at
the root of the checkout, keyed by a hash of the sources and of
`nvcc --version`, so a changed source or toolkit rebuilds and an unchanged
one loads what is there. Nothing is built or loaded at import time: the
first call of `load()` does it, and a failed build raises with nvcc's
output.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import tempfile

import torch

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".cuda_build",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Storage-dtype codes of the C interface (csrc/common.cuh).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_PP = ctypes.POINTER(ctypes.c_void_p)
_PLL = ctypes.POINTER(ctypes.c_longlong)
_PI = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "wf_sum_splits": [_P, _I, _LL, _P, _I, _I, _I, _P],
    "wf_gcn_relu_mask_grad": [_I, _I, _I, _P, _P, _P, _P, _F, _P, _P, _I, _I, _I, _I, _P],
    "wf_transpose_round": [_I, _I, _PP, _PP, _PI, _PI, _PI, _PI, _PI, _P],
    # one packed ScanLaunch (ops/fused_lstm_stack.py _SCAN_LAUNCH)
    "wf_lstm_stack_recurrence": [ctypes.c_char_p],
    "wf_lstm_stack_recurrence_clusters": [_I, _I, _I, _I, _I],
    "wf_lstm_stack_recurrence_smem": [_I, _I, _I, _I],
    "wf_lstm_stack_recurrence_stream_clusters": [_I, _I, _I, _I, _I, _I],
    "wf_lstm_stack_recurrence_stream_smem": [_I, _I, _I, _I, _I],
    # one packed StackFwdLaunch and its layers (ops/fused_lstm_stack.py `_STACK_FWD`)
    "wf_lstm_stack_forward": [ctypes.c_char_p],
    "wf_lstm_stack_forward_recurrence": [ctypes.c_char_p],  # one packed ScanFwdLaunch
    "wf_lstm_stack_forward_clusters": [_I, _I, _I, _I, _I],
    "wf_lstm_stack_forward_smem": [_I, _I, _I, _I],
    "wf_lstm_stack_forward_stream_clusters": [_I, _I, _I, _I, _I, _I],
    "wf_lstm_stack_forward_stream_smem": [_I, _I, _I, _I, _I],
    "wf_gemm_nn": [ctypes.c_char_p],  # one packed NNLaunch (ops/gemm.py _NN_LAUNCH)
    "wf_gemm_nn_smem": [_I],
    "wf_gemm_tn": [ctypes.c_char_p],  # one packed TNLaunch (ops/gemm.py _TN_LAUNCH)
    # one packed HvpFwdLaunch and its layers (ops/fused_lstm_hvp.py `_HVP_FWD`)
    "wf_lstm_hvp_forward": [ctypes.c_char_p],
    "wf_lstm_tangent_forward_recurrence": [ctypes.c_char_p],  # one packed ScanFwdTanLaunch
    "wf_lstm_tangent_forward_clusters": [_I, _I, _I, _I, _I],
    "wf_lstm_tangent_recurrence": [ctypes.c_char_p],  # one packed ScanTanLaunch
    "wf_lstm_tangent_recurrence_clusters": [_I, _I, _I, _I, _I],
    "wf_lstm_scan_bwd": [_I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "wf_lstm_scan_backward": [ctypes.c_char_p],  # one packed ScanBackwardLaunch (lstm_scan.py)
    "wf_clip_sgd_update": [ctypes.c_char_p],  # one packed SgdLaunch (ops/fused_sgd.py)
    "wf_clip_sgd_update_tasks": [ctypes.c_char_p],  # the same, a task axis
    "wf_clip_sgd_plan": [_I, _PLL, _I],
}
_RESTYPES = {  # the rest return a cudaError_t
    "wf_clip_sgd_plan": ctypes.c_longlong,
    "wf_gemm_nn_smem": ctypes.c_longlong,
    "wf_lstm_stack_recurrence_smem": ctypes.c_longlong,
    "wf_lstm_stack_forward_smem": ctypes.c_longlong,
    "wf_lstm_stack_recurrence_stream_smem": ctypes.c_longlong,
    "wf_lstm_stack_forward_stream_smem": ctypes.c_longlong,
}

_lib = None
build_seconds: float | None = None  # wall time of the build this process ran
build_log: str = ""  # nvcc's output (ptxas register and spill report) of the loaded build


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _build_key(nvcc: str) -> str:
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(_CSRC, "*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True
    ).stdout
    h.update(version.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(nvcc: str, target: str) -> None:
    global build_seconds, build_log
    import time

    os.makedirs(os.path.dirname(target), exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.dirname(target)) as tmpdir:
        jobs = []
        for src in _sources():
            obj = os.path.join(tmpdir, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            jobs.append((src, obj, proc))
        logs, failed = [], []
        for src, _, proc in jobs:
            out, _ = proc.communicate()
            logs.append(f"== {os.path.basename(src)}\n{out}")
            if proc.returncode != 0:
                failed.append(os.path.basename(src))
        if not failed:
            lib = os.path.join(tmpdir, "lib.so")
            proc = subprocess.run(
                [nvcc, "-shared", "-o", lib, *(obj for _, obj, _ in jobs)],
                capture_output=True, text=True,
            )
            logs.append(f"== link\n{proc.stdout}{proc.stderr}")
            if proc.returncode != 0:
                failed.append("link")
        build_seconds = time.perf_counter() - t0
        build_log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{build_log}")
        with open(target + ".log", "w") as f:  # read back by a process that loads this build
            f.write(build_log)
        os.replace(lib, target)  # atomic: a concurrent process never loads half a file


def load() -> ctypes.CDLL:
    """Build the kernels if needed and return the loaded library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    nvcc = _nvcc()
    target = os.path.join(BUILD_ROOT, _build_key(nvcc), "libwf_kernels.so")
    if not os.path.exists(target):
        _build(nvcc, target)
    elif not build_log and os.path.exists(target + ".log"):
        with open(target + ".log") as f:
            build_log = f.read()
    lib = ctypes.CDLL(target)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    lib.wf_error_string.argtypes = [ctypes.c_int]
    lib.wf_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        name = load().wf_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({name})")


def dtype_code(dtype: torch.dtype) -> int:
    try:
        return DTYPE_CODES[dtype]
    except KeyError:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, not {dtype}") from None


# PyTorch's own raw-stream getter, where its build has one.
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_ptr(device: torch.device) -> int:
    """The raw handle of the current stream on `device` (a CUDA device with
    an index). The raw getter skips the Stream object that current_stream()
    makes (~7 us a launch on the card's host)."""
    if _RAW_STREAM is not None and device.index is not None:
        return _RAW_STREAM(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def no_grad_inputs(*tensors: torch.Tensor) -> None:
    """The serving kernels have no backward: refuse inputs that would need one."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "the fused serving kernels have no backward; call them under "
            "torch.no_grad() or torch.inference_mode()"
        )
