"""Kernel launches in the profiled stretch (the port's CUDA kernels and
aten's alike) over the training windows run in it: an exact count."""

LAYER = "kernel wrappers: ops/*.py"
UNIT = "launches/window"
SOURCE = "device_trace"
MOVES = "train_windows_per_s"


def read(ctx):
    t, n = ctx.get("trace"), ctx.get("stretch", {}).get("windows")
    if ctx.get("kind") != "train" or t is None or not n:
        return None
    return t.launches / n
