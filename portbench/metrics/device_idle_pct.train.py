"""The share of the untraced part of the window with no operation on the
card while meta steps run: 1 - (device busy time a window x windows in
that part) / its host seconds. The busy time a window is the union of
the device operations' intervals in the profiled stretch under CUDA
activity alone, over the windows in it: kernel durations do not depend
on the host's pace, while the stretch's own gaps do (the profiler slows the
host), so its idle share (`device.busy_s` / `window_s`) reads high."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_windows_per_s"


def read(ctx):
    t, u = ctx.get("trace"), ctx.get("untraced", {})
    stretch = ctx.get("stretch", {}).get("windows")
    if ctx.get("kind") != "train" or t is None or not stretch or not u.get("windows"):
        return None
    return 100.0 * (1.0 - t.busy_s / stretch * u["windows"] / u["seconds"])
