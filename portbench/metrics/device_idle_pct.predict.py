"""The share of the untraced part of the window with no operation on the
card while requests are served: 1 - (device busy time a request x requests in
that part) / its host seconds. The busy time a request is the union of
the device operations' intervals in the profiled stretch under CUDA
activity alone, over the requests in it: kernel durations do not depend
on the host's pace, while the stretch's own gaps do (the profiler slows the
host), so its idle share (`device.busy_s` / `window_s`) reads high."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "predict_p95_ms"


def read(ctx):
    t, u = ctx.get("trace"), ctx.get("untraced", {})
    stretch = ctx.get("stretch", {}).get("requests")
    if ctx.get("kind") != "predict" or t is None or not stretch or not u.get("requests"):
        return None
    return 100.0 * (1.0 - t.busy_s / stretch * u["requests"] / u["seconds"])
