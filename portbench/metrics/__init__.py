"""Readers of the per-layer metrics, one file each (`<metric>.py`, found by
the metric's name in BENCHMARK.json). Each declares its LAYER, UNIT,
SOURCE and the end-to-end metric it MOVES, and `read(ctx)` returns the
metric from the run's context, or None where the run has nothing to read
(the harness then leaves it out of the line). The context (`ctx`, a dict):
kind ("train" or "predict"), model (the configuration's `model`), nodes
(real nodes a window), k (graph neighbours), untraced ({seconds, windows
or requests, wait_s}: the traced run's untraced part), stretch ({windows
or requests}: the profiled stretch), trace (`portbench.trace.Trace` or
None), windows_per_request.

A family's roofline is withheld where its device time may be short: where
a device operation's launch was not found, or where more than
OTHER_MAX_PCT of the busy time lies in no family (`other`), as when a
change launches a family's kernels from a function that `families.json`
does not name. The result line's `attribution` gives both numbers."""

from portbench import work

OTHER_MAX_PCT = 10.0


def attribution_sound(t) -> bool:
    """Every device operation's launch found, and `other` within bounds."""
    return t.unmatched == 0 and t.other_pct <= OTHER_MAX_PCT


def family_roofline(ctx, kind: str, family: str, flops_fn, bytes_fn):
    """A family's share of its roofline over the profiled stretch: least
    time of the work its windows need over the family's device time."""
    t = ctx.get("trace")
    if ctx.get("kind") != kind or t is None or not t.family_s.get(family):
        return None
    if not attribution_sound(t):
        return None
    stretch = ctx.get("stretch", {})
    windows = stretch.get("windows") or stretch.get("requests", 0) * ctx.get(
        "windows_per_request", 0)
    if not windows:
        return None
    backward = kind == "train"
    flops = flops_fn(ctx["model"], ctx["nodes"], ctx["k"], backward) * windows
    if not flops:
        return None
    nbytes = bytes_fn(ctx["model"], ctx["nodes"], ctx["k"], backward) * windows
    least = work.least_seconds(flops, nbytes, work.peak_dtype(ctx["model"]))
    return 100.0 * least / t.family_s[family]
