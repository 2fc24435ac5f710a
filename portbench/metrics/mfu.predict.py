"""The whole request's share of the card's peak: the forward flops of the
requests served in the untraced part of the traced run's window over that
part's host time at the peak of the configuration's compute dtype."""

from portbench import work

LAYER = "serving: train/supervised.py"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "predict_p95_ms"


def read(ctx):
    u = ctx.get("untraced", {})
    if ctx.get("kind") != "predict" or not u.get("requests"):
        return None
    windows = u["requests"] * ctx["windows_per_request"]
    flops = work.window_flops(ctx["model"], ctx["nodes"], ctx["k"], False) * windows
    return 100.0 * flops / (u["seconds"] * work.peak_flops(ctx["model"]))
