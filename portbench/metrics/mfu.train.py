"""The whole meta step's share of the card's peak: the flops that the
windows trained in the untraced part of the traced run's window need
(`work.window_flops`, forward and backward) over that part's host time at
the peak of the configuration's compute dtype."""

from portbench import work

LAYER = "steps: train/maml.py"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_windows_per_s"


def read(ctx):
    u = ctx.get("untraced", {})
    if ctx.get("kind") != "train" or not u.get("windows"):
        return None
    flops = work.window_flops(ctx["model"], ctx["nodes"], ctx["k"], True) * u["windows"]
    return 100.0 * flops / (u["seconds"] * work.peak_flops(ctx["model"]))
