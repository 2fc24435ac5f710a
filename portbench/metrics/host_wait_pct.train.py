"""The share of the untraced part of the window in which the host sits
blocked in the benchmark's span around `fetch_metrics`, waiting for the
card to finish the step it queued: high when the card sets the pace, low
when the host does."""

LAYER = "steps: train/maml.py"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_windows_per_s"


def read(ctx):
    u = ctx.get("untraced", {})
    if ctx.get("kind") != "train" or not u.get("seconds") or "wait_s" not in u:
        return None
    return 100.0 * u["wait_s"] / u["seconds"]
