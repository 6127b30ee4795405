"""The share of the traced window in which no operation ran on the card
(``Trace.idle_pct``, nerfbench/trace.py), in the train cells."""

LAYER = "device"
MOVES = "train_rays_per_s"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "lower"


def read(ctx):
    tr = ctx.get("trace")
    return tr.idle_pct() if ctx.get("kind") == "train" and tr else None
