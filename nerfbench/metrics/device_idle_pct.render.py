"""The share of the traced window in which no operation ran on the card
(``Trace.idle_pct``, nerfbench/trace.py), in the render cells."""

LAYER = "device"
MOVES = "render_image_ms"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "lower"


def read(ctx):
    tr = ctx.get("trace")
    return tr.idle_pct() if ctx.get("kind") == "render" and tr else None
