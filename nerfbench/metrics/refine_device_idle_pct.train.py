"""The share of the traced window in which no operation ran on the card,
in the refine cells: ``device_idle_pct.train``'s reader (imported) on
their trace."""

from pathlib import Path

from nerfbench import spec

LAYER = "device"
MOVES = "train_patches_per_s"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "lower"
SAME_AS = "device_idle_pct.train"


def read(ctx):
    if ctx.get("kind") != "train_refine":
        return None
    root = Path(__file__).resolve().parents[2]
    return spec.metric(SAME_AS, root).read(dict(ctx, kind="train"))
