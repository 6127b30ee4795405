"""The host's time to dispatch a refine step: the seconds of the system's
``nerfsr.train.chunk`` spans (the refine ``train_steps_scan``: the
learning rate's writes, the graph's signature check, the replays'
launches) over the traced window's steps, in ms:
``dispatch_host_ms.train``'s reader (imported) on the refine cells'
trace."""

from pathlib import Path

from nerfbench import spec

LAYER = "dispatch"
MOVES = "train_patches_per_s"
SOURCE = "program_span"
UNIT = "ms"
BETTER = "lower"
SAME_AS = "dispatch_host_ms.train"


def read(ctx):
    if ctx.get("kind") != "train_refine":
        return None
    root = Path(__file__).resolve().parents[2]
    return spec.metric(SAME_AS, root).read(dict(ctx, kind="train"))
