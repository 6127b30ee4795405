"""The host's time to dispatch a training step: the seconds of the
system's ``nerfsr.train.chunk`` spans (each ``train_steps_scan`` call:
the learning rate's writes, the graph's signature check, the replays'
launches) over the traced window's steps, in ms. The spans record only
while the profiler runs, so the system's totals hold the traced window
alone; a system without the span gives nothing."""

LAYER = "dispatch"
MOVES = "train_rays_per_s"
SOURCE = "program_span"
UNIT = "ms"
BETTER = "lower"
SPAN = "nerfsr.train.chunk"


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "train" or tr is None or not tr.units:
        return None
    try:
        from nerfsr_torch import spans
    except ImportError:
        return None
    chunk = spans.totals().get(SPAN)
    if not chunk:
        return None
    return 1e3 * chunk["seconds"] / tr.units
