"""The host's own work an image in serving: the seconds of the system's
``nerfsr.eval.enqueue`` (the view's pose, the graph's inputs and its
replay), ``nerfsr.eval.readback`` (the copy back, after the card has
finished) and ``nerfsr.eval.postprocess`` (the HR and LR fields on the
host) spans over the traced window's images, in ms; the wait for the
card (``nerfsr.eval.wait``) is left out. The spans record only while
the profiler runs; a system without them gives nothing."""

LAYER = "dispatch"
MOVES = "render_image_ms"
SOURCE = "program_span"
UNIT = "ms"
BETTER = "lower"
SPANS = ("nerfsr.eval.enqueue", "nerfsr.eval.readback",
         "nerfsr.eval.postprocess")


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "render" or tr is None or not tr.units:
        return None
    try:
        from nerfsr_torch import spans
    except ImportError:
        return None
    got = spans.totals()
    if any(name not in got for name in SPANS):
        return None
    return 1e3 * sum(got[name]["seconds"] for name in SPANS) / tr.units
