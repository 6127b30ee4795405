"""The share of each ``engine.test`` call in which the render loop waits
for the system's writer threads (for a slot for the next view, and for
the last jobs after the last view), as the system's spans report it
(``timings["wait_s"] / timings["call_s"]``), over the window's calls. A
system whose ``timings`` lack either key gives nothing."""

LAYER = "writers"
MOVES = "test_image_ms"
SOURCE = "program_span"
UNIT = "%"
BETTER = "lower"
KEY = "wait_s"


def read(ctx):
    spans = ctx.get("spans") or []
    if ctx.get("kind") != "test" or not spans \
            or any(KEY not in s or "call_s" not in s for s in spans):
        return None
    total = sum(s["call_s"] for s in spans)
    if total <= 0:
        return None
    return 100.0 * sum(s[KEY] for s in spans) / total
