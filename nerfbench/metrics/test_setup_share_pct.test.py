"""The share of each ``engine.test`` call spent on its set-up (the
system, the dataset, the state and the checkpoint), as the system's
spans report it (``timings["setup_s"] / timings["call_s"]``), over the
window's calls. A system whose ``timings`` lack either key gives
nothing."""

LAYER = "engine"
MOVES = "test_image_ms"
SOURCE = "program_span"
UNIT = "%"
BETTER = "lower"
KEY = "setup_s"


def read(ctx):
    spans = ctx.get("spans") or []
    if ctx.get("kind") != "test" or not spans \
            or any(KEY not in s or "call_s" not in s for s in spans):
        return None
    total = sum(s["call_s"] for s in spans)
    if total <= 0:
        return None
    return 100.0 * sum(s[KEY] for s in spans) / total
