"""The share of each ``engine.test`` call spent loading its dataset (a
part of the set-up), as the system's spans report it
(``timings["data_s"] / timings["call_s"]``), over the window's calls. A
system whose ``timings`` lack either key gives nothing."""

LAYER = "data"
MOVES = "test_image_ms"
SOURCE = "program_span"
UNIT = "%"
BETTER = "lower"
KEY = "data_s"


def read(ctx):
    spans = ctx.get("spans") or []
    if ctx.get("kind") != "test" or not spans \
            or any(KEY not in s or "call_s" not in s for s in spans):
        return None
    total = sum(s["call_s"] for s in spans)
    if total <= 0:
        return None
    return 100.0 * sum(s[KEY] for s in spans) / total
