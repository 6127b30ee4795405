"""The share of ``engine.test``'s render-and-write loop spent on the
host building and writing the artifacts, as the engine reports it
(``timings["write_s"] / timings["seconds"]``), over the window's calls."""

LAYER = "engine"
MOVES = "test_image_ms"
SOURCE = "program_span"
UNIT = "%"
BETTER = "lower"


def read(ctx):
    spans = ctx.get("spans") or []
    total = sum(s["seconds"] for s in spans)
    if ctx.get("kind") != "test" or total <= 0:
        return None
    return 100.0 * sum(s["write_s"] for s in spans) / total
