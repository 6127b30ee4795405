"""The eval image's share of the card's bf16 peak: an image's forward
matmul FLOPs (every HR ray, ``nerfbench/arith.py``) over the window's
time an image, over 989 TFLOP/s."""

from nerfbench import arith

LAYER = "step"
MOVES = "render_image_ms"
SOURCE = "host_clock"
UNIT = "%"
BETTER = "higher"


def read(ctx):
    if ctx.get("kind") != "render" or not ctx.get("units"):
        return None
    s_per_image = ctx["window_s"] / ctx["units"]
    return 100.0 * ctx["rays_per_unit"] * arith.forward_flops_per_ray(
        ctx["arch"]) / s_per_image / arith.PEAK_BF16_FLOPS
