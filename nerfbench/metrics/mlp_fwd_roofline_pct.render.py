"""Kernel C's share of its roofline in serving: the least time of an
image's big-MLP forward (its products at 989 TFLOP/s bf16, or its bytes
at 3.35 TB/s, the larger, over every HR ray's points) over the device
time of C's launches an image in the trace."""

from nerfbench import arith

LAYER = "kernels"
MOVES = "render_image_ms"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "higher"
PATTERNS = ("fused_mlp_fwd_tc_kernel",)


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "render" or tr is None or not tr.units:
        return None
    device_s = tr.device_s(PATTERNS)
    if device_s is None:
        return None
    least = sum(arith.mlp_fwd_least_s(ctx["arch"], ctx["rays_per_unit"] * p)
                for p in arith.main_points_per_ray(ctx["arch"]))
    return 100.0 * least / (device_s / tr.units)
