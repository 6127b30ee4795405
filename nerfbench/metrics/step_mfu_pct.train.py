"""The training step's share of the card's bf16 peak: the window's HR
rays a second times the step's matmul FLOPs a ray (three times the
forward, ``nerfbench/arith.py``) over 989 TFLOP/s."""

from nerfbench import arith

LAYER = "step"
MOVES = "train_rays_per_s"
SOURCE = "host_clock"
UNIT = "%"
BETTER = "higher"


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("units"):
        return None
    rays_per_s = ctx["units"] * ctx["rays_per_unit"] / ctx["window_s"]
    return 100.0 * rays_per_s * arith.train_flops_per_ray(ctx["arch"]) \
        / arith.PEAK_BF16_FLOPS
