"""The refine step's share of the card's bf16 peak: the window's patches
a second times the U-Net's training FLOPs a patch (each convolution
forward, its input's gradient but the first's, its kernel's gradient:
``nerfbench/arith_refine.py``) over 989 TFLOP/s."""

from nerfbench import arith, arith_refine

LAYER = "step"
MOVES = "train_patches_per_s"
SOURCE = "host_clock"
UNIT = "%"
BETTER = "higher"


def read(ctx):
    if ctx.get("kind") != "train_refine" or not ctx.get("units"):
        return None
    patches_per_s = ctx["units"] * ctx["patches_per_unit"] / ctx["window_s"]
    return 100.0 * patches_per_s * arith_refine.train_flops_per_patch(
        ctx["arch"]) / arith.PEAK_BF16_FLOPS
