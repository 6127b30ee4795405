"""Kernel E's share of its roofline in training: the least time of the
step's big-MLP backward (its multiply-adds at 989 TFLOP/s bf16, or its
bytes at 3.35 TB/s, the larger, over each call's points) over the device
time of E's launches a step in the trace."""

from nerfbench import arith

LAYER = "kernels"
MOVES = "train_rays_per_s"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "higher"
PATTERNS = ("mlp_bwd_tile_tc_kernel", "mlp_bwd_wgrad_tc_kernel",
            "mlp_bwd_reduce_kernel")


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "train" or tr is None or not tr.units:
        return None
    device_s = tr.device_s(PATTERNS)
    if device_s is None:
        return None
    least = sum(arith.mlp_bwd_least_s(ctx["arch"], ctx["rays_per_unit"] * p)
                for p in arith.main_points_per_ray(ctx["arch"]))
    return 100.0 * least / (device_s / tr.units)
