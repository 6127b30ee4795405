"""Kernel E's share of its roofline in float32 training: the least time
of the step's big-MLP backward in 3xTF32 (its multiply-adds at 494.7 / 3
TFLOP/s, or its bytes at 3.35 TB/s, the larger, over each call's points:
``nerfbench/arith_tf32.py``) over the device time of E's f32 launches
a step in the trace. A run whose trace has none of them (a bf16 run)
gives nothing."""

from nerfbench import arith, arith_tf32

LAYER = "kernels"
MOVES = "train_rays_per_s"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "higher"
PATTERNS = ("mlp_bwd_tile_tf32_kernel", "mlp_bwd_wgrad_tf32_kernel",
            "mlp_bwd_reduce_tf32_kernel")


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "train" or tr is None or not tr.units:
        return None
    device_s = tr.device_s(PATTERNS)
    if device_s is None:
        return None
    least = sum(arith_tf32.mlp_bwd_least_s(ctx["arch"],
                                          ctx["rays_per_unit"] * p)
                for p in arith.main_points_per_ray(ctx["arch"]))
    return 100.0 * least / (device_s / tr.units)
