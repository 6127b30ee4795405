"""Kernel A's share of its roofline in training: the least time of the
step's inverse-CDF calls (the bytes a call moves, with the bins its
queries can land in, at 3.35 TB/s: ``nerfbench/arith_sampling.py``) over the device time of A's
launches a step in the trace, on every route (up to 128 bins a warp a
ray; past that the wide route; past 16,384 bins streamed)."""

from nerfbench import arith_sampling

LAYER = "kernels"
MOVES = "train_rays_per_s"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "higher"
PATTERNS = ("invert_cdf_kernel", "invert_cdf_wide_kernel",
            "invert_cdf_stream_kernel")


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "train" or tr is None or not tr.units \
            or not arith_sampling.invert_cdf_calls(ctx["arch"]):
        return None
    device_s = tr.device_s(PATTERNS)
    if device_s is None:
        return None
    least = arith_sampling.invert_cdf_least_s(ctx["arch"],
                                              ctx["rays_per_unit"])
    return 100.0 * least / (device_s / tr.units)
