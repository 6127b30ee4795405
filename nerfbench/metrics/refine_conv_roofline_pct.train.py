"""The refine U-Net's convolutions' share of their roofline: the least
time of a step's convolutions (each layer's forward, input gradient and
kernel gradient at the TF32 rate, or the bytes each must read and write
at 3.35 TB/s, the larger: ``nerfbench/arith_refine.py``) over the device
time a step of the convolution kernels in the trace. cuDNN picks its
kernels itself, so they are matched by name: every kernel of cuDNN's
names ``cudnn`` (its implicit-GEMM forward, data-gradient and
weight-gradient kernels, ``__5x_cudnn``; its CUTLASS kernels and its
own ``cudnn::`` engines; its layout, padding and workspace helpers,
whose arguments are ``cudnnKernelDataType_t``), as each of the 31
convolution kernels of the cell's first traced run on the H100 does;
none of PyTorch's own. Two memsets and a ``memcpy32_post`` (0.05 ms a
step) are left out. A trace with none of them gives nothing."""

from nerfbench import arith_refine

LAYER = "kernels"
MOVES = "train_patches_per_s"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "higher"
PATTERNS = ("cudnn",)


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "train_refine" or tr is None or not tr.units:
        return None
    device_s = tr.device_s(PATTERNS)
    if device_s is None:
        return None
    least = arith_refine.conv_least_s(ctx["arch"], ctx["patches_per_unit"])
    return 100.0 * least / (device_s / tr.units)
