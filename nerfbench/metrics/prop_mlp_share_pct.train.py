"""The proposal MLP's share of a training step's device time: the traced
time of the library's matrix-product kernels (cuBLAS and cuBLASLt:
``gemm``, ``gemv``, ``nvjet``, ``xmma``, CUTLASS, the split-K reduce)
over the traced time of every device operation. The big MLP runs in the
system's own kernels (C forward, E backward), so on the proposal
schedule every library product of a step is the proposal MLP's, forward
or backward; the parity schedule has none, and gives nothing."""

LAYER = "kernels"
MOVES = "train_rays_per_s"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "lower"
PATTERNS = ("gemm", "gemv", "nvjet", "xmma", "cutlass", "splitKreduce")


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "train" or tr is None \
            or not ctx["arch"]["fast_sampling"]:
        return None
    gemm_s = tr.device_s(PATTERNS)
    total = sum(tr.kernels.values())
    if gemm_s is None or total <= 0:
        return None
    return 100.0 * gemm_s / (total * 1e-6)
