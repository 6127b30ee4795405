"""The least time of kernels C and E in float32, frozen here so that a
change to the system cannot move it: f32-accurate products on the tensor
cores are 3xTF32 (each operand split into a tf32 big and small part,
three tf32 products for each f32 one), so an f32 multiply-add runs at a
third of the H100's dense TF32 rate; bytes at the memory rate as in
``nerfbench/arith.py``, the weights in f32.

Copied from ``chip_smoke.py``'s ``_bound_ms``, ``mlp_fwd_bound`` and
``mlp_bwd_bound`` with the key ``"tf32"``, here from the configuration's
widths; the f32 scratch that E's three launches pass between them is
left out of its bytes (the work needs none; E is bound by its products
at the cells' shapes either way).
"""

from __future__ import annotations

from nerfbench import arith

# NVIDIA H100 SXM data sheet, dense TF32; three tf32 products an f32 one
PEAK_TF32_FLOPS = 494.7e12
TF32_PASSES = 3


def _least_s(flops: float, bytes_moved: float) -> float:
    return max(TF32_PASSES * flops / PEAK_TF32_FLOPS,
               bytes_moved / arith.HBM_BYTES_PER_S)


def _io_bytes(arch: dict, p: float):
    """f32 inputs (both encodings) and outputs (rgb, sigma) of P points,
    the f32 weights and biases: (bytes, weights, biases)."""
    c_pos, c_dir = (arith.posenc_channels(arch["deg_pos"]),
                    arith.posenc_channels(arch["deg_dir"]))
    n_w = arith.main_macs_per_point(arch)
    n_b = arch["D"] * arch["W"] + 1 + arch["W"] + arch["W"] // 2 + 3
    return 4 * p * (c_pos + c_dir + 3 + 1) + 4 * n_w + 4 * n_b, n_w, n_b


def mlp_fwd_least_s(arch: dict, p: float) -> float:
    """Kernel C's least time over P points in f32 (3xTF32)."""
    io, n_w, _ = _io_bytes(arch, p)
    return _least_s(2.0 * n_w * p, io)


def mlp_bwd_least_s(arch: dict, p: float) -> float:
    """Kernel E's least time over P points in f32 (3xTF32): its
    multiply-adds (``arith.e_macs_per_point``), or its inputs, weights and
    f32 gradients over the memory rate."""
    io, n_w, n_b = _io_bytes(arch, p)
    return _least_s(2.0 * arith.e_macs_per_point(arch) * p,
                    io + 4 * (n_w + n_b))
