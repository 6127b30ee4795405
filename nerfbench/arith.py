"""The yardstick's arithmetic, frozen here so that a change to the system
cannot move it: the H100's published peaks, the matmul FLOPs of a ray,
and the least time of kernels C and E.

Copied from the system's own sound counts: ``train_matmul_flops_per_ray``
(``nerfsr_torch/utils/devbench.py``), and ``_bound_ms``,
``mlp_fwd_bound``, ``mlp_bwd_bound`` and ``E_MACS_PER_POINT``
(``chip_smoke.py``), here computed from the configuration's widths.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def posenc_channels(deg: int) -> int:
    return 3 + 6 * deg


def main_macs_per_point(arch: dict) -> int:
    """Multiply-adds a point of the D-layer NeRF MLP (every weight once)."""
    c_pos, c_dir, w = (posenc_channels(arch["deg_pos"]),
                       posenc_channels(arch["deg_dir"]), arch["W"])
    macs, fan_in = 0, c_pos
    for i in range(arch["D"]):
        if i in arch["skips"] and i > 0:
            fan_in = c_pos + w
        macs += fan_in * w
        fan_in = w
    return macs + w * 1 + w * w + (w + c_dir) * (w // 2) + (w // 2) * 3


def prop_macs_per_point(arch: dict) -> int:
    macs, fan_in = 0, posenc_channels(arch["deg_prop"])
    for _ in range(arch["prop_D"]):
        macs += fan_in * arch["prop_W"]
        fan_in = arch["prop_W"]
    return macs + fan_in


def forward_flops_per_ray(arch: dict) -> float:
    """Matmul FLOPs of one ray's forward render: 2 a multiply-add, over
    the points each network sees (fast: the proposal rounds and the fine
    samples; parity: the coarse samples and the merged fine depths).
    Encodings, compositing and resampling are left out."""
    if arch["fast_sampling"]:
        prop_pts = arch["n_prop"] + (arch["n_prop2"]
                                     if arch["n_prop_levels"] >= 2 else 0)
        return 2.0 * (prop_pts * prop_macs_per_point(arch)
                      + arch["N_importance"] * main_macs_per_point(arch))
    return 2.0 * main_macs_per_point(arch) * (
        arch["N_coarse"] + arch["N_coarse"] + arch["N_importance"])


def train_flops_per_ray(arch: dict) -> float:
    """A training step's matmul FLOPs a ray: three times the forward."""
    return 3.0 * forward_flops_per_ray(arch)


def main_points_per_ray(arch: dict) -> list:
    """The points of each call of the big MLP a ray makes (C forward, E
    backward): fast one call of the fine samples; parity the coarse
    samples, then the merged fine depths."""
    if arch["fast_sampling"]:
        return [arch["N_importance"]]
    return [arch["N_coarse"], arch["N_coarse"] + arch["N_importance"]]


def _least_s(flops: float, bytes_moved: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, bytes_moved / HBM_BYTES_PER_S)


def _io_bytes(arch: dict, p: float) -> float:
    """f32 inputs (both encodings) and outputs (rgb, sigma) of P points,
    the bf16 weights and the f32 biases."""
    c_pos, c_dir = (posenc_channels(arch["deg_pos"]),
                    posenc_channels(arch["deg_dir"]))
    n_w = main_macs_per_point(arch)
    n_b = arch["D"] * arch["W"] + 1 + arch["W"] + arch["W"] // 2 + 3
    return 4 * p * (c_pos + c_dir + 3 + 1) + 2 * n_w + 4 * n_b, n_w, n_b


def mlp_fwd_least_s(arch: dict, p: float) -> float:
    """Kernel C's least time over P points in bf16."""
    io, n_w, _ = _io_bytes(arch, p)
    return _least_s(2.0 * n_w * p, io)


def e_macs_per_point(arch: dict) -> int:
    """Kernel E's multiply-adds a point: the forward recompute, the input
    gradients of every layer but the first's input, the skip's encoded
    rows and the direction layer's encoded rows, and the weight
    gradients."""
    w, half = arch["W"], arch["W"] // 2
    n_w = main_macs_per_point(arch)
    grads = 3 * half + w * half + w * w + w + (arch["D"] - 1) * w * w
    return n_w + grads + n_w


def mlp_bwd_least_s(arch: dict, p: float) -> float:
    """Kernel E's least time over P points in bf16: its multiply-adds,
    or its inputs, weights and f32 gradients over the memory rate."""
    io, n_w, n_b = _io_bytes(arch, p)
    return _least_s(2.0 * e_macs_per_point(arch) * p,
                    io + 4 * (n_w + n_b))
