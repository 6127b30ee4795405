"""The refine U-Net's arithmetic, frozen here so that a change to the
system cannot move it: each convolution's multiply-adds and least bytes
a step, from the configuration's widths, and the step's least time at
the H100's dense TF32 rate (the convolutions run in TF32) or its memory
rate, layer by layer and pass by pass.

A 4x4 stride-2 convolution down halves the side; a transposed one up
doubles it. A layer's forward multiply-adds are its output's pixels
times its input channels times 16 (down), or its input's pixels times
its output channels times 16 (up). Training runs each layer forward, its
input's gradient (every layer but the first, whose input needs none)
and its kernel's gradient: each as many multiply-adds as the forward.
"""

from __future__ import annotations

from typing import List, Tuple

from nerfbench.arith import HBM_BYTES_PER_S

# NVIDIA H100 SXM data sheet, dense TF32
PEAK_TF32_FLOPS = 494.7e12


def layers(arch: dict) -> List[Tuple[str, int, int, int, int]]:
    """(name, input channels, input side, output channels, output side)
    of every convolution of one patch, down then up; an up reads the skip
    beside the layer below, so twice its channels."""
    ngf, side = arch["ngf"], arch["patch_len"]
    downs = [ngf, ngf * 2, ngf * 4] + [ngf * 8] * (arch["num_downs"] - 3)
    ups = list(reversed(downs[:-1])) + [arch["output_nc"]]
    out, cin = [], arch["input_nc"]
    for i, feats in enumerate(downs):
        out.append((f"down_{i}", cin, side, feats, side // 2))
        cin, side = feats, side // 2
    for i, feats in enumerate(ups):
        out.append((f"up_{i}", cin, side, feats, side * 2))
        cin, side = 2 * feats, side * 2
    return out


def _macs(layer) -> int:
    name, cin, s_in, cout, s_out = layer
    pixels = s_out * s_out if name.startswith("down") else s_in * s_in
    return pixels * cin * cout * 16


def forward_macs_per_patch(arch: dict) -> int:
    return sum(_macs(l) for l in layers(arch))


def train_flops_per_patch(arch: dict) -> float:
    """A training step's convolution FLOPs a patch: forward, input
    gradient (none for the first layer) and kernel gradient, 2 a
    multiply-add."""
    first = _macs(layers(arch)[0])
    return 2.0 * (3 * forward_macs_per_patch(arch) - first)


def conv_least_s(arch: dict, batch: int) -> float:
    """The least time of a step's convolutions over ``batch`` patches: for
    each layer and each pass its FLOPs at the TF32 rate or the bytes it
    must read and write once (f32) at the memory rate, the larger."""
    total = 0.0
    for i, l in enumerate(layers(arch)):
        _, cin, s_in, cout, s_out = l
        x = 4 * batch * cin * s_in * s_in
        y = 4 * batch * cout * s_out * s_out
        w = 4 * cin * cout * 16
        flops = 2.0 * batch * _macs(l)
        passes = [x + w + y, x + y + w] + ([y + w + x] if i else [])
        total += sum(max(flops / PEAK_TF32_FLOPS, b / HBM_BYTES_PER_S)
                     for b in passes)
    return total
