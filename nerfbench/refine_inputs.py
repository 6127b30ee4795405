"""What a refine run hands to the system and to the reference alike, made
from ``--seed``: the reference view and its NeRF-SR synthesis, and the
U-Net's leaves and running statistics.

The reference view is the blob field of ``nerfbench/inputs.py`` seen
from the capture's first pose (``inputs.render_images``); the synthesis
is that view blurred by a gaussian of ``sr_blur`` pixels and quantized,
as a NeRF-SR render is a softer copy of the truth. The kernels are
drawn on the device in one call, each a normal of deviation sqrt(2 /
(fan_in + fan_out)) (fans over the 4x4 window, the scale of the system's
xavier initialisation) clamped at two deviations; batch norm starts at
scale 1, bias 0, running mean 0 and variance 1, the last up's bias at 0.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from nerfbench import inputs
from nerfbench.reference import refine as rref


def views(cell, seed: int, device) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]:
    """(c2ws (n, 3, 4), the capture's uint8 views (n, h, w, 3), the
    reference view's synthesis (h, w, 3) uint8)."""
    config, traffic = cell.config, cell.traffic
    w, h = config["img_wh"]
    c2ws = inputs.poses(seed, traffic["views"], traffic["scene"])
    imgs = inputs.render_images(c2ws, (h, w), traffic["focal"], seed,
                                traffic["scene"], device)
    return c2ws, imgs, blurred(imgs[config["ref_idx"]],
                               traffic["sr_blur"], device)


@torch.no_grad()
def blurred(img: np.ndarray, sigma: float, device) -> np.ndarray:
    """uint8 (h, w, 3) blurred by a separable gaussian of ``sigma`` pixels
    (edges replicated), rounded back to uint8."""
    r = max(1, int(np.ceil(3 * sigma)))
    x = torch.arange(-r, r + 1, dtype=torch.float32, device=device)
    k = torch.exp(-x * x / (2 * sigma * sigma))
    k = (k / k.sum()).reshape(1, 1, 1, -1).expand(3, 1, 1, -1)
    t = torch.as_tensor(img, device=device).permute(2, 0, 1)[None].float()
    t = torch.nn.functional.pad(t, (r, r, 0, 0), mode="replicate")
    t = torch.nn.functional.conv2d(t, k, groups=3)
    t = torch.nn.functional.pad(t, (0, 0, r, r), mode="replicate")
    t = torch.nn.functional.conv2d(t, k.transpose(2, 3), groups=3)
    return torch.round(t[0].permute(1, 2, 0).clamp(0, 255)).to(
        torch.uint8).cpu().numpy()


def weights(seed: int, arch: dict, device) -> Tuple[Dict[str, torch.Tensor],
                                                    Dict[str, torch.Tensor]]:
    """(every leaf, every running statistic), f32 on ``device``, in the
    system's naming (``rref.leaf_shapes``); the kernels from one draw."""
    shapes = rref.leaf_shapes(arch)
    kernels = [(n, s) for n, s in shapes if len(s) == 4]
    total = sum(int(np.prod(s)) for _, s in kernels)
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 0x9E3779B1 + 11) & (2 ** 63 - 1))
    flat = torch.randn(total, generator=gen, device=device).clamp_(-2, 2)
    wts, off = {}, 0
    for name, shape in shapes:
        if len(shape) == 4:
            n = int(np.prod(shape))
            fans = (shape[0] + shape[1]) * shape[2] * shape[3]
            wts[name] = (flat[off:off + n].view(shape)
                         * (2.0 / fans) ** 0.5).contiguous()
            off += n
        elif name.endswith(".scale"):
            wts[name] = torch.ones(shape, device=device)
        else:
            wts[name] = torch.zeros(shape, device=device)
    stats = {name: (torch.zeros if name.endswith(".mean") else torch.ones)(
        shape, device=device) for name, shape in rref.stat_shapes(arch)}
    return wts, stats
