"""Ray generation and camera-space geometry.

Port of ``nerfsr_tpu/core/rays.py``. Rays are built on the device from
camera parameters, so an eval image only ships its pose.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Rays(NamedTuple):
    """A bundle of rays with a common leading shape."""

    origins: torch.Tensor      # (..., 3)
    directions: torch.Tensor   # (..., 3)
    near: torch.Tensor         # (..., 1)
    far: torch.Tensor          # (..., 1)
    viewdirs: torch.Tensor     # (..., 3)

    @property
    def batch_shape(self):
        return self.origins.shape[:-1]


def get_ray_directions(h: int, w: int, focal, use_pixel_centers: bool = True,
                       dtype=torch.float32, device=None) -> torch.Tensor:
    """Per-pixel camera-space directions, -z forward, y up: (h, w, 3)."""
    center = 0.5 if use_pixel_centers else 0.0
    i = torch.arange(w, dtype=dtype, device=device) + center
    j = torch.arange(h, dtype=dtype, device=device) + center
    jj, ii = torch.meshgrid(j, i, indexing="ij")         # (h, w)
    return torch.stack(
        [(ii - w / 2) / focal, -(jj - h / 2) / focal, -torch.ones_like(ii)],
        dim=-1)


def get_rays(directions: torch.Tensor, c2w: torch.Tensor):
    """Rotate camera-space directions into world space and normalise.

    directions: (..., 3); c2w: (3, 4) -> rays_o, rays_d: (..., 3).
    """
    rays_d = directions @ c2w[:, :3].T
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rays_o = c2w[:, 3].expand(rays_d.shape)
    return rays_o, rays_d


def ndc_rays(h: int, w: int, focal, near, rays_o: torch.Tensor,
             rays_d: torch.Tensor):
    """Shift rays to the near plane and project into NDC."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    ox_oz = rays_o[..., 0] / rays_o[..., 2]
    oy_oz = rays_o[..., 1] / rays_o[..., 2]

    o0 = -1.0 / (w / (2.0 * focal)) * ox_oz
    o1 = -1.0 / (h / (2.0 * focal)) * oy_oz
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (w / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2] - ox_oz)
    d1 = -1.0 / (h / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2] - oy_oz)
    d2 = 1.0 - o2

    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)


def make_rays(rays_o: torch.Tensor, rays_d: torch.Tensor, near, far,
              viewdirs: Optional[torch.Tensor] = None) -> Rays:
    """Assemble a Rays bundle, broadcasting scalar near/far. A Python
    scalar is filled on the rays' device (no host-to-device copy, so the
    eval graph can capture it)."""
    shape = rays_o.shape[:-1] + (1,)

    def bound(v):
        if isinstance(v, torch.Tensor):
            return v.to(rays_o.device, rays_o.dtype).expand(shape)
        return torch.full(shape, v, dtype=rays_o.dtype,
                          device=rays_o.device)
    near, far = bound(near), bound(far)
    if viewdirs is None:
        viewdirs = rays_d
    return Rays(rays_o, rays_d, near, far, viewdirs)
