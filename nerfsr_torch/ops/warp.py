"""Depth-guided cross-view warping: the step between the supersampling
and the refine stage.

Port of ``nerfsr_tpu/ops/warp.py``. Each view's rendered depth is lifted
to camera space, moved to the world and into the reference camera,
projected, and its pixel coordinates **truncated** toward zero (a
coordinate at -0.4 lands in column 0), all in f32 on the device:

- NDC depth -> metric depth by ``1 / (1 - d + 1e-6)``;
- the camera-space point ``((i+.5-w/2)/f z, -(j+.5-h/2)/f z, -z)``;
- the perspective divide by ``-z`` and ``x f + w/2``, ``y (-f) + h/2``.

Per view it writes ``{i}_locs.npz`` (``np.savez``, key ``arr_0``: (H, W,
3) f32, [..., :2] the reference-view pixel of each pixel, [..., 2] = -1)
and ``{i}-wrapped.png`` (the reference colours gathered there, 0 where
the point falls outside the reference view), for every
``{i}-fine-depth-ori.npz`` that ``python -m nerfsr_torch.test`` wrote;
the view index comes from the file's name.
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np
import torch

from nerfsr_torch.data.downx_common import load_image
from nerfsr_torch.data.llff import load_colmap_scene
from nerfsr_torch.device import resolve_device
from nerfsr_torch.utils import png


def ndc_depth_to_metric(depth, eps: float = 1e-6):
    """Invert the NDC z mapping."""
    return 1.0 / (1.0 - depth + eps)


def _affine(pts, m):
    """pts (..., 3) @ m[:, :3].T + m[:, 3], in f32."""
    return pts @ m[:, :3].T + m[:, 3]


def warp_coords(depth, c2w, ref_w2c, focal: float, wh):
    """Metric depth (H, W) -> reference-view pixel coordinates (H, W, 2),
    truncated toward zero (f32 tensors on the depth's device)."""
    w, h = wh
    dev = depth.device
    i = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
    j = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
    jj, ii = torch.meshgrid(j, i, indexing="ij")
    pts = torch.stack([(ii - w / 2) / focal * depth,
                       -(jj - h / 2) / focal * depth, -depth], -1)
    pts = _affine(_affine(pts, c2w), ref_w2c)
    pts = pts / -pts[..., 2:3]
    px = torch.trunc(pts[..., 0] * focal + w / 2)
    py = torch.trunc(pts[..., 1] * (-focal) + h / 2)
    return torch.stack([px, py], -1)


def warp_view(depth, c2w, ref_w2c, ref_rgb, focal, wh, ndc_depth=True,
              device="cuda"):
    """Warp one view onto the reference view.

    Args:
      depth: (H, W) rendered depth of the view (NDC when ``ndc_depth``).
      c2w: (3, 4) pose of the view; ref_w2c: (3, 4) world -> reference
        camera; ref_rgb: (H, W, 3) reference image.
    Returns (host arrays):
      locs: (H, W, 3) f32: x and y in the reference view, then -1.
      warped: (H, W, 3) f32: the reference colours at locs, 0 where the
        point falls outside the reference view.
    """
    dev = resolve_device(device)
    f32 = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, np.float32), device=dev)
    depth = f32(depth)
    if ndc_depth:
        depth = ndc_depth_to_metric(depth)
    coords = warp_coords(depth, f32(c2w), f32(ref_w2c), float(focal),
                         wh).cpu().numpy()
    w, h = wh
    px, py = coords[..., 0], coords[..., 1]
    valid = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    xi = np.clip(px.astype(np.int32), 0, w - 1)
    yi = np.clip(py.astype(np.int32), 0, h - 1)
    warped = np.where(valid[..., None], np.asarray(ref_rgb)[yi, xi], 0.0)
    locs = np.concatenate([coords, -np.ones_like(coords[..., :1])], -1)
    return locs.astype(np.float32), warped.astype(np.float32)


def ref_world_to_cam(ref_c2w):
    """(3, 4) c2w -> (3, 4) w2c by homogeneous inversion."""
    m = np.concatenate([ref_c2w, np.array([[0, 0, 0, 1.0]])], 0)
    return np.linalg.inv(m)[:3]


def generate_correspondences(root_dir, result_dir, img_wh,
                             spheric_poses=False, ref_idx=0, device="cuda"):
    """Warp every ``{i}-fine-depth-ori.npz`` of ``result_dir`` onto view
    ``ref_idx`` of the COLMAP scene at ``root_dir``, writing
    ``{i}_locs.npz`` and ``{i}-wrapped.png`` beside it. Returns the view
    indices written, in file order."""
    poses, _, focal, image_paths = load_colmap_scene(root_dir, img_wh)
    ref_rgb = load_image(image_paths[ref_idx], img_wh)
    ref_w2c = ref_world_to_cam(poses[ref_idx])
    written = []
    for path in sorted(glob.glob(os.path.join(result_dir,
                                              "*fine-depth-ori.npz"))):
        # the index comes from the name: a subset render may start at a
        # nonzero index
        m = re.match(r"(\d+)-fine-depth-ori\.npz$", os.path.basename(path))
        if not m or int(m.group(1)) >= len(poses):
            continue
        i = int(m.group(1))
        z = np.load(path)
        depth = np.squeeze(z["matrix"] if "matrix" in z else z[z.files[0]])
        locs, warped = warp_view(depth, poses[i], ref_w2c, ref_rgb, focal,
                                 img_wh, ndc_depth=not spheric_poses,
                                 device=device)
        np.savez(os.path.join(result_dir, f"{i}_locs.npz"), locs)
        png.write(os.path.join(result_dir, f"{i}-wrapped.png"),
                  (np.clip(warped, 0, 1) * 255).astype(np.uint8))
        written.append(i)
    return written
