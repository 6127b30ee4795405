"""Synthetic COLMAP scenes, written with the port's own writers.

The port's counterpart of ``tools/make_synthetic_llff.py``: given NeRF
c2w poses, HR images and points, ``write_llff_scene`` writes
``sparse/0/{cameras,images,points3D}.bin`` and ``images/img_{i:03d}.png``,
a scene that ``load_colmap_scene`` reads back to the same poses (within
float rounding). Each pose goes to COLMAP's w2c through the axis flip
(NeRF "right up back" -> COLMAP "right down front").

``load_colmap_scene`` centres the poses on their average pose and scales
the world so the smallest per-image 0.1-percentile point depth is 4/3.
So the poses given must already be centred (``data.llff.center_poses``),
and ``write_llff_scene`` pins the scale: scene points nearer than 4/3 to
any camera are dropped, and each image gets a few points of its own on
its optical axis at depth 4/3.

``depth_points`` makes scene points from rendered NDC depth maps (the
depth t of a forward-facing render lies at world z = -1 / (1 - t)).
"""

from __future__ import annotations

import os

import numpy as np

from nerfsr_torch.data.colmap import (Camera, ColmapImage, Point3D,
                                      rotmat2qvec, write_cameras_binary,
                                      write_images_binary,
                                      write_points3d_binary)
from nerfsr_torch.data.llff import _ray_dirs_np, average_pose, rays_from_pose
from nerfsr_torch.utils import png

NEAR_DEPTH = 4.0 / 3.0      # the loader's nearest bound after its rescale


def depth_points(poses, depths, images, focal, stride: int = 8):
    """World points (P, 3) and their colours (P, 3) uint8 from each view's
    NDC depth map (n, H, W) in [0, 1), every ``stride``-th pixel."""
    poses = np.asarray(poses, np.float64)
    n, h, w = np.asarray(depths).shape
    dirs = _ray_dirs_np(h, w, focal)[::stride, ::stride]
    pts, cols = [], []
    for i in range(n):
        ro, rd = rays_from_pose(dirs, poses[i].astype(np.float32))
        t = np.clip(np.asarray(depths[i], np.float64)[::stride, ::stride],
                    0.0, 0.99)
        z = -1.0 / (1.0 - t)                  # world z of the NDC depth
        s = (z - ro[..., 2]) / rd[..., 2]
        pts.append((ro + s[..., None] * rd).reshape(-1, 3))
        cols.append(np.asarray(images[i])[::stride, ::stride].reshape(-1, 3))
    return np.concatenate(pts), np.concatenate(cols).astype(np.uint8)


def _colmap_w2c(c2w):
    """NeRF c2w (3, 4) -> COLMAP (R, t) of x = R p + t."""
    r = np.stack([c2w[:, 0], -c2w[:, 1], -c2w[:, 2]], 1).T
    return r, -r @ c2w[:, 3]


def write_llff_scene(out_dir, poses, images, focal, points, colors=None,
                     anchors: int = 4):
    """Write a COLMAP scene of centred NeRF c2w ``poses`` (n, 3, 4), HR
    uint8 ``images`` (n, H, W, 3) and scene ``points`` (P, 3); see the
    module docstring for the points kept and added. Returns ``out_dir``."""
    poses = np.asarray(poses, np.float64)
    images = np.asarray(images)
    if images.dtype != np.uint8:
        raise TypeError(f"images must be uint8, got {images.dtype}")
    avg = average_pose(poses)
    if not np.allclose(avg, np.eye(4)[:3], atol=1e-6):
        raise ValueError("poses must be centred on their average pose "
                         "(data.llff.center_poses); the loader centres them")
    n, h, w = images.shape[:3]
    sparse = os.path.join(out_dir, "sparse/0")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    write_cameras_binary(
        [Camera(1, "SIMPLE_PINHOLE", w, h,
                np.array([focal, w / 2, h / 2], float))],
        os.path.join(sparse, "cameras.bin"))

    frames = []
    for i in range(n):
        name = f"img_{i:03d}.png"
        png.write(os.path.join(out_dir, "images", name), images[i])
        r, t = _colmap_w2c(poses[i])
        frames.append(ColmapImage(i + 1, rotmat2qvec(r), t, 1, name))
    write_images_binary(frames, os.path.join(sparse, "images.bin"))

    points = np.asarray(points, np.float64)
    colors = np.zeros((len(points), 3), np.uint8) if colors is None \
        else np.asarray(colors, np.uint8)
    forward = -poses[..., 2]                      # COLMAP's z axis
    depth = np.einsum("pk,nk->np", points, forward) - np.einsum(
        "nk,nk->n", poses[..., 3], forward)[:, None]
    keep = depth.min(0) > NEAR_DEPTH
    points, colors = points[keep], colors[keep]
    all_ids = np.arange(1, n + 1, dtype=np.int32)
    records = [Point3D(j + 1, p, c, 0.1, all_ids, np.zeros(n, np.int32))
               for j, (p, c) in enumerate(zip(points, colors))]
    # enough anchors that the 0.1 percentile of each image's depths is
    # one of them, at exactly NEAR_DEPTH
    k = max(anchors, len(points) // 1000 + 3)
    for i in range(n):
        p = poses[i, :, 3] + NEAR_DEPTH * forward[i]
        for _ in range(k):
            records.append(Point3D(len(records) + 1, p,
                                   np.zeros(3, np.uint8), 0.1,
                                   np.array([i + 1], np.int32),
                                   np.zeros(1, np.int32)))
    write_points3d_binary(records, os.path.join(sparse, "points3D.bin"))
    return out_dir
