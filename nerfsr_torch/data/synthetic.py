"""Synthetic COLMAP scenes, written with the port's own writers.

The port's counterpart of ``tools/make_synthetic_llff.py``: given NeRF
c2w poses, HR images and points, ``write_llff_scene`` writes
``sparse/0/{cameras,images,points3D}.bin`` and ``images/img_{i:03d}.png``
(or another format through the caller's writer), a scene that
``load_colmap_scene`` reads back to the same poses (within float
rounding). Each pose goes to COLMAP's w2c through the axis flip
(NeRF "right up back" -> COLMAP "right down front").

``load_colmap_scene`` centres the poses on their average pose and scales
the world so the smallest per-image 0.1-percentile point depth is 4/3.
So the poses given must already be centred (``data.llff.center_poses``),
and ``write_llff_scene`` pins the scale: scene points nearer than 4/3 to
any camera are dropped, and each image gets a few points of its own on
its optical axis at depth 4/3.

``depth_points`` makes scene points from rendered NDC depth maps (the
depth t of a forward-facing render lies at world z = -1 / (1 - t)).

``write_blender_scene`` is the port's counterpart of
``tools/make_synthetic_scene.py``: the same analytic field (three
gaussian density blobs) on the same sphere of cameras, rendered in torch
on a given device and written as a NeRF-synthetic scene, with RGBA PNGs
(alpha the opacity) as the published scenes ship them.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from nerfsr_torch.data.colmap import (Camera, ColmapImage, Point3D,
                                      rotmat2qvec, write_cameras_binary,
                                      write_images_binary,
                                      write_points3d_binary)
from nerfsr_torch.data.blender import FAR, NEAR
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
                     anchors: int = 4, ext: str = "png", save=None):
    """Write a COLMAP scene of centred NeRF c2w ``poses`` (n, 3, 4), HR
    uint8 ``images`` (n, H, W, 3) and scene ``points`` (P, 3); see the
    module docstring for the points kept and added. ``save(path, image,
    i)`` writes view ``i`` to ``images/img_{i:03d}.{ext}`` (``png.write``
    by default). Returns ``out_dir``."""
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
        name = f"img_{i:03d}.{ext}"
        path = os.path.join(out_dir, "images", name)
        if save is None:
            png.write(path, images[i])
        else:
            save(path, images[i], i)
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


# ---------------------------------------------------------------------
# Blender (NeRF-synthetic) scenes: an analytic field of three coloured
# gaussian density blobs, rendered in torch
# ---------------------------------------------------------------------

BLOBS = [  # (centre, radius, colour, peak density)
    ((0.0, 0.0, 0.0), 0.7, (0.9, 0.2, 0.2), 12.0),
    ((0.9, 0.3, 0.2), 0.45, (0.2, 0.8, 0.3), 15.0),
    ((-0.6, -0.5, 0.5), 0.5, (0.2, 0.3, 0.9), 15.0),
]
CAMERA_ANGLE_X = 0.8


def blob_field(pts: torch.Tensor):
    """Density (...) and colour (..., 3) of the blob field at world points
    (..., 3): each blob's density is a gaussian of its radius / 2, the
    colour the density-weighted mean of the blobs' colours."""
    sigma = torch.zeros(pts.shape[:-1], dtype=pts.dtype, device=pts.device)
    rgb = torch.zeros_like(pts)
    for centre, radius, colour, peak in BLOBS:
        d2 = ((pts - pts.new_tensor(centre)) ** 2).sum(-1)
        s = peak * torch.exp(-d2 / (2 * (radius / 2) ** 2))
        rgb = rgb + s[..., None] * pts.new_tensor(colour)
        sigma = sigma + s
    rgb = rgb / torch.clamp_min(sigma[..., None], 1e-8)
    return torch.clamp_min(sigma, 0.0), torch.clamp(rgb, 0.0, 1.0)


def look_at_pose(eye) -> np.ndarray:
    """(3, 4) c2w of a camera at ``eye`` looking at the origin (its -z),
    world z up, as the NeRF-synthetic scenes pose theirs."""
    eye = np.asarray(eye, np.float64)
    z_axis = eye / np.linalg.norm(eye)
    x_axis = np.cross(np.array([0.0, 0.0, 1.0]), z_axis)
    x_axis /= np.linalg.norm(x_axis)
    y_axis = np.cross(z_axis, x_axis)
    return np.stack([x_axis, y_axis, z_axis, eye], axis=1)


@torch.no_grad()
def render_blob_view(c2w, hw, focal, n_samples: int = 96,
                     near: float = NEAR, far: float = FAR,
                     device="cpu"):
    """Render the blob field from ``c2w`` at ``hw`` = (h, w) by quadrature
    at ``n_samples`` evenly spaced depths: (colour weighted by opacity
    (h, w, 3), opacity (h, w)) as float numpy arrays. Over white the image
    is colour + 1 - opacity."""
    h, w = hw
    dirs = torch.from_numpy(_ray_dirs_np(h, w, focal).astype(
        np.float32)).to(device)
    c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=device)
    rd = dirs @ c2w[:, :3].T
    rd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    ro = c2w[:, 3]
    t = torch.linspace(near, far, n_samples, device=device)
    delta = (far - near) / (n_samples - 1)
    colour, opacity = [], []
    rows = max(1, (1 << 22) // (w * n_samples))
    for r0 in range(0, h, rows):
        rd_c = rd[r0:r0 + rows]
        pts = ro + t[:, None] * rd_c[..., None, :]
        sigma, rgb = blob_field(pts)
        alpha = 1 - torch.exp(-sigma * delta)
        trans = torch.cumprod(1 - alpha + 1e-10, dim=-1)
        trans = torch.cat([torch.ones_like(trans[..., :1]),
                           trans[..., :-1]], -1)
        weights = alpha * trans
        colour.append((weights[..., None] * rgb).sum(-2))
        opacity.append(weights.sum(-1))
    return (torch.cat(colour).cpu().numpy(),
            torch.cat(opacity).cpu().numpy())


def rgba_pixels(colour, opacity) -> np.ndarray:
    """uint8 RGBA of a render: alpha the opacity, the colour divided by
    it (straight alpha, as NeRF-synthetic PNGs store it), both rounded."""
    a = np.clip(opacity, 0.0, 1.0)
    rgb = np.where(a[..., None] > 0,
                   colour / np.maximum(a[..., None], 1e-12), 0.0)
    px = np.concatenate([np.clip(rgb, 0.0, 1.0), a[..., None]], -1)
    return np.round(px * 255).astype(np.uint8)


def blender_poses(n: int, radius: float = 4.0, seed: int = 0):
    """``n`` cameras on a sphere of ``radius`` around the origin, each
    looking at it, at azimuth uniform in [0, 2 pi) and elevation uniform
    in [0.2, 1.2) rad, drawn in that order from ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    poses = []
    for _ in range(n):
        theta = rng.uniform(0, 2 * np.pi)
        phi = rng.uniform(0.2, 1.2)
        poses.append(look_at_pose(radius * np.array([
            np.cos(theta) * np.cos(phi), np.sin(theta) * np.cos(phi),
            np.sin(phi)])))
    return np.stack(poses)


def write_blender_scene(out_dir, hw=(800, 800), n_train: int = 8,
                        n_val: int = 2, n_test: int = 2,
                        radius: float = 4.0, seed: int = 0,
                        n_samples: int = 96, device="cpu"):
    """Write a NeRF-synthetic scene of the blob field: ``{split}/r_{i}.png``
    (RGBA, alpha the opacity, at ``hw`` = (h, w), 800x800 as the published
    scenes ship) and ``transforms_{train,val,test}.json`` (camera_angle_x
    0.8, 4x4 c2w). Cameras as ``blender_poses``, the splits in order,
    rendered on ``device``. Returns ``out_dir``."""
    h, w = hw
    focal = 0.5 * w / np.tan(0.5 * CAMERA_ANGLE_X)
    splits = {"train": n_train, "val": n_val, "test": n_test}
    poses = blender_poses(sum(splits.values()), radius, seed)
    idx = 0
    for split, n in splits.items():
        os.makedirs(os.path.join(out_dir, split), exist_ok=True)
        frames = []
        for _ in range(n):
            c2w = poses[idx]
            colour, opacity = render_blob_view(c2w, hw, focal, n_samples,
                                               device=device)
            rel = f"./{split}/r_{idx}"
            png.write(os.path.join(out_dir, f"{rel[2:]}.png"),
                      rgba_pixels(colour, opacity))
            frames.append({"file_path": rel, "transform_matrix":
                           np.concatenate([c2w, [[0, 0, 0, 1.0]]]).tolist()})
            idx += 1
        with open(os.path.join(out_dir, f"transforms_{split}.json"),
                  "w") as f:
            json.dump({"camera_angle_x": CAMERA_ANGLE_X, "frames": frames},
                      f)
    return out_dir
