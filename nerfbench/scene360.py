"""The Blender cells' inputs, made from ``--seed``: a 360-degree scene as
nerf_synthetic captures one, handed to the system as files and to the
reference as arrays.

The scene is the benchmark's blob field (``nerfbench/inputs.py``: its
blobs and ``field``) with no backdrop, inside the unit box, on nothing:
each view is rendered by quadrature between the near and far bounds into
straight RGBA (the colour over the accumulated opacity, the opacity as
alpha), as nerf_synthetic's PNGs hold an object with alpha and leave the
white background to the loader. The cameras lie on the upper hemisphere
at a fixed radius, each looking at the origin with world z up, in the
OpenGL convention of nerf_synthetic's ``transform_matrix`` (the camera
looks down its -z, y up). ``write_scene`` writes the views as a
nerf_synthetic directory: ``transforms_train.json`` (``camera_angle_x``
and each frame's ``file_path`` and ``transform_matrix``) and
``train/r_<i>.png`` (RGBA, the benchmark's own PNG writer).
"""

from __future__ import annotations

import json
import math
import os
from typing import Tuple

import numpy as np
import torch

from nerfbench import inputs, png
from nerfbench.reference import nerf as ref


def poses(seed: int, n: int, scene: dict) -> np.ndarray:
    """n c2w (n, 3, 4) float32 on the upper hemisphere of radius
    ``pose_radius``: azimuth uniform, height uniform in ``z_range`` of
    the radius (uniform over that band of the sphere), each camera
    looking at the origin."""
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 11])
    r = float(scene["pose_radius"])
    z0, z1 = scene["z_range"]
    out = []
    for _ in range(n):
        phi = rng.uniform(0.0, 2.0 * np.pi)
        zf = rng.uniform(z0, z1)
        rho = math.sqrt(1.0 - zf * zf)
        c = r * np.array([rho * math.cos(phi), rho * math.sin(phi), zf])
        z = c / np.linalg.norm(c)
        x = np.cross(np.array([0.0, 0.0, 1.0]), z)
        x /= np.linalg.norm(x)
        out.append(np.stack([x, np.cross(z, x), z, c], 1))
    return np.stack(out).astype(np.float32)


@torch.no_grad()
def render_rgba(c2ws: np.ndarray, hw: Tuple[int, int], focal: float,
                near: float, far: float, seed: int, scene: dict,
                device) -> np.ndarray:
    """uint8 (n, h, w, 4) straight-alpha images of the field by
    quadrature over ``scene["samples"]`` depths from near to far."""
    h, w = hw
    b = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
         for k, v in inputs.blobs(seed, scene).items()}
    n_s = scene["samples"]
    t = torch.linspace(near, far, n_s, device=device)
    delta = (far - near) / (n_s - 1)
    dirs = ref.camera_dirs(h, w, focal, device).reshape(-1, 3)
    out = []
    rows = max(1, (1 << 21) // n_s)
    for c2w in c2ws:
        o, d = ref.world_rays(dirs, torch.as_tensor(c2w, device=device))
        img = []
        for s in range(0, len(d), rows):
            pts = o[s:s + rows, None] + t[:, None] * d[s:s + rows, None]
            sigma, rgb = inputs.field(pts, b, scene)
            alpha = 1 - torch.exp(-sigma * delta)
            trans = torch.cumprod(1 - alpha + 1e-10, -1)
            trans = torch.cat([torch.ones_like(trans[:, :1]),
                               trans[:, :-1]], -1)
            wts = alpha * trans
            acc = wts.sum(-1, keepdim=True)
            colour = (wts[..., None] * rgb).sum(-2) / acc.clamp_min(1e-6)
            img.append(torch.cat([colour, acc], -1))
        img = torch.cat(img).reshape(h, w, 4)
        out.append(torch.round(img.clamp(0, 1) * 255).to(torch.uint8))
    return torch.stack(out).cpu().numpy()


def camera_angle_x(width: int, focal: float) -> float:
    """The horizontal field of view that gives ``focal`` at ``width``
    pixels (the loader scales its 800-pixel focal to the width)."""
    return 2.0 * math.atan(0.5 * width / focal)


def write_scene(root: str, c2ws: np.ndarray, rgba: np.ndarray,
                focal: float) -> str:
    """Write the views as a nerf_synthetic train split under ``root``;
    returns ``root``."""
    os.makedirs(os.path.join(root, "train"), exist_ok=True)
    frames = []
    for i, (c2w, img) in enumerate(zip(c2ws, rgba)):
        png.write(os.path.join(root, "train", f"r_{i}.png"), img)
        m = np.concatenate([c2w.astype(np.float64), [[0, 0, 0, 1.0]]])
        frames.append({"file_path": f"./train/r_{i}",
                       "transform_matrix": m.tolist()})
    meta = {"camera_angle_x": camera_angle_x(rgba.shape[2], focal),
            "frames": frames}
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump(meta, f)
    return root


# the points a density's quantile is taken over: uniform in the cube
# [-BOX, BOX]^3 around the object, where most of the rays' samples lie
BOX, POINTS = 2.0, 1 << 16
# the share of the box left empty (``empty_space``): rays end short of
# full opacity, so the white background enters the loss
EMPTY_SHARE = 0.02


@torch.no_grad()
def empty_space(wts, arch: dict, seed: int, device):
    """The weights with each density head's bias lowered by the
    ``EMPTY_SHARE`` quantile of its density over ``POINTS`` points drawn from
    the seed in the box: that share of the space empty, as around an
    object on white. (With ``inputs.weights``' raised bias alone every
    sample is dense, every ray's opacity is 1, and its white background
    adds nothing.)"""
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 0x2545F491 + 13) & (2 ** 63 - 1))
    pts = (torch.rand((POINTS, 1, 3), generator=gen, device=device) * 2
           - 1) * BOX
    dirs = torch.nn.functional.normalize(
        torch.randn((POINTS, 3), generator=gen, device=device), dim=-1)
    out = dict(wts)
    sigma = {"fine": ref.nerf_mlp(wts, "fine", pts, dirs, arch, "f32")[1]}
    if arch["fast_sampling"]:
        sigma["prop"] = ref.proposal_mlp(wts, pts, arch, "f32")
    for net, s in sigma.items():
        key = f"{net}.sigma.bias"
        out[key] = (wts[key] - s.quantile(EMPTY_SHARE)).contiguous()
    return out
