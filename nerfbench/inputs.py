"""What a run hands to the system and to the reference alike, made from
``--seed``: the scene, its camera poses and images, and the networks'
weights.

The scene is an analytic field of gaussian density blobs in front of a
dense backdrop, the idea of the system's synthetic Blender scene
(``data/synthetic.py``: ``blob_field``, ``render_blob_view``) placed in
front of forward-facing cameras as an LLFF capture is, and rendered by
quadrature on the device. The cameras look down -z from a small patch
around the origin at a focus point, and are centred on their average
pose, as the COLMAP loader centres a capture. The weights are drawn on
the device in one call, each matrix scaled as He's initialisation
(truncated at two standard deviations), the biases small.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from nerfbench.reference.nerf import camera_dirs, world_rays


def _rng(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), salt])


def _normalize(v):
    return v / np.linalg.norm(v)


def center_poses(poses: np.ndarray) -> np.ndarray:
    """Every pose expressed in the frame of the average pose (mean
    centre, mean z, y from the mean y)."""
    center = poses[..., 3].mean(0)
    z = _normalize(poses[..., 2].mean(0))
    x = _normalize(np.cross(poses[..., 1].mean(0), z))
    avg = np.eye(4)
    avg[:3] = np.stack([x, np.cross(z, x), z, center], 1)
    homo = np.concatenate([poses, np.tile([[[0, 0, 0, 1.0]]],
                                          (len(poses), 1, 1))], 1)
    return (np.linalg.inv(avg) @ homo)[:, :3]


def poses(seed: int, n: int, scene: dict) -> np.ndarray:
    """n forward-facing c2w (n, 3, 4), centred: camera centres uniform in
    the box ``radii``, each looking at the focus point (jittered)."""
    rng = _rng(seed, 1)
    radii = np.asarray(scene["pose_radii"], np.float64)
    out = []
    for _ in range(n):
        c = rng.uniform(-1, 1, 3) * radii
        focus = np.array([0.0, 0.0, -scene["focus_depth"]]) \
            + rng.uniform(-1, 1, 3) * scene["focus_jitter"]
        z = _normalize(c - focus)
        x = _normalize(np.cross(np.array([0, 1.0, 0]), z))
        out.append(np.stack([x, np.cross(z, x), z, c], 1))
    return center_poses(np.stack(out)).astype(np.float32)


def spiral(radii, focus_depth: float, n: int) -> np.ndarray:
    """The two-turn spiral of an LLFF test split: (n, 3, 4) c2w looking at
    the focus depth."""
    out = []
    for t in np.linspace(0, 4 * np.pi, n + 1)[:-1]:
        c = np.array([np.cos(t), -np.sin(t), -np.sin(0.5 * t)]) * radii
        z = _normalize(c - np.array([0, 0, -focus_depth]))
        x = _normalize(np.cross(np.array([0, 1.0, 0]), z))
        out.append(np.stack([x, np.cross(z, x), z, c], 1))
    return np.stack(out).astype(np.float32)


def blobs(seed: int, scene: dict) -> Dict[str, np.ndarray]:
    """The field's blobs: centres, radii, colours and peak densities."""
    rng = _rng(seed, 2)
    k = scene["blobs"]
    lo, hi = np.asarray(scene["blob_box"], np.float64)
    return {"centre": rng.uniform(lo, hi, (k, 3)),
            "radius": rng.uniform(*scene["blob_radius"], k),
            "colour": rng.uniform(0.1, 0.95, (k, 3)),
            "peak": rng.uniform(*scene["blob_peak"], k),
            "backdrop": rng.uniform(0.5, 3.0, (3, 2))}


def field(pts: torch.Tensor, b: Dict[str, torch.Tensor], scene: dict):
    """Density (...) and colour (..., 3) at world points (..., 3): each
    blob a gaussian of its radius / 2, colours mixed by density, and a
    backdrop slab of density ``backdrop_density`` whose colour varies as
    sines of x and y."""
    d2 = ((pts[..., None, :] - b["centre"]) ** 2).sum(-1)
    s = b["peak"] * torch.exp(-d2 / (2 * (b["radius"] / 2) ** 2))
    sigma = s.sum(-1)
    rgb = (s[..., None] * b["colour"]).sum(-2)
    z0, z1 = scene["backdrop_z"]
    slab = ((pts[..., 2] < z0) & (pts[..., 2] > z1)).float() \
        * scene["backdrop_density"]
    f = b["backdrop"]
    phase = torch.arange(3, device=pts.device)
    back = 0.5 + 0.4 * torch.sin(pts[..., :1] * f[:, 0]
                                 + pts[..., 1:2] * f[:, 1] + phase)
    rgb = rgb + slab[..., None] * back
    sigma = sigma + slab
    return sigma, (rgb / sigma.clamp_min(1e-8)[..., None]).clamp(0, 1)


@torch.no_grad()
def render_images(c2ws: np.ndarray, hw: Tuple[int, int], focal: float,
                  seed: int, scene: dict, device) -> np.ndarray:
    """uint8 (n, h, w, 3) images of the field by quadrature over
    ``scene["samples"]`` depths from ``scene["t_range"]``."""
    h, w = hw
    b = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
         for k, v in blobs(seed, scene).items()}
    t0, t1 = scene["t_range"]
    n_s = scene["samples"]
    t = torch.linspace(t0, t1, n_s, device=device)
    delta = (t1 - t0) / (n_s - 1)
    dirs = camera_dirs(h, w, focal, device).reshape(-1, 3)
    out = []
    rows = max(1, (1 << 21) // n_s)
    for c2w in c2ws:
        o, d = world_rays(dirs, torch.as_tensor(c2w, device=device))
        img = []
        for s in range(0, len(d), rows):
            pts = o[s:s + rows, None] + t[:, None] * d[s:s + rows, None]
            sigma, rgb = field(pts, b, scene)
            alpha = 1 - torch.exp(-sigma * delta)
            trans = torch.cumprod(1 - alpha + 1e-10, -1)
            trans = torch.cat([torch.ones_like(trans[:, :1]),
                               trans[:, :-1]], -1)
            img.append(((alpha * trans)[..., None] * rgb).sum(-2))
        img = torch.cat(img).reshape(h, w, 3)
        out.append(torch.round(img.clamp(0, 1) * 255).to(torch.uint8))
    return torch.stack(out).cpu().numpy()


def scene_points(seed: int, scene: dict) -> np.ndarray:
    """World points of the scene for the COLMAP model: the blob centres
    and a grid on the backdrop's front face."""
    b = blobs(seed, scene)
    g = np.linspace(-2.0, 2.0, 9)
    xx, yy = np.meshgrid(g, g)
    back = np.stack([xx.ravel(), yy.ravel(),
                     np.full(xx.size, scene["backdrop_z"][0])], -1)
    return np.concatenate([b["centre"], back])


# ---------------------------------------------------------------------
# the weights
# ---------------------------------------------------------------------

def leaf_shapes(arch: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every leaf in the system's parameter naming
    (``{net}.{layer}.weight`` (out, in), ``.bias`` (out,))."""
    c_pos = 3 + 6 * arch["deg_pos"]
    c_dir = 3 + 6 * arch["deg_dir"]
    width = arch["W"]
    layers = []

    def dense(net, name, fan_in, fan_out):
        layers.append((f"{net}.{name}.weight", (fan_out, fan_in)))
        layers.append((f"{net}.{name}.bias", (fan_out,)))

    nets = ["coarse", "fine"] if not arch["fast_sampling"] else ["fine"]
    if arch["fast_sampling"]:
        c_prop = 3 + 6 * arch["deg_prop"]
        for i in range(arch["prop_D"]):
            dense("prop", f"layer_{i}", c_prop if i == 0 else arch["prop_W"],
                  arch["prop_W"])
        dense("prop", "sigma", arch["prop_W"], 1)
    for net in nets:
        fan_in = c_pos
        for i in range(arch["D"]):
            if i in arch["skips"] and i > 0:
                fan_in = c_pos + width
            dense(net, f"xyz_encoding_{i + 1}", fan_in, width)
            fan_in = width
        dense(net, "sigma", width, 1)
        dense(net, "xyz_encoding_final", width, width)
        dense(net, "dir_encoding", width + c_dir, width // 2)
        dense(net, "rgb", width // 2, 3)
    return layers


def encoded_inputs(arch: dict) -> Dict[str, Tuple[int, int]]:
    """The matrices that read a positional encoding: where it starts among
    their input columns, and its number of frequency bands. The first
    layer and the skip layer read the points' (first), the direction
    layer the view directions' (after the trunk's width), the proposal's
    first layer the points' at its own bands."""
    out = {}
    for net in ["fine"] if arch["fast_sampling"] else ["coarse", "fine"]:
        out[f"{net}.xyz_encoding_1.weight"] = (0, arch["deg_pos"])
        for i in arch["skips"]:
            if 0 < i < arch["D"]:
                out[f"{net}.xyz_encoding_{i + 1}.weight"] = (0,
                                                             arch["deg_pos"])
        out[f"{net}.dir_encoding.weight"] = (arch["W"], arch["deg_dir"])
    if arch["fast_sampling"]:
        out["prop.layer_0.weight"] = (0, arch["deg_prop"])
    return out


SIGMA_BIAS = 1.0


def weights(seed: int, arch: dict, device) -> Dict[str, torch.Tensor]:
    """Every leaf, f32 on ``device``, from one draw: a matrix N(0, 2 /
    fan_in) truncated at two standard deviations, a bias N(0, 0.01^2),
    the density heads' biases raised by ``SIGMA_BIAS`` (a field with no
    empty rays: an image's colours are not all black where a small
    network's density happens to be negative).
    The columns that read frequency band k of an encoding are scaled by
    2^-k, so the random field is smooth, as a fitted scene is (its
    gradient along a ray O(the bands) and not O(2^bands)), and a sample
    moved by rounding changes a colour by as little as it would there."""
    shapes = leaf_shapes(arch)
    total = sum(int(np.prod(s)) for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 0x9E3779B1 + 7) & (2 ** 63 - 1))
    flat = torch.randn(total, generator=gen, device=device).clamp_(-2, 2)
    damp = encoded_inputs(arch)
    out, off = {}, 0
    for name, shape in shapes:
        n = int(np.prod(shape))
        scale = (2.0 / shape[1]) ** 0.5 if len(shape) == 2 else 0.01
        w = flat[off:off + n].view(shape) * scale
        col0, bands = damp.get(name, (0, 0))
        for k in range(bands):
            c = col0 + 3 + 6 * k
            w[:, c:c + 6] *= 2.0 ** -k
        if name.endswith("sigma.bias"):
            w = w + SIGMA_BIAS
        out[name] = w.contiguous()
        off += n
    return out


def load_into(module: torch.nn.Module, wts: Dict[str, torch.Tensor]):
    """Copy the leaves into the system's networks, name for name; every
    leaf of the module must be given."""
    sd = module.state_dict()
    if set(sd) != set(wts):
        raise KeyError(f"the system's leaves {sorted(set(sd) ^ set(wts))} "
                       "differ from the benchmark's")
    with torch.no_grad():
        for k, p in module.named_parameters():
            p.copy_(wts[k])
