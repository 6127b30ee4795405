"""Write ``tests/data/jpeg_fixture/``: JPEG files as PIL writes them, with
PIL's decoded pixels and the JAX package's dataset recorded beside them
as sha256 digests, for the port's JPEG reader where PIL and JAX are
absent.

    JAX_PLATFORMS=cpu python tests/data/make_jpeg_fixture.py

It writes

- ``scene/``: a COLMAP scene (``nerfsr_torch.data.synthetic``'s writer)
  of ``N_VIEWS`` views at ``HR`` (1008x756, resized x2 to the 504x378
  ``--img_wh`` of ``scripts/train_llff_downX_fast.sh``): two textured
  planes seen from a spiral of poses, rendered in numpy and saved by PIL
  as camera JPEGs (4:2:0 baseline, quality 90); view 1 progressive, view
  2 with a restart interval, view 3 with an EXIF APP1;
- ``decode/``: one file per decoder case the card checks (``CASES``),
  and one 4032x3024 4:2:0 baseline, the size of ``nerf_llff_data``'s
  originals;
- ``jpeg_fixture.json`` beside the directory: the sha256 of PIL's pixels
  (``np.asarray(Image.open(f))``) of every file; of the JAX package's
  ``load_image(view, (504, 378))`` of every view; of the JAX
  ``LLFFDownXDataset`` training buffer's ``rgbs`` and ``rgbs_ori`` at the
  script's flags (``OPTIONS``, ``--ds_method lanc``).

``tests/test_torch_image.py`` checks that the digests still hold here
and that the port reads the files to them; ``chip_smoke.py``'s ``jpeg``
phase checks the port against them on the card, and trains on the scene.
Regenerating with the same PIL (libjpeg-turbo) gives the same files.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

FIXTURE = os.path.join(HERE, "jpeg_fixture")
DIGESTS = os.path.join(HERE, "jpeg_fixture.json")
N_VIEWS = 8
HR = (1008, 756)
IMG_WH = (504, 378)
FOCAL = 814.0                      # HR pixels (407 at 504 wide)
RADII = (0.2, 0.2, 0.05)
OPTIONS = dict(model="nerf_downX", dataset_mode="llff_downX",
               fast_preset="llff", img_wh=list(IMG_WH), downscale=2,
               include_var=True, ds_method="lanc")
CAMERA = dict(quality=90, subsampling="4:2:0")
VIEW_OPTIONS = {1: dict(progressive=True), 2: dict(restart_marker_rows=1),
                3: dict(exif="exif")}
# name -> (width, height, gray, PIL save options)
CASES = {
    "444_baseline": (250, 187, False, dict(subsampling="4:4:4", quality=95)),
    "444_progressive": (250, 187, False, dict(subsampling="4:4:4",
                                              quality=95, progressive=True)),
    "422_baseline": (250, 187, False, dict(subsampling="4:2:2", quality=95)),
    "422_progressive": (250, 187, False, dict(subsampling="4:2:2",
                                              quality=95, progressive=True)),
    "420_baseline": (250, 187, False, dict(subsampling="4:2:0", quality=95)),
    "420_progressive": (250, 187, False, dict(subsampling="4:2:0",
                                              quality=95, progressive=True)),
    "gray_baseline": (250, 187, True, dict(quality=95)),
    "gray_progressive": (250, 187, True, dict(quality=95, progressive=True)),
    "420_progressive_17x9_q50": (17, 9, False, dict(
        subsampling="4:2:0", quality=50, progressive=True)),
    "422_baseline_7x5_q50": (7, 5, False, dict(subsampling="4:2:2",
                                               quality=50)),
    "420_baseline_1x1": (1, 1, False, dict(subsampling="4:2:0")),
    "420_baseline_33x31_q50": (33, 31, False, dict(subsampling="4:2:0",
                                                   quality=50)),
    "420_optimize_progressive": (250, 187, False, dict(
        subsampling="4:2:0", optimize=True, progressive=True)),
    "420_restart_progressive": (250, 187, False, dict(
        subsampling="4:2:0", progressive=True, restart_marker_blocks=5)),
    "444_adobe_rgb": (250, 187, False, dict(subsampling="4:4:4",
                                            keep_rgb=True)),
    "420_qtable16": (250, 187, False, dict(qtables=[[300] * 64, [40] * 64])),
    "420_baseline_4032x3024": (4032, 3024, False, dict(subsampling="4:2:0",
                                                       quality=90)),
}
BIG = "420_baseline_4032x3024"
BIG_PATTERN = dict(amp=20.0, scale=0.5, grain=0.0)   # ~0.5 MB at 12 MP
SIZE_LIMIT = 2 * 1024 * 1024


def pattern(w, h, gray=False, seed=0, amp=70.0, scale=1.0, grain=25.0):
    """A smooth test card: sinusoids in each channel and a fainter finer
    grain, uint8 (h, w[, 3])."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    s = 200.0 * scale / max(w, h, 8)
    ch = []
    for k in range(3):
        f = rng.uniform(0.3, 1.0, 4)
        ch.append(128 + amp * np.sin(f[0] * s * x + k) * np.cos(
            f[1] * s * y - k) + grain * np.sin(f[2] * 4 * s * (x + y)
                                               + 2 * k))
    img = np.clip(np.stack(ch, -1), 0, 255).astype(np.uint8)
    return img[..., 0] if gray else img


def _texture(u, v, k):
    """Colour channel k of the planes' texture at plane coordinates."""
    return (0.5 + 0.3 * np.sin(3.1 * u + 1.7 * k) * np.cos(2.3 * v - k)
            + 0.05 * np.sin(19.0 * u + 11.0 * v + k))


# the planes: (z, x range, y range, texture offset)
PLANES = [(-3.0, (-0.9, 0.35), (-0.55, 0.6), 5.0), (-6.0, None, None, 0.0)]


def render_view(c2w):
    """The planes seen from ``c2w`` at HR: uint8 (H, W, 3)."""
    from nerfsr_torch.data.llff import _ray_dirs_np, rays_from_pose
    w, h = HR
    ro, rd = rays_from_pose(_ray_dirs_np(h, w, FOCAL), c2w.astype(
        np.float32))
    ro, rd = ro.astype(np.float64), rd.astype(np.float64)
    t_best = np.full((h, w), np.inf)
    img = np.zeros((h, w, 3))
    for z, xr, yr, off in PLANES:
        t = (z - ro[..., 2]) / rd[..., 2]
        p = ro + t[..., None] * rd
        hit = t > 0
        if xr is not None:
            hit &= (p[..., 0] > xr[0]) & (p[..., 0] < xr[1])
            hit &= (p[..., 1] > yr[0]) & (p[..., 1] < yr[1])
        hit &= t < t_best
        t_best = np.where(hit, t, t_best)
        for k in range(3):
            img[..., k] = np.where(hit, _texture(p[..., 0] + off,
                                                 p[..., 1], k), img[..., k])
    return (np.clip(img, 0, 1) * 255).round().astype(np.uint8)


def plane_points(n=12):
    """Scene points on the planes and their colours."""
    pts, cols = [], []
    for z, xr, yr, off in PLANES:
        xr, yr = xr or (-4.0, 4.0), yr or (-3.0, 3.0)
        u, v = np.meshgrid(np.linspace(*xr, n), np.linspace(*yr, n))
        pts.append(np.stack([u, v, np.full_like(u, z)], -1).reshape(-1, 3))
        cols.append(np.stack([_texture(u + off, v, k) for k in range(3)],
                             -1).reshape(-1, 3))
    return np.concatenate(pts), (np.clip(np.concatenate(cols), 0, 1)
                                 * 255).astype(np.uint8)


def scene_poses(n=N_VIEWS):
    from nerfsr_torch.data.llff import center_poses, spiral_path
    poses, _ = center_poses(spiral_path(np.asarray(RADII), 3.5, n))
    return poses


def _exif():
    from PIL import Image
    exif = Image.Exif()
    exif[0x010F] = "NeRF-SR test camera"        # Make
    exif[0x0110] = "fixture"                    # Model
    exif[0x0112] = 1                            # Orientation
    exif[0x0132] = "2026:01:01 00:00:00"        # DateTime
    return exif.tobytes()


def save_jpeg(path, img, **options):
    from PIL import Image
    if options.get("exif") == "exif":
        options = dict(options, exif=_exif())
    Image.fromarray(img).save(path, "JPEG", **options)


def sha256(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def digest(a) -> dict:
    return {"shape": list(a.shape), "dtype": a.dtype.str, "sha256": sha256(a)}


def pil_pixels(path):
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im), im.mode


def write_scene(root):
    from nerfsr_torch.data.synthetic import write_llff_scene
    poses = scene_poses()
    images = np.stack([render_view(p) for p in poses])
    pts, cols = plane_points()

    def save(path, img, i):
        save_jpeg(path, img, **CAMERA, **VIEW_OPTIONS.get(i, {}))
    write_llff_scene(root, poses, images, FOCAL, pts, cols, ext="jpg",
                     save=save)


def jax_digests(scene):
    """The JAX package's view and dataset digests on the scene."""
    from nerfsr_tpu.config import default_options
    from nerfsr_tpu.data import create_dataset
    from nerfsr_tpu.data.blender import load_image

    views = sorted(os.listdir(os.path.join(scene, "images")))
    load = {v: sha256(load_image(os.path.join(scene, "images", v), IMG_WH))
            for v in views}
    opt = default_options("train", dataset_root=scene, **dict(
        OPTIONS, img_wh=tuple(OPTIONS["img_wh"])))
    buf = create_dataset(opt, "train").ray_buffer()
    return load, {k: digest(np.asarray(buf[k])) for k in ("rgbs",
                                                          "rgbs_ori")}


def main():
    shutil.rmtree(FIXTURE, ignore_errors=True)
    scene = os.path.join(FIXTURE, "scene")
    write_scene(scene)
    os.makedirs(os.path.join(FIXTURE, "decode"))
    for name, (w, h, gray, options) in CASES.items():
        save_jpeg(os.path.join(FIXTURE, "decode", name + ".jpg"),
                  pattern(w, h, gray, seed=len(name),
                          **(BIG_PATTERN if name == BIG else {})), **options)
    files = sorted(os.path.relpath(os.path.join(d, f), FIXTURE)
                   for d, _, fs in os.walk(FIXTURE) for f in fs
                   if f.endswith(".jpg"))
    pil = {}
    for rel in files:
        px, mode = pil_pixels(os.path.join(FIXTURE, rel))
        pil[rel] = dict(digest(px), mode=mode)
    load, dataset = jax_digests(scene)
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(FIXTURE) for f in fs)
    assert size < SIZE_LIMIT, size
    with open(DIGESTS, "w") as f:
        json.dump({"options": OPTIONS, "img_wh": list(IMG_WH), "pil": pil,
                   "load_image": load, "dataset": dataset},
                  f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {FIXTURE} ({size} bytes, {len(files)} files)")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main()
