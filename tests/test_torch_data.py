"""The port's data and artifact code on the CPU, against the JAX package
and the libraries it replaces on the card's machine (PIL, imageio,
OpenCV, which this host has):

- the COLMAP reader (binary and text) and ``load_colmap_scene``; the
  synthetic-scene writer read back by the JAX package;
- the PNG codec, the Lanczos resample, the JET table and the GIF writer;
- ``ssim``;
- ``LLFFDownXDataset`` in its four modes and options, against the JAX
  dataset.
"""

import io
import os
import struct
import sys
import zlib

import cv2
import imageio
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in a test worker)
from PIL import Image

from nerfsr_tpu.config import default_options as j_default_options
from nerfsr_tpu.data.llff import load_colmap_scene as j_load_scene
from nerfsr_tpu.data.llff_downx import LLFFDownXDataset as JDataset
from nerfsr_tpu.models.criterions import ssim as j_ssim

from nerfsr_torch.config import default_options
from nerfsr_torch.data import DATASET_REGISTRY, create_dataset, synthetic
from nerfsr_torch.data.colmap import read_model
from nerfsr_torch.data.downx_common import lanczos_resize
from nerfsr_torch.data.llff import center_poses, load_colmap_scene, \
    spiral_path
from nerfsr_torch.data.llff_downx import LLFFDownXDataset
from nerfsr_torch.models.criterions import ssim
from nerfsr_torch.utils import png
from nerfsr_torch.utils.html import write_gallery
from nerfsr_torch.utils.visualizer import (NullMetricsWriter, Visualizee,
                                           depth2im, save_visuals,
                                           write_gif)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools.make_synthetic_llff import make_llff_scene  # noqa: E402


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("llff")
    make_llff_scene(str(d), hw=(24, 32), n_imgs=5)
    return str(d)


# ---------------------------------------------------------------------
# COLMAP
# ---------------------------------------------------------------------

def _write_text_model(cams, images, points, d):
    """The COLMAP text format of a model, with comment lines, one between
    an image's header and its points line, and an unobserved image."""
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "cameras.txt"), "w") as f:
        f.write("# Camera list\n")
        for c in cams.values():
            f.write(f"{c.id} {c.model} {c.width} {c.height} "
                    + " ".join(repr(float(p)) for p in c.params) + "\n")
    with open(os.path.join(d, "images.txt"), "w") as f:
        f.write("# Image list with two lines of data per image\n\n")
        for k, im in enumerate(images.values()):
            f.write(f"{im.id} " + " ".join(repr(float(x)) for x in
                                          (*im.qvec, *im.tvec))
                    + f" {im.camera_id} {im.name}\n")
            if k == 1:
                f.write("# a comment before the points line\n")
            f.write(" ".join(f"{x!r} {y!r} {p}" for (x, y), p in
                             zip(im.xys.tolist(), im.point3d_ids.tolist()))
                    + "\n")
    with open(os.path.join(d, "points3D.txt"), "w") as f:
        f.write("# 3D point list\n")
        for p in points.values():
            track = " ".join(f"{i} {j}" for i, j in
                             zip(p.image_ids, p.point2d_idxs))
            f.write(f"{p.id} " + " ".join(repr(float(v)) for v in p.xyz)
                    + " " + " ".join(str(int(v)) for v in p.rgb)
                    + f" {p.error!r} {track}\n")


def test_colmap_binary_and_text_read_equal(scene, tmp_path):
    cams, images, points = read_model(os.path.join(scene, "sparse/0"))
    first = next(iter(images.values()))
    first.xys = np.array([[1.5, 2.25], [3.0, 4.5]])
    first.point3d_ids = np.array([1, 2])
    _write_text_model(cams, images, points, str(tmp_path))
    t_cams, t_images, t_points = read_model(str(tmp_path))
    assert cams.keys() == t_cams.keys() and images.keys() == t_images.keys()
    for k, c in cams.items():
        assert (c.model, c.width, c.height) == (t_cams[k].model,
                                                t_cams[k].width,
                                                t_cams[k].height)
        np.testing.assert_array_equal(c.params, t_cams[k].params)
    for k, im in images.items():
        t = t_images[k]
        assert (im.name, im.camera_id) == (t.name, t.camera_id)
        for a in ("qvec", "tvec", "xys", "point3d_ids"):
            np.testing.assert_array_equal(getattr(im, a), getattr(t, a))
    assert len(t_images[list(images)[1]].xys) == 0    # unobserved
    for k, p in points.items():
        np.testing.assert_array_equal(p.xyz, t_points[k].xyz)
        np.testing.assert_array_equal(p.image_ids, t_points[k].image_ids)


def test_load_colmap_scene_matches_jax(scene):
    got = load_colmap_scene(scene, (32, 24))
    want = j_load_scene(scene, (32, 24))
    np.testing.assert_allclose(got[0], want[0], atol=1e-6)
    np.testing.assert_allclose(got[1], want[1], atol=1e-6)
    assert abs(got[2] - want[2]) < 1e-6 and got[3] == want[3]


def test_synthetic_scene_reads_back_through_jax(tmp_path):
    poses, _ = center_poses(spiral_path(np.array([.2, .2, .05]), 3.5, 6))
    rng = np.random.RandomState(0)
    imgs = (rng.rand(6, 12, 16, 3) * 255).astype(np.uint8)
    depths = rng.rand(6, 12, 16) * 0.9
    pts, cols = synthetic.depth_points(poses, depths, imgs, 14.0, stride=2)
    synthetic.write_llff_scene(str(tmp_path), poses, imgs, 14.0, pts, cols)
    j_poses, bounds, focal, paths = j_load_scene(str(tmp_path), (16, 12))
    np.testing.assert_allclose(j_poses, poses, atol=1e-5)
    assert focal == 14.0 and abs(bounds.min() - 4 / 3) < 1e-6
    for i, path in enumerate(paths):
        np.testing.assert_array_equal(np.asarray(Image.open(path)), imgs[i])
    with pytest.raises(ValueError, match="centred"):
        synthetic.write_llff_scene(str(tmp_path / "x"), poses + 0.5, imgs,
                                   14.0, pts)


# ---------------------------------------------------------------------
# PNG, Lanczos, JET, GIF
# ---------------------------------------------------------------------

def _pil_png(img, **kw):
    buf = io.BytesIO()
    img.save(buf, "PNG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P", "P4"])
def test_png_decodes_pil_files(mode):
    rng = np.random.RandomState(1)
    base = np.clip(np.cumsum(rng.randn(29, 41, 4) * 12, 1) + 128, 0,
                   255).astype(np.uint8)
    if mode.startswith("P"):
        img = Image.fromarray(base[..., :3]).quantize(
            16 if mode == "P4" else 256)
    elif mode == "L":
        img = Image.fromarray(base[..., 0])
    else:
        img = Image.fromarray(base[..., :len(mode)].copy(), mode)
    for kw in ({}, {"optimize": True}, {"compress_level": 0}):
        data = _pil_png(img, **kw)
        got = png.decode(data)
        ref = Image.open(io.BytesIO(data))
        assert got.mode == ref.mode
        np.testing.assert_array_equal(got.pixels, np.asarray(ref))
        np.testing.assert_array_equal(got.to_rgb(),
                                      np.asarray(ref.convert("RGB")))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_encodes_what_pil_decodes(channels):
    rng = np.random.RandomState(2)
    img = (rng.rand(13, 17, channels) * 255).astype(np.uint8)
    if channels == 1:
        img = img[..., 0]
    data = png.encode(img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  img)
    np.testing.assert_array_equal(png.decode(data).pixels, img)


def _filtered_png(img):
    """An RGB PNG whose rows cycle through the five filter types."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    out = []
    for y in range(h):
        x, up = rows[y], rows[y - 1] if y else np.zeros_like(rows[0])
        a = np.concatenate([np.zeros(c, np.int64), x[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        f = y % 5
        if f == 0:
            pred = np.zeros_like(x)
        elif f == 1:
            pred = a
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (a + up) // 2
        else:
            p = a + up - ul
            pa, pb, pc = abs(p - a), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, up, ul))
        out.append(bytes([f]) + ((x - pred) & 0xFF).astype(np.uint8)
                   .tobytes())
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    return (png.SIGNATURE + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


def test_png_every_row_filter():
    img = (np.random.RandomState(7).rand(11, 9, 3) * 255).astype(np.uint8)
    data = _filtered_png(img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  img)
    np.testing.assert_array_equal(png.decode(data).pixels, img)


def _with_ihdr(data, **fields):
    w, h, depth, ctype, comp, filt, inter = struct.unpack(
        ">IIBBBBB", data[16:29])
    depth = fields.get("depth", depth)
    inter = fields.get("interlace", inter)
    body = struct.pack(">IIBBBBB", w, h, depth, ctype, comp, filt, inter)
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + body))
    return data[:16] + body + crc + data[33:]


def test_png_refuses_what_it_does_not_cover():
    rgb = np.zeros((4, 4, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG")
    with pytest.raises(ValueError, match="JPEG"):     # utils/image reads it
        png.decode(buf.getvalue())
    data = png.encode(rgb)
    with pytest.raises(ValueError, match="interlace method"):
        png.decode(_with_ihdr(data, interlace=2))      # Adam7 is method 1
    deep = _pil_png(Image.fromarray(np.zeros((4, 4), np.uint16)))
    with pytest.raises(NotImplementedError, match="16-bit gray"):
        png.decode(deep)
    with pytest.raises(ValueError, match="CRC"):
        png.decode(data[:40] + bytes([data[40] ^ 1]) + data[41:])
    with pytest.raises(ValueError, match="truncated"):
        png.decode(data[:-5])


@pytest.mark.parametrize("src,dst", [((504, 378), (252, 189)),
                                     ((40, 40), (20, 20)),
                                     ((63, 47), (31, 23)),
                                     ((100, 75), (64, 48)),
                                     ((30, 22), (47, 41))])
def test_lanczos_is_pils_bytes(src, dst):
    rng = np.random.RandomState(3)
    w, h = src
    smooth = np.clip(np.cumsum(rng.randn(h, w, 3) * 9, 1) + 128, 0,
                     255).astype(np.uint8)
    noise = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    for img in (smooth, noise, noise[..., 0]):
        want = np.asarray(Image.fromarray(img).resize(dst, Image.LANCZOS))
        np.testing.assert_array_equal(lanczos_resize(img, dst), want)


def test_subpixel_grouping_matches_jax():
    from nerfsr_tpu.data import downx_common as jdc

    from nerfsr_torch.data import downx_common as dc
    arr = np.arange(12 * 16 * 3, dtype=np.float32).reshape(12, 16, 3)
    grouped = dc.group_subpixels(arr, 2)
    np.testing.assert_array_equal(grouped, jdc.group_subpixels(arr, 2))
    np.testing.assert_array_equal(dc.ungroup_subpixels(grouped, (12, 16), 2),
                                  arr)
    rgba = np.random.RandomState(8).rand(4, 5, 4).astype(np.float32)
    np.testing.assert_array_equal(dc.blend_white(rgba),
                                  jdc.blend_white(rgba))


def test_jet_is_opencvs():
    ramp = np.arange(256, dtype=np.uint8)[None]
    want = cv2.cvtColor(cv2.applyColorMap(ramp, cv2.COLORMAP_JET),
                        cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(depth2im(ramp / 255.0 + 1e-4, 0.0, 1.0),
                                  want)


def test_gif_reads_back_through_imageio(tmp_path):
    rng = np.random.RandomState(4)
    frames = [(rng.rand(19, 23, 3) * 255).astype(np.uint8) for _ in range(2)]
    frames.append(np.full((19, 23, 3), (10, 200, 30), np.uint8))
    frames.append(frames[2][..., 0])                   # gray
    path = str(tmp_path / "a.gif")
    shown = write_gif(path, frames)
    read = imageio.mimread(path)
    assert len(read) == len(frames) == len(shown)
    for a, b in zip(read, shown):
        np.testing.assert_array_equal(np.asarray(a)[..., :3], b)
    np.testing.assert_array_equal(shown[2], frames[2])  # few colours: exact
    im = Image.open(path)
    for i in range(im.n_frames):
        im.seek(i)
        assert im.info["duration"] == 100
    # a smooth frame's cube quantization stays near it
    assert np.abs(shown[0].astype(int) - frames[0]).max() <= 26


def test_save_visuals_writes_each_kind(tmp_path):
    img = np.random.RandomState(5).rand(6, 8, 3).astype(np.float32)
    depth = np.linspace(0, 1, 48, dtype=np.float32).reshape(6, 8)
    save_visuals([Visualizee("image", img, "a"),
                  Visualizee("images", [img, img], "b"),
                  Visualizee("gif", [img, img * 0.5], "c"),
                  Visualizee("matrix", depth, "d", range=(0, 1)),
                  Visualizee("pc", np.random.rand(5, 6), "e")],
                 str(tmp_path))
    names = set(os.listdir(tmp_path))
    assert {"a.png", "b-0.png", "b-1.png", "c.gif", "d.npz", "d.png",
            "e.ply"} <= names
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "a.png")),
        (np.clip(img, 0, 1) * 255).astype(np.uint8))
    np.testing.assert_array_equal(np.load(tmp_path / "d.npz")["matrix"],
                                  depth)
    page = write_gallery(str(tmp_path), title="t")
    assert "c.gif" in open(page).read()
    null = NullMetricsWriter()
    null.add_scalars({"a": 1.0}, 0)
    null.close()
    assert set(os.listdir(tmp_path)) == names | {"index.html"}


# ---------------------------------------------------------------------
# SSIM
# ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ssim_matches_jax(seed):
    rng = np.random.RandomState(seed)
    a = rng.rand(40, 40, 3).astype(np.float32)
    b = np.clip(a + rng.randn(40, 40, 3) * 0.1 * (seed + 1), 0,
                1).astype(np.float32)
    assert abs(float(ssim(torch.from_numpy(a), torch.from_numpy(b)))
               - float(j_ssim(a, b))) < 1e-5
    small = (a[:7, :9], b[:7, :9])            # the window shrinks to 7
    assert abs(float(ssim(*map(torch.from_numpy, small)))
               - float(j_ssim(*small))) < 1e-5


# ---------------------------------------------------------------------
# the dataset
# ---------------------------------------------------------------------

def _opts(scene, **extra):
    kw = dict(model="nerf_downX", dataset_mode="llff_downX",
              dataset_root=scene, img_wh=(32, 24), downscale=2,
              fast_preset="llff")
    kw.update(extra)
    return default_options("train", **kw), j_default_options("train", **kw)


def _same_sample(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if v is None:
            assert got[k] is None
        elif k in ("rgbs", "rgbs_ori", "rgbs_sr"):
            np.testing.assert_array_equal(got[k], v, err_msg=k)  # exact
        else:
            np.testing.assert_allclose(got[k], v, atol=1e-6, err_msg=k)


OPTIONS = {"plain": {}, "unified_dir": dict(unified_dir=True),
           "subset": dict(use_subset=True, subset_num=3),
           "resize": dict(img_wh=(24, 18)),
           "avg": dict(ds_method="avg", include_var=True)}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_dataset_matches_jax_in_every_mode(scene, option):
    opt, jopt = _opts(scene, **OPTIONS[option])
    for mode in ("train", "val", "test", "test_train"):
        ds, jds = LLFFDownXDataset(opt, mode), JDataset(jopt, mode)
        assert len(ds) == len(jds) and ds.val_idx == jds.val_idx
        assert ds.depth_bounds == jds.depth_bounds
        np.testing.assert_array_equal(ds.eval_dirs(), jds.eval_dirs())
        if mode == "train":
            _same_sample(ds.ray_buffer(), jds.ray_buffer())
            continue
        for i in {0, len(ds) - 1}:
            _same_sample(ds.image_rays(i), jds.image_rays(i))
            spec, jspec = ds.eval_raygen_spec(i), jds.eval_raygen_spec(i)
            assert spec["geom"] == jspec["geom"]
            np.testing.assert_array_equal(spec["c2w"], jspec["c2w"])


def test_dataset_spheric_and_sisr_match_jax(scene, tmp_path):
    sisr = tmp_path / "sisr"
    sisr.mkdir()
    rng = np.random.RandomState(6)
    for i in range(5):
        Image.fromarray((rng.rand(24, 32, 3) * 255).astype(np.uint8)).save(
            sisr / f"{i:02d}.png")
    opt, jopt = _opts(scene, spheric_poses=True, sisr_path=str(sisr))
    _same_sample(LLFFDownXDataset(opt, "train").ray_buffer(),
                 JDataset(jopt, "train").ray_buffer())
    ds, jds = LLFFDownXDataset(opt, "test"), JDataset(jopt, "test")
    assert ds.depth_bounds == jds.depth_bounds
    _same_sample(ds.image_rays(3), jds.image_rays(3))
    assert ds.eval_raygen_spec(3)["geom"] == jds.eval_raygen_spec(3)["geom"]


def test_dataset_refuses_what_is_not_ported(scene):
    opt, jopt = _opts(scene, ref_idx=2)
    # the reg_patch and gan modes are ported: the train split's length
    for mode in ("reg_patch", "gan"):
        assert len(create_dataset(opt, mode)) == len(JDataset(jopt, mode))
    # --with_ref's reference buffer: grouped rays with grouped colours
    _same_sample(LLFFDownXDataset(opt, "train").ref_buffer(),
                 JDataset(jopt, "train").ref_buffer())
    # every dataset mode of the JAX package's registry is ported, and an
    # unknown mode is not found
    for mode in ("llff", "blender", "blender_downX", "llff_refine"):
        assert mode in DATASET_REGISTRY
    opt.dataset_mode = "no_such_mode"
    with pytest.raises(KeyError, match="not found"):
        create_dataset(opt, "train")
    with pytest.raises(ValueError, match="modes"):
        LLFFDownXDataset(opt, "no_such_split")
