"""The port's image reading (``nerfsr_torch/utils/image.py``) against PIL
and the JAX package on the CPU, exactly (tolerance 0 on pixels):

- ``image.read``/``read_rgb`` tell PNG from JPEG by the first bytes and
  give ``np.asarray(Image.open(f))`` and ``convert("RGB")``;
- Adam7-interlaced PNGs of every colour type and depth, and 16-bit RGB
  and RGBA, against PIL; 16-bit gray still refuses by name;
- the port's ``load_image`` against the JAX package's on JPEGs;
- the slice as a whole: the JAX ``LLFFDownXDataset`` and ``LLFFDataset``
  against the port's on a PIL-written JPEG COLMAP scene, pixels bit for
  bit (rays within the 1e-6 the datasets' parity tests hold them to);
- the committed fixture ``tests/data/jpeg_fixture/`` (what the card
  checks the port against): its digests still equal PIL's and the JAX
  package's here, and the port reads the files to them.
"""

import hashlib
import io
import json
import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads in a test worker)
from PIL import Image

from nerfsr_tpu.config import default_options as j_default_options
from nerfsr_tpu.data import create_dataset as j_create_dataset
from nerfsr_tpu.data.blender import load_image as j_load_image

from nerfsr_torch.config import default_options
from nerfsr_torch.data import create_dataset
from nerfsr_torch.data.downx_common import load_image
from nerfsr_torch.data.synthetic import write_llff_scene
from nerfsr_torch.utils import image, png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
sys.path.insert(0, DATA)
import make_jpeg_fixture as fixture  # noqa: E402

RAY_ATOL = 1e-6


def _jpeg(img, **options) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **options)
    return buf.getvalue()


def _pil(path):
    with Image.open(path) as im:
        return np.asarray(im), im.mode, np.asarray(im.convert("RGB"))


# ---------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------

def test_read_sniffs_the_format_not_the_name(tmp_path):
    rgb = fixture.pattern(37, 23, seed=1)
    gray = fixture.pattern(37, 23, gray=True, seed=2)
    pal = Image.fromarray(rgb).quantize(colors=16)
    files = {"IMG_4026.JPG": _jpeg(rgb, quality=90),
             "gray.jpeg": _jpeg(gray, progressive=True),
             "jpeg_named.png": _jpeg(rgb, subsampling="4:4:4"),
             "palette.png": None, "rgba.png": None, "la.png": None}
    for name, data in files.items():
        path = tmp_path / name
        if data is not None:
            path.write_bytes(data)
    pal.save(tmp_path / "palette.png", transparency=3)
    Image.fromarray(np.dstack([rgb, gray])).save(tmp_path / "rgba.png")
    Image.fromarray(np.dstack([gray, 255 - gray])).save(tmp_path / "la.png")
    for name in files:
        px, mode, rgb_want = _pil(tmp_path / name)
        got = image.read(str(tmp_path / name))
        assert got.mode == mode, name
        np.testing.assert_array_equal(got.pixels, px, err_msg=name)
        np.testing.assert_array_equal(image.read_rgb(str(tmp_path / name)),
                                      rgb_want, err_msg=name)
    (tmp_path / "x.bmp").write_bytes(b"BM" + bytes(64))
    with pytest.raises(ValueError, match="not a PNG or JPEG"):
        image.read(str(tmp_path / "x.bmp"))
    with pytest.raises(ValueError, match="utils.image"):
        png.decode(files["IMG_4026.JPG"])


# ---------------------------------------------------------------------
# PNG: Adam7 and 16-bit RGB/RGBA, written here, read by PIL and the port
# ---------------------------------------------------------------------

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _filtered(rows, bpp):
    """Scanlines (list of bytes) with the five filters in turn."""
    out, prev = [], bytes(len(rows[0]))
    for y, raw in enumerate(rows):
        f = y % 5
        line = bytearray()
        for i, x in enumerate(raw):
            a = raw[i - bpp] if i >= bpp else 0
            b, c = prev[i], prev[i - bpp] if i >= bpp else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][f]
            line.append((x - pred) & 0xFF)
        out.append(bytes([f]) + bytes(line))
        prev = raw
    return b"".join(out)


def _scanlines(samples, depth):
    """(h, w, c) integer samples -> packed big-endian scanlines."""
    h, w, c = samples.shape
    if depth == 16:
        return [samples[y].astype(">u2").tobytes() for y in range(h)]
    if depth == 8:
        return [samples[y].astype(np.uint8).tobytes() for y in range(h)]
    bits = ((samples[..., 0][..., None] >> np.arange(depth - 1, -1, -1))
            & 1).reshape(h, w * depth).astype(np.uint8)
    return [np.packbits(bits[y]).tobytes() for y in range(h)]


def _png(samples, depth, ctype, interlace, palette=None):
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    if interlace:
        raw = b""
        for x0, y0, dx, dy in png._ADAM7:
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                raw += _filtered(_scanlines(sub, depth), bpp)
    else:
        raw = _filtered(_scanlines(samples, depth), bpp)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    out = png.SIGNATURE + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", palette.tobytes())
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


PNG_KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (2, 8), (2, 16), (3, 1),
             (3, 2), (3, 4), (3, 8), (4, 8), (6, 8), (6, 16)]


@pytest.mark.parametrize("interlace", [1, 0], ids=["adam7", "plain"])
@pytest.mark.parametrize("ctype,depth", PNG_KINDS,
                         ids=[f"type{t}-{d}bit" for t, d in PNG_KINDS])
def test_png_is_pils_bytes(ctype, depth, interlace):
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    rng = np.random.RandomState(ctype * 17 + depth)
    palette = None
    if ctype == 3:
        palette = rng.randint(0, 256, (1 << min(depth, 8), 3)).astype(
            np.uint8)
    for w, h in [(13, 11), (1, 1), (3, 2), (9, 17)]:
        samples = rng.randint(0, 1 << depth, (h, w, channels))
        data = _png(samples, depth, ctype, interlace, palette)
        with Image.open(io.BytesIO(data)) as im:
            if im.mode == "1":       # PIL's bilevel mode; the port reads L
                im = im.convert("L")
            want, mode = np.asarray(im), im.mode
            want_rgb = np.asarray(im.convert("RGB"))
        got = png.decode(data)
        assert got.mode == mode
        np.testing.assert_array_equal(got.pixels, want)
        np.testing.assert_array_equal(got.to_rgb(), want_rgb)
        if depth == 16:              # PIL keeps the high byte
            np.testing.assert_array_equal(got.pixels, samples >> 8)


@pytest.mark.parametrize("ctype", [0, 4], ids=["gray", "gray-alpha"])
def test_png_16bit_gray_still_refuses(ctype):
    channels = 1 if ctype == 0 else 2
    samples = np.random.RandomState(0).randint(0, 65536, (5, 7, channels))
    for interlace in (0, 1):
        with pytest.raises(NotImplementedError, match="16-bit gray"):
            png.decode(_png(samples, 16, ctype, interlace))


# ---------------------------------------------------------------------
# load_image against the JAX package's
# ---------------------------------------------------------------------

@pytest.mark.parametrize("wh", [(50, 30), (25, 15), (64, 40)],
                         ids=["source-size", "down", "up"])
def test_load_image_of_jpegs_matches_jax(tmp_path, wh):
    for name, img, options in [
            ("rgb.jpg", fixture.pattern(50, 30, seed=3), dict(quality=90)),
            ("prog.JPG", fixture.pattern(50, 30, seed=4),
             dict(progressive=True, subsampling="4:2:2")),
            ("gray.jpg", fixture.pattern(50, 30, gray=True, seed=5), {})]:
        path = str(tmp_path / name)
        Image.fromarray(img).save(path, "JPEG", **options)
        want = j_load_image(path, wh)
        got = load_image(path, wh)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=name)


# ---------------------------------------------------------------------
# the slice: the datasets on a JPEG COLMAP scene
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def jpeg_scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("jpeg_scene"))
    poses = fixture.scene_poses(6)
    w, h = 64, 48
    images = np.stack([fixture.pattern(w, h, seed=i) for i in range(6)])
    pts, cols = fixture.plane_points(8)

    def save(path, img, i):
        Image.fromarray(img).save(path, "JPEG", quality=90,
                                  subsampling="4:2:0", progressive=i == 1,
                                  restart_marker_rows=1 if i == 2 else 0)
    write_llff_scene(root, poses, images, 52.0, pts, cols, ext="jpg",
                     save=save)
    return root


def _same(got, want):
    """Pixels bit for bit, rays within RAY_ATOL (JAX's buffers carry a
    ``viewdirs`` copy of ``directions`` that the port's leave out)."""
    want = {k: v for k, v in want.items() if k != "viewdirs"}
    got = {k: v for k, v in got.items() if k != "viewdirs"}
    assert set(got) == set(want)
    for k, v in want.items():
        if v is None:
            assert got[k] is None
        elif k.startswith("rgbs") or k == "valid_mask":
            assert got[k].dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=0, atol=RAY_ATOL,
                                       err_msg=k)


CASES = {
    "llff_downX-x2-lanc": dict(model="nerf_downX", dataset_mode="llff_downX",
                               downscale=2, img_wh=(32, 24),
                               ds_method="lanc", include_var=True),
    "llff_downX-x2-avg-source-size": dict(
        model="nerf_downX", dataset_mode="llff_downX", downscale=2,
        img_wh=(64, 48), ds_method="avg"),
    "llff": dict(model="nerf", dataset_mode="llff", img_wh=(32, 24)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_datasets_on_a_jpeg_scene_match_jax(jpeg_scene, case):
    kw = dict(CASES[case], dataset_root=jpeg_scene)
    opt, jopt = default_options("train", **kw), j_default_options("train",
                                                                   **kw)
    for mode in ("train", "val", "test_train"):
        ds, jds = create_dataset(opt, mode), j_create_dataset(jopt, mode)
        assert len(ds) == len(jds)
        if mode == "train":
            _same(ds.ray_buffer(), jds.ray_buffer())
            continue
        for i in {0, len(ds) - 1}:
            _same(ds.image_rays(i), jds.image_rays(i))


# ---------------------------------------------------------------------
# the committed fixture the card checks the port against
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def digests():
    with open(fixture.DIGESTS) as f:
        return json.load(f)


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def test_fixture_digests_are_pils_and_the_ports(digests):
    assert os.path.getsize(fixture.DIGESTS) + sum(
        os.path.getsize(os.path.join(d, f))
        for d, _, fs in os.walk(fixture.FIXTURE) for f in fs) \
        < fixture.SIZE_LIMIT
    files = sorted(os.path.relpath(os.path.join(d, f), fixture.FIXTURE)
                   for d, _, fs in os.walk(fixture.FIXTURE) for f in fs
                   if f.endswith(".jpg"))
    assert files == sorted(digests["pil"])
    assert {f"decode/{n}.jpg" for n in fixture.CASES} <= set(files)
    for rel in files:
        path = os.path.join(fixture.FIXTURE, rel)
        want = digests["pil"][rel]
        px, mode, _ = _pil(path)
        assert (_sha(px), mode, list(px.shape)) == (
            want["sha256"], want["mode"], want["shape"]), rel
        got = image.read(path)
        assert (_sha(got.pixels), got.mode) == (want["sha256"],
                                               want["mode"]), rel


def test_fixture_scene_digests_are_jaxs_and_the_ports(digests):
    scene = os.path.join(fixture.FIXTURE, "scene")
    wh = tuple(digests["img_wh"])
    for view, want in digests["load_image"].items():
        path = os.path.join(scene, "images", view)
        assert _sha(j_load_image(path, wh)) == want, view
        assert _sha(load_image(path, wh)) == want, view
    options = dict(digests["options"], img_wh=tuple(
        digests["options"]["img_wh"]), dataset_root=scene)
    jbuf = j_create_dataset(j_default_options("train", **options),
                            "train").ray_buffer()
    buf = create_dataset(default_options("train", **options),
                         "train").ray_buffer()
    for k, want in digests["dataset"].items():
        for a in (np.asarray(jbuf[k]), buf[k]):
            assert (_sha(a), list(a.shape), a.dtype.str) == (
                want["sha256"], want["shape"], want["dtype"]), k


def test_fixture_generator_still_writes_the_scene(tmp_path):
    """The generator's scene today is the committed one, byte for byte."""
    fixture.write_scene(str(tmp_path))
    committed = os.path.join(fixture.FIXTURE, "scene")
    for d, _, fs in os.walk(committed):
        for f in fs:
            rel = os.path.relpath(os.path.join(d, f), committed)
            with open(os.path.join(d, f), "rb") as a, \
                    open(tmp_path / rel, "rb") as b:
                assert a.read() == b.read(), rel
