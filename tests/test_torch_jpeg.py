"""The port's JPEG decoder (``nerfsr_torch/utils/jpeg.py``, C in
``csrc_host/jpeg_decode.c``) against PIL on the CPU, byte for byte
(tolerance 0: equal uint8 pixels), and the host library it is built in:

- the case matrix: 4:4:4 / 4:2:2 / 4:2:0 / gray x baseline / progressive
  x sizes x quality 50 / 95, then optimized Huffman tables, restart
  intervals, EXIF and ICC segments, Adobe RGB, 16-bit quantization
  tables (an extended-sequential frame), the sizes where libjpeg's
  upsampler switches between replication and its triangle filters, and
  one 4032x3024 image;
- truncated and corrupt streams raise ``ValueError``, and so do the
  refused frame types and layouts, by name; flipped bytes only ever
  raise or decode;
- ``utils/hostlib.py``: one library from every source, built by
  processes that race to build it.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads in a test worker)
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image, ImageCms

from nerfsr_torch.utils import hostlib, jpeg

LAYOUTS = ["4:4:4", "4:2:2", "4:2:0", "gray"]
SIZES = [(1, 1), (7, 5), (17, 9), (33, 31), (250, 187)]


def card(w, h, gray=False, seed=0, noise=12.0):
    """A test card with edges, gradients and noise: uint8 (h, w[, 3])."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([128 + 90 * np.sin(x / 6.0 + k) * np.cos(y / 4.0 - k)
                    for k in range(3)], -1)
    img[(x > w / 3) & (y < h / 2)] = (30, 200, 90)
    img += rng.randn(h, w, 3) * noise
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if gray else img


def encode(img, **options) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **options)
    return buf.getvalue()


def assert_pil_bytes(data: bytes):
    with Image.open(io.BytesIO(data)) as im:
        want, mode = np.asarray(im), im.mode
    got, got_mode = jpeg.decode(data)
    assert got_mode == mode and got.dtype == np.uint8
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert jpeg.header(data) == (want.shape[1], want.shape[0],
                                 1 if want.ndim == 2 else 3)


@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_decode_is_pils_bytes(layout, progressive, size, quality):
    gray = layout == "gray"
    options = dict(quality=quality, progressive=progressive)
    if not gray:
        options["subsampling"] = layout
    assert_pil_bytes(encode(card(*size, gray=gray, seed=size[0]), **options))


def _exif():
    exif = Image.Exif()
    exif[0x010F] = "Canon"
    exif[0x0110] = "EOS"
    exif[0x0112] = 6           # orientation: PIL's open does not apply it
    return exif.tobytes()


EXTRAS = {
    "optimize": dict(optimize=True),
    "optimize-progressive": dict(optimize=True, progressive=True),
    "restart-blocks": dict(restart_marker_blocks=3),
    "restart-blocks-progressive": dict(restart_marker_blocks=5,
                                       progressive=True),
    "restart-rows-422": dict(restart_marker_rows=1, subsampling="4:2:2"),
    "restart-rows-progressive-444": dict(restart_marker_rows=2,
                                         subsampling="4:4:4",
                                         progressive=True),
    "exif": dict(exif="exif"),
    "icc-progressive": dict(icc="srgb", progressive=True),
    "adobe-rgb": dict(keep_rgb=True, subsampling="4:4:4"),
    "adobe-rgb-progressive": dict(keep_rgb=True, progressive=True),
    "qtables-16bit": dict(qtables=[[300] * 64, [40] * 64]),
    "qtables-16bit-progressive": dict(qtables=[[300] * 64, [40] * 64],
                                      progressive=True),
    "quality-1": dict(quality=1),
    "quality-100-444": dict(quality=100, subsampling="4:4:4"),
}


@pytest.mark.parametrize("name", sorted(EXTRAS))
def test_decode_options_are_pils_bytes(name):
    options = dict(EXTRAS[name])
    if options.get("exif") == "exif":
        options["exif"] = _exif()
    if options.pop("icc", None):
        options["icc_profile"] = ImageCms.ImageCmsProfile(
            ImageCms.createProfile("sRGB")).tobytes()
    data = encode(card(250, 187, seed=3), **options)
    if "qtables" in options:                # 16-bit DQT entries
        dqt = _segment(data, 0xDB)
        assert data[dqt + 4] >> 4 == 1
        if not options.get("progressive"):
            assert b"\xff\xc1" in data      # so an extended-sequential SOF
    if "restart_marker_blocks" in options or "restart_marker_rows" in \
            options:
        assert b"\xff\xdd" in data and b"\xff\xd0" in data
    assert_pil_bytes(data)


# libjpeg's upsampler replicates chroma while a row holds <= 2 of its
# samples, and filters from 3: widths 1-6 cross the switch, heights the
# vertical edge
@pytest.mark.parametrize("layout", ["4:2:2", "4:2:0"])
@pytest.mark.parametrize("size", [(2, 1), (3, 3), (4, 2), (5, 6), (6, 1),
                                  (9, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_upsampling_edges_are_pils_bytes(layout, size):
    for progressive in (False, True):
        assert_pil_bytes(encode(card(*size, seed=7), subsampling=layout,
                                quality=95, progressive=progressive))


def test_camera_sized_image_is_pils_bytes():
    """4032x3024, the size of nerf_llff_data's originals."""
    img = card(4032, 3024, noise=3.0)
    assert_pil_bytes(encode(img, quality=90, subsampling="4:2:0"))


# ---------------------------------------------------------------------
# broken files and refusals
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def samples():
    img = card(61, 43, seed=1)
    return {"baseline": encode(img, quality=90),
            "progressive": encode(img, quality=90, progressive=True),
            "restart": encode(img, quality=90, progressive=True,
                              restart_marker_blocks=2)}


@pytest.mark.parametrize("kind", ["baseline", "progressive", "restart"])
def test_truncated_files_raise(samples, kind):
    data = samples[kind]
    with pytest.raises(OSError, match="truncated"):   # PIL, for the record
        Image.open(io.BytesIO(data[:-2])).load()
    for cut in list(range(0, len(data), 37)) + [len(data) - 1]:
        with pytest.raises(ValueError):
            jpeg.decode(data[:cut])
    with pytest.raises(ValueError, match="truncated"):
        jpeg.decode(data[:-2])                   # no EOI
    with pytest.raises(ValueError, match="truncated"):
        jpeg.decode(data[:len(data) * 3 // 4])   # inside a scan


def _segment(data: bytes, marker: int) -> int:
    """Offset of the first marker segment ``FF marker``."""
    return data.index(bytes([0xFF, marker]))


def test_corrupt_streams_raise(samples):
    data = samples["baseline"]
    sos = _segment(data, 0xDA)
    start = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    # a marker in the middle of the entropy-coded data ends it early
    cut = data[:start + 40] + b"\xff\xd9"
    with pytest.raises(ValueError, match="corrupt"):
        jpeg.decode(cut)
    # restart markers out of order
    rst = bytearray(samples["restart"])
    at = rst.index(b"\xff\xd0")
    rst[at + 1] = 0xD3
    with pytest.raises(ValueError, match="RST0"):
        jpeg.decode(bytes(rst))
    # a Huffman table whose last code is all ones
    dht = _segment(data, 0xC4)
    bad = bytearray(data)
    bad[dht + 5:dht + 21] = bytes([2] + [0] * 15)   # two 1-bit codes
    with pytest.raises(ValueError, match="Huffman table"):
        jpeg.decode(bytes(bad))
    # not a JPEG at all
    with pytest.raises(ValueError, match="no SOI"):
        jpeg.decode(b"\x89PNG\r\n\x1a\n" + data)


def _patched_sof(data: bytes, marker=None, precision=None, height=None,
                 sampling=None) -> bytes:
    out = bytearray(data)
    at = next(data.index(bytes([0xFF, m])) for m in (0xC0, 0xC1, 0xC2)
              if bytes([0xFF, m]) in data)
    if marker is not None:
        out[at + 1] = marker
    if precision is not None:
        out[at + 4] = precision
    if height is not None:
        out[at + 5:at + 7] = height.to_bytes(2, "big")
    for i, hv in enumerate(sampling or ()):
        out[at + 11 + 3 * i] = hv
    return bytes(out)


def test_refusals_raise_by_name(samples):
    data = samples["baseline"]
    cases = [
        (dict(marker=0xC9), "arithmetic"),
        (dict(marker=0xCA), "arithmetic"),
        (dict(marker=0xC3), "lossless"),
        (dict(marker=0xC5), "hierarchical"),
        (dict(precision=12), "12-bit"),
        (dict(height=0), "DNL"),
        (dict(sampling=[0x12, 0x11, 0x11]), "sampling layout"),   # 4:4:0
        (dict(sampling=[0x41, 0x11, 0x11]), "sampling layout"),   # 4:1:1
        (dict(sampling=[0x22, 0x21, 0x11]), "sampling layout"),
    ]
    for patch, name in cases:
        bad = _patched_sof(data, **patch)
        with pytest.raises(ValueError, match=name):
            jpeg.decode(bad)
        with pytest.raises(ValueError, match=name):
            jpeg.header(bad)
    gray = encode(card(16, 16, gray=True))
    with pytest.raises(ValueError, match="gray"):
        jpeg.decode(_patched_sof(gray, sampling=[0x22]))
    buf = io.BytesIO()
    Image.new("CMYK", (16, 16), (10, 20, 30, 40)).save(buf, "JPEG")
    with pytest.raises(ValueError, match="CMYK"):
        jpeg.decode(buf.getvalue())
    # a progression that stops before its last refinement: libjpeg
    # would smooth the blocks, and the port refuses it
    prog = samples["progressive"]
    last = prog.rindex(b"\xff\xda")
    with pytest.raises(ValueError, match="unrefined"):
        jpeg.decode(prog[:last] + b"\xff\xd9")


@settings(max_examples=50, deadline=None)
@given(flips=st.lists(st.tuples(st.floats(0, 1, exclude_max=True),
                                st.integers(0, 7)), min_size=1, max_size=4),
       kind=st.sampled_from(["baseline", "progressive", "restart"]))
def test_flipped_bytes_raise_or_decode(samples, flips, kind):
    data = bytearray(samples[kind])
    for pos, bit in flips:
        data[int(pos * len(data))] ^= 1 << bit
    try:
        px, mode = jpeg.decode(bytes(data))
    except ValueError:
        return
    assert px.dtype == np.uint8 and mode in ("L", "RGB")


# ---------------------------------------------------------------------
# the host library
# ---------------------------------------------------------------------

def test_host_library_holds_every_source():
    names = {s.name for s in hostlib.sources()}
    assert {"jpeg_decode.c", "zstd_decode.c"} <= names
    lib = hostlib.lib()
    for fn in ("nerfsr_jpeg_decode", "nerfsr_jpeg_header",
               "nerfsr_zstd_decompress", "nerfsr_crc32c"):
        assert hasattr(lib, fn)
    assert hostlib.build().name.startswith("libnerfsr_host-")


def test_racing_builds_give_one_library(tmp_path):
    """Four processes build into one empty directory at once: each loads
    a whole library, and one file is left."""
    code = ("import sys; from pathlib import Path; "
            "from nerfsr_torch.utils import hostlib, jpeg; "
            "hostlib.BUILD = Path(sys.argv[1]); "
            "print(hostlib.build().name); "
            "print(jpeg.header(open(sys.argv[2], 'rb').read()))")
    sample = tmp_path / "x.jpg"
    sample.write_bytes(encode(card(9, 7)))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    procs = [subprocess.Popen([sys.executable, "-c", code,
                               str(tmp_path / "_build"), str(sample)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert len({o[0] for o in outs}) == 1
    assert all("(9, 7, 3)" in o[0] for o in outs)
    assert [f.name for f in (tmp_path / "_build").iterdir()] == [
        outs[0][0].split()[0]]
