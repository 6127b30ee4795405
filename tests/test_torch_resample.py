"""PIL's Lanczos resize in the port's host C
(``nerfsr_torch/csrc_host/resample.c`` behind
``data/downx_common.py:lanczos_resize``) on the CPU: byte for byte
against PIL's ``Image.resize(size, Image.LANCZOS)`` and against the numpy
version kept as the oracle (``_lanczos_resize_np``), over L, LA, RGB and
RGBA (LA and RGBA through PIL's premultiplied modes), down and up, from
1x1 to 33x31, a one-pixel axis, one axis only, and a camera original's
4032x3024 -> 504x378 (C and PIL only: the numpy takes seconds there).
"""

import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads in a test worker)
from PIL import Image

from nerfsr_torch.data.downx_common import _lanczos_resize_np, lanczos_resize

MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}
# (source w, h) -> (target w, h)
CASES = [((1, 1), (5, 4)), ((7, 5), (3, 2)), ((7, 5), (16, 11)),
         ((33, 31), (8, 7)), ((33, 31), (70, 65)), ((33, 31), (1, 1)),
         ((1, 9), (3, 4)), ((9, 1), (4, 1)), ((33, 31), (33, 12)),
         ((33, 31), (12, 31))]


def _pixels(rng, mode, w, h):
    """Random uint8 pixels; an alpha channel is 0, 255 or between, a
    third each, so the premultiplied round trip meets every branch."""
    c = MODES[mode]
    img = (rng.rand(h, w, c) * 256).astype(np.uint8)
    if mode in ("LA", "RGBA"):
        pick = rng.randint(0, 3, (h, w))
        img[..., -1] = np.where(pick == 0, 0, np.where(
            pick == 1, 255, img[..., -1]))
    return img[..., 0] if c == 1 else img


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_resize_is_pils_bytes(mode, case):
    (sw, sh), (dw, dh) = CASES[case]
    img = _pixels(np.random.RandomState(100 * case + MODES[mode]), mode, sw,
                  sh)
    want = np.asarray(Image.fromarray(img, mode).resize((dw, dh),
                                                        Image.LANCZOS))
    got = lanczos_resize(img, (dw, dh))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_lanczos_resize_np(img, (dw, dh)), want)


def test_camera_original_to_the_working_size():
    """4032x3024 RGB -> 504x378, the resize every nerf_llff_data view
    takes: the C gives PIL's bytes."""
    rng = np.random.RandomState(0)
    # smooth content with noise, as a photograph, rather than pure noise
    yy, xx = np.mgrid[0:3024, 0:4032].astype(np.float32)
    base = 127 + 100 * np.sin(xx / 211.0)[..., None] * np.cos(
        yy / 97.0)[..., None] * np.array([1.0, 0.6, -0.8], np.float32)
    img = np.clip(base + rng.randint(-20, 21, (3024, 4032, 3)), 0,
                  255).astype(np.uint8)
    want = np.asarray(Image.fromarray(img).resize((504, 378),
                                                  Image.LANCZOS))
    np.testing.assert_array_equal(lanczos_resize(img, (504, 378)), want)


def test_resize_refusals_and_identity():
    img = np.zeros((4, 5, 3), np.uint8)
    with pytest.raises(TypeError, match="uint8"):
        lanczos_resize(img.astype(np.float32), (2, 2))
    with pytest.raises(ValueError, match="refused"):
        lanczos_resize(np.zeros((4, 5, 5), np.uint8), (2, 2))
    same = lanczos_resize(img, (5, 4))
    assert same is not img and np.array_equal(same, img)
