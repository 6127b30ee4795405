"""Image files as PIL opens them, PNG or JPEG.

The port's counterpart of ``PIL.Image.open`` where the JAX package reads
a scene's images (``data/blender.py:load_image``,
``data/llff_downx.py:_load_pair``). The format is told by the file's
first bytes, not its name (``nerf_llff_data`` ships ``IMG_4026.JPG``):
PNG through ``utils/png.py``, JPEG through ``utils/jpeg.py``.
``read`` gives what ``np.asarray(Image.open(path))`` gives, with the
mode and a palette image's palette; ``read_rgb`` what
``Image.open(path).convert("RGB")`` gives.
"""

from __future__ import annotations

import numpy as np

from nerfsr_torch.utils import jpeg, png


def decode(data: bytes) -> png.PNGImage:
    """The pixels, PIL's mode and (for a palette PNG) the palette of PNG
    or JPEG bytes."""
    if data[:8] == png.SIGNATURE:
        return png.decode(data)
    if data[:3] == jpeg.SOI:
        return png.PNGImage(*jpeg.decode(data))
    raise ValueError(f"not a PNG or JPEG file (first bytes {data[:8]!r})")


def read(path: str) -> png.PNGImage:
    with open(path, "rb") as f:
        return decode(f.read())


def read_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 of a PNG or JPEG file, as PIL's
    ``convert("RGB")``."""
    return read(path).to_rgb()
