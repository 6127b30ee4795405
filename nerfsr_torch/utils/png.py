"""PNG reader and writer with numpy and the standard library's zlib.

The port's counterpart of PIL's PNG codec where the JAX package opens
and saves images (``data/llff_downx.py:_load_pair``,
``data/blender.py:load_image``, ``utils/visualizer.py:save_visuals``).

``decode`` reads PNGs of bit depth 8 (and the 1-, 2- and 4-bit depths of
gray and palette files): gray, gray+alpha, RGB, RGBA and palette, plain
or Adam7-interlaced, with all five row filters, and checks every chunk's
CRC. 16-bit RGB and RGBA come out as their high bytes, as PIL opens them
(mode RGB/RGBA). 16-bit gray and gray+alpha raise by name (PIL opens
them as I;16 and RGBA), as do JPEG bytes (``utils/image.py`` reads
both formats). ``encode`` writes uint8 gray, RGB or RGBA rows unfiltered
through zlib.
"""

from __future__ import annotations

import struct
import zlib
from typing import NamedTuple, Optional

import numpy as np

from nerfsr_torch import spans

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (mode, channels)
_COLOR_TYPES = {0: ("L", 1), 2: ("RGB", 3), 3: ("P", 1), 4: ("LA", 2),
                6: ("RGBA", 4)}


class PNGImage(NamedTuple):
    """Decoded pixels (H, W) for L and P, else (H, W, C) uint8; the mode
    as PIL names it; a palette image's (n, 3) palette and its (n,) alpha
    (255 where the file gives none)."""

    pixels: np.ndarray
    mode: str
    palette: Optional[np.ndarray] = None
    palette_alpha: Optional[np.ndarray] = None

    def to_rgb(self) -> np.ndarray:
        """(H, W, 3) uint8, as PIL's ``convert("RGB")``: gray repeated,
        alpha dropped, palette looked up."""
        px = self.pixels
        if self.mode == "P":
            return self.palette[px]
        if self.mode in ("L", "LA"):
            g = px if px.ndim == 2 else px[..., 0]
            return np.repeat(g[..., None], 3, -1)
        return np.ascontiguousarray(px[..., :3])


def _chunks(data: bytes):
    if data[:3] == b"\xff\xd8\xff":
        raise ValueError("JPEG bytes are not a PNG: read images through "
                         "nerfsr_torch.utils.image, which decodes both")
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("PNG truncated inside a chunk header")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"PNG truncated inside chunk {kind!r}")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG has no IEND chunk")


def _paeth_row(cur: bytearray, prev: bytes, bpp: int):
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        cur[i] = (cur[i] + pred) & 0xFF


def _average_row(cur: bytearray, prev: bytes, bpp: int):
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: (h, stride) uint8 scanlines."""
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG image data has {len(raw)} bytes, expected "
                         f"{h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:        # Sub: running sum along each channel
            pad = (-stride) % bpp
            lane = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(
                -1, bpp).astype(np.int64)
            cur = (np.cumsum(lane, 0) & 0xFF).astype(np.uint8).reshape(
                -1)[:stride]
        elif ftype == 2:        # Up
            cur = line + prev   # uint8 wraps modulo 256
        elif ftype in (3, 4):   # Average, Paeth: serial along the row
            buf = bytearray(line.tobytes())
            (_average_row if ftype == 3 else _paeth_row)(
                buf, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


# Adam7's passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _pass_bytes(w: int, h: int, depth: int, channels: int) -> int:
    return h * ((w * channels * depth + 7) // 8 + 1) if w and h else 0


def _pass_pixels(raw: bytes, w: int, h: int, depth: int, channels: int,
                 mode: str) -> np.ndarray:
    """One image's (or one Adam7 pass's) filtered scanlines -> uint8
    samples, (h, w) for one channel, else (h, w, channels)."""
    bits = channels * depth
    stride = (w * bits + 7) // 8
    rows = _unfilter(raw, h, stride, max(1, bits // 8))
    if depth < 8:
        px = np.unpackbits(rows, axis=1).reshape(h, -1, depth)[:, :w]
        px = (px * (1 << np.arange(depth - 1, -1, -1))).sum(-1).astype(
            np.uint8)
        if mode == "L":        # scale to 8 bits as PIL does
            px = (px.astype(np.int64) * 255 // ((1 << depth) - 1)).astype(
                np.uint8)
        return px
    px = rows.reshape(h, w, channels, depth // 8)[..., 0]  # 16: high byte
    return px[..., 0] if channels == 1 else px


def _adam7(raw: bytes, w: int, h: int, depth: int, channels: int,
           mode: str) -> np.ndarray:
    """An interlaced image: each pass unfiltered on its own, its pixels
    put on its grid."""
    out = np.zeros((h, w, channels)[:2 if channels == 1 else 3], np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)   # 0 if empty
        n = _pass_bytes(pw, ph, depth, channels)
        if n:
            out[y0::dy, x0::dx] = _pass_pixels(raw[pos:pos + n], pw, ph,
                                               depth, channels, mode)
        pos += n
    if pos != len(raw):
        raise ValueError(f"PNG image data has {len(raw)} bytes, expected "
                         f"{pos}")
    return out


def decode(data: bytes) -> PNGImage:
    """Decode PNG bytes (see the module docstring for what is covered)."""
    header, palette, trns, idat = None, None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3).copy()
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8).copy()
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _COLOR_TYPES:
        raise ValueError(f"PNG colour type {ctype} is invalid")
    mode, channels = _COLOR_TYPES[ctype]
    if depth == 16 and mode in ("L", "LA"):
        raise NotImplementedError("16-bit gray and gray+alpha PNGs are "
                                  "not supported (PIL opens them as I;16 "
                                  "and RGBA)")
    if depth != 8 and not (depth in (1, 2, 4) and mode in ("L", "P")) \
            and not (depth == 16 and mode in ("RGB", "RGBA")):
        raise ValueError(f"PNG bit depth {depth} is invalid for {mode}")
    if interlace not in (0, 1):
        raise ValueError(f"PNG interlace method {interlace} is invalid")
    raw = zlib.decompress(b"".join(idat))
    if interlace:
        px = _adam7(raw, w, h, depth, channels, mode)
    else:
        px = _pass_pixels(raw, w, h, depth, channels, mode)
    alpha = None
    if mode == "P":
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        alpha = np.full(len(palette), 255, np.uint8)
        if trns is not None:
            alpha[:len(trns)] = trns[:len(palette)]
        if px.max(initial=0) >= len(palette):
            raise ValueError("PNG pixel index outside its palette")
    return PNGImage(np.ascontiguousarray(px), mode, palette, alpha)


def read(path: str) -> PNGImage:
    with open(path, "rb") as f:
        return decode(f.read())


def read_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 of a PNG file, as PIL's ``convert("RGB")``."""
    return read(path).to_rgb()


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


@spans.spanned("nerfsr.write.encode")
def encode(img: np.ndarray, level: int = 6) -> bytes:
    """PNG bytes of a uint8 (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA
    image (rows unfiltered, zlib at ``level``)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"encode takes uint8 pixels, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    ctype = {1: 0, 3: 2, 4: 6}.get(c)
    if ctype is None:
        raise ValueError(f"encode takes 1, 3 or 4 channels, got {c}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, w * c)], 1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                          0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def write(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode(img))
