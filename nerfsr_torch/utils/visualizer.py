"""Artifacts and scalar logging: PNG strips, GIFs, depth maps, JSONL.

Port of ``nerfsr_tpu/utils/visualizer.py`` with the port's own writers in
place of PIL, imageio and OpenCV: ``Visualizee`` artifacts (image,
images, gif, pc, matrix), ``save_visuals``, ``_write_ply``, ``depth2im``
(a 256-entry JET table equal to ``cv2.COLORMAP_JET``), a GIF89a writer,
and ``MetricsWriter``, the JSONL sink at
``{summary_dir}/{name}/metrics.jsonl`` (no TensorBoard).

The GIF writer gives each frame its own palette: the frame's colours
when it has at most 256, else the 6 x 7 x 6 colour cube (each channel
rounded to its nearest level). Its LZW stream holds 9-bit literal codes
with a clear code every ``_LZW_RUN`` pixels, so the code table never
outgrows 9 bits: valid LZW that any decoder reads, made in numpy.
Frames show for 100 ms (``duration=0.1``), looping forever.
``gif_frame`` encodes one frame and ``gif_bytes`` puts encoded frames
into a file's bytes; ``write_gif`` is the two in turn.

``ViewWriter`` writes a render loop's artifacts on a bounded pool of
threads (``writer_threads``: the CPUs this process may run on, less one
for the loop, from 1 to 8), a view a job: the job builds the view's
visuals, writes each through ``save_visuals``'s code and encodes each
image strip as a frame of its GIF. zlib and numpy's sorts and ufuncs
release the interpreter lock, so the jobs run beside each other and
beside the loop. The loop waits only where ``2k`` views are in flight
(``submit``, span ``nerfsr.write.wait``) and once at its end (``wait``);
``write_gifs`` then writes each GIF from its frames' bytes in view
order. The files are byte for byte those of ``save_visuals`` and
``write_gif`` on the same visuals.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import time
from concurrent import futures
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np

from nerfsr_torch import spans
from nerfsr_torch.utils import png

# ---------------------------------------------------------------------------
# visual artifacts
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Visualizee:
    """A typed artifact. kind: 'image' | 'images' | 'gif' | 'pc' |
    'matrix'; data: HWC array(s) in ``range`` (uint8 passes through), a
    point cloud, or a raw matrix."""

    kind: str
    data: Any
    name: str
    timestamp: bool = False
    range: tuple = (0, 1)
    img_format: str = "png"


def _to_uint8(img, rng=(0, 1)):
    """Display quantization: (v - lo) / (hi - lo), clipped, times 255,
    truncated. uint8 input (quantized on the device) passes through."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    img = img.astype(np.float32)
    lo, hi = rng
    img = (img - lo) / (hi - lo + 1e-12)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _check_png(fmt):
    if fmt != "png":
        raise NotImplementedError(f"image format {fmt!r}: the port writes "
                                  "PNG only")


def save_visuals(visuals: Sequence[Visualizee], out_dir: str,
                 prefix: str = ""):
    """Write each artifact under ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    for v in visuals:
        _save(v, out_dir, prefix)


def _save(v: Visualizee, out_dir: str, prefix: str = ""):
    """Write one artifact under ``out_dir``; returns an image's uint8
    pixels as written (None for the other kinds)."""
    stamp = f"-{int(time.time())}" if v.timestamp else ""
    base = os.path.join(out_dir, f"{prefix}{v.name}{stamp}")
    if v.kind == "image":
        _check_png(v.img_format)
        img = _to_uint8(v.data, v.range)
        png.write(f"{base}.png", img)
        return img
    if v.kind == "images":
        _check_png(v.img_format)
        for i, im in enumerate(v.data):
            png.write(f"{base}-{i}.png", _to_uint8(im, v.range))
    elif v.kind == "gif":
        write_gif(f"{base}.gif", [_to_uint8(im, v.range) for im in v.data])
    elif v.kind == "pc":
        _write_ply(f"{base}.ply", np.asarray(v.data, np.float32))
    elif v.kind == "matrix":
        # the npz is what the warp/refine stage reads
        mat = np.asarray(v.data)
        np.savez(f"{base}.npz", matrix=mat)
        lo, hi = v.range
        png.write(f"{base}.png", depth2im(mat, lo, hi))
    else:
        raise ValueError(f"unknown visual kind {v.kind}")
    return None


def _write_ply(path, pts):
    """ASCII PLY of (N, 3) xyz or (N, 6) xyz + rgb in [0, 1]."""
    has_rgb = pts.shape[-1] >= 6
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if has_rgb:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        for p in pts:
            line = f"{p[0]} {p[1]} {p[2]}"
            if has_rgb:
                rgb = (np.clip(p[3:6], 0, 1) * 255).astype(int)
                line += f" {rgb[0]} {rgb[1]} {rgb[2]}"
            f.write(line + "\n")


# cv2.COLORMAP_JET as RGB, entries 0..255
_JET_HEX = (
    "00008000008400008800008c00009000009400009800009c0000a00000a40000"
    "a80000ac0000b00000b40000b80000bc0000c00000c40000c80000cc0000d000"
    "00d40000d80000dc0000e00000e40000e80000ec0000f00000f40000f80000fc"
    "0000ff0004ff0008ff000cff0010ff0014ff0018ff001cff0020ff0024ff0028"
    "ff002cff0030ff0034ff0038ff003cff0040ff0044ff0048ff004cff0050ff00"
    "54ff0058ff005cff0060ff0064ff0068ff006cff0070ff0074ff0078ff007cff"
    "0080ff0084ff0088ff008cff0090ff0094ff0098ff009cff00a0ff00a4ff00a8"
    "ff00acff00b0ff00b4ff00b8ff00bcff00c0ff00c4ff00c8ff00ccff00d0ff00"
    "d4ff00d8ff00dcff00e0ff00e4ff00e8ff00ecff00f0ff00f4ff00f8ff00fcff"
    "02fffe06fffa0afff60efff212ffee16ffea1affe61effe222ffde26ffda2aff"
    "d62effd232ffce36ffca3affc63effc242ffbe46ffba4affb64effb252ffae56"
    "ffaa5affa65effa262ff9e66ff9a6aff966eff9272ff8e76ff8a7aff867eff82"
    "82ff7e86ff7a8aff768eff7292ff6e96ff6a9aff669eff62a2ff5ea6ff5aaaff"
    "56aeff52b2ff4eb6ff4abaff46beff42c2ff3ec6ff3acaff36ceff32d2ff2ed6"
    "ff2adaff26deff22e2ff1ee6ff1aeaff16eeff12f2ff0ef6ff0afaff06feff01"
    "fffc00fff800fff400fff000ffec00ffe800ffe400ffe000ffdc00ffd800ffd4"
    "00ffd000ffcc00ffc800ffc400ffc000ffbc00ffb800ffb400ffb000ffac00ff"
    "a800ffa400ffa000ff9c00ff9800ff9400ff9000ff8c00ff8800ff8400ff8000"
    "ff7c00ff7800ff7400ff7000ff6c00ff6800ff6400ff6000ff5c00ff5800ff54"
    "00ff5000ff4c00ff4800ff4400ff4000ff3c00ff3800ff3400ff3000ff2c00ff"
    "2800ff2400ff2000ff1c00ff1800ff1400ff1000ff0c00ff0800ff0400ff0000"
    "fc0000f80000f40000f00000ec0000e80000e40000e00000dc0000d80000d400"
    "00d00000cc0000c80000c40000c00000bc0000b80000b40000b00000ac0000a8"
    "0000a40000a000009c00009800009400009000008c0000880000840000800000")
JET = np.frombuffer(bytes.fromhex(_JET_HEX), np.uint8).reshape(256, 3)


def depth2im(depth, near, far):
    """near/far-normalized JET colour map of a depth map: uint8 (H, W, 3)
    RGB."""
    d = np.asarray(depth, np.float32)
    d = (d - near) / max(far - near, 1e-8)
    d = np.clip(d, 0, 1)
    return JET[(d * 255).astype(np.uint8)]


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------

_LZW_RUN = 250           # literals between clear codes (< 254: 9 bits)
_CUBE = np.array([6, 7, 6])


def quantize_frame(frame: np.ndarray):
    """(indices (H, W) uint8, palette (n, 3) uint8, the quantized frame
    (H, W, 3)): the frame's own colours when it has at most 256, else
    the 6 x 7 x 6 colour cube."""
    rgb = np.asarray(frame, np.uint8)
    if rgb.ndim == 2:
        rgb = np.repeat(rgb[..., None], 3, -1)
    flat = rgb[..., :3].reshape(-1, 3)

    def unique(px):         # one int key a colour: a 1-D sort
        key = (px[:, 0].astype(np.int32) << 16) | \
            (px[:, 1].astype(np.int32) << 8) | px[:, 2]
        keys, inv = np.unique(key, return_inverse=True)
        colors = np.stack([keys >> 16, (keys >> 8) & 255, keys & 255], -1)
        return colors.astype(np.uint8), inv

    colors, idx = unique(flat)
    if len(colors) > 256:
        levels = np.rint(flat.astype(np.float64) * (_CUBE - 1) / 255.0)
        colors, idx = unique(np.rint(levels * 255.0 / (_CUBE - 1)).astype(
            np.uint8))
    idx = idx.reshape(rgb.shape[:2]).astype(np.uint8)
    return idx, colors, colors[idx]


def _lzw_literal(indices: np.ndarray) -> bytes:
    """An LZW stream (minimum code size 8) of literal 9-bit codes: clear,
    up to ``_LZW_RUN`` literals, clear, ..., end."""
    px = indices.reshape(-1).astype(np.uint16)
    n_runs = -(-len(px) // _LZW_RUN)
    codes = np.full(len(px) + n_runs + 1, 256, np.uint16)   # clear
    pos = np.arange(len(px)) + np.arange(len(px)) // _LZW_RUN + 1
    codes[pos] = px
    codes[-1] = 257                                         # end
    bits = ((codes[:, None] >> np.arange(9, dtype=np.uint16)) & 1).astype(
        np.uint8).reshape(-1)
    return np.packbits(bits, bitorder="little").tobytes()


def _sub_blocks(data: bytes) -> bytes:
    out = []
    for i in range(0, len(data), 255):
        part = data[i:i + 255]
        out.append(bytes([len(part)]) + part)
    return b"".join(out) + b"\x00"


def gif_frame(frame, delay_ms: int = 100):
    """One uint8 frame (H, W[, 3]) of a GIF: ``((H, W), its bytes, the
    quantized frame they show)``; the bytes are the frame's graphic
    control, image descriptor, colour table and LZW data."""
    f = np.asarray(frame, np.uint8)
    h, w = f.shape[:2]
    with spans.span("nerfsr.write.encode"):
        idx, palette, quantized = quantize_frame(f)
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette
        block = b"".join([
            struct.pack("<BBBBHBB", 0x21, 0xF9, 4, 0x04,
                        int(round(delay_ms / 10)), 0, 0),
            struct.pack("<BHHHHB", 0x2C, 0, 0, w, h, 0x87),
            table.tobytes(),
            b"\x08" + _sub_blocks(_lzw_literal(idx))])
    return (h, w), block, quantized


def gif_bytes(frames: Sequence[Tuple[Tuple[int, int], bytes]]) -> bytes:
    """A looping GIF89a of encoded frames ``((H, W), bytes)``, in order."""
    h, w = frames[0][0]
    for size, _ in frames:
        if size != (h, w):
            raise ValueError(f"GIF frames differ in size: {size} and "
                             f"{(h, w)}")
    return b"".join(
        [b"GIF89a", struct.pack("<HHBBB", w, h, 0x70, 0, 0),
         b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]
        + [block for _, block in frames] + [b"\x3b"])


def write_gif(path: str, frames, delay_ms: int = 100) -> List[np.ndarray]:
    """Write uint8 frames (H, W[, 3]) as a looping GIF89a, ``delay_ms``
    each; returns the quantized frames the file holds."""
    encoded = [gif_frame(f, delay_ms) for f in frames]
    data = gif_bytes([(size, block) for size, block, _ in encoded])
    with open(path, "wb") as fh:
        fh.write(data)
    return [quantized for _, _, quantized in encoded]


# ---------------------------------------------------------------------------
# the writer threads
# ---------------------------------------------------------------------------

def writer_threads() -> int:
    """Writer threads for this process: the CPUs it may run on, less one
    for the loop that renders, at least 1 and at most 8."""
    return max(1, min(8, len(os.sched_getaffinity(0)) - 1))


class ViewWriter:
    """Writes each view's artifacts under ``out_dir`` on a pool of
    ``threads = writer_threads()`` threads, with at most ``2 * threads``
    views in flight.

    ``gif_name(v)`` names the GIF an image visual ``v`` is a frame of
    (None: none); ``gif_name=None`` encodes no frame. Use it as a
    context: leaving it waits for the jobs running and drops the queued
    ones, so no job writes after the caller has gone on."""

    def __init__(self, out_dir: str,
                 gif_name: Optional[Callable[[Visualizee],
                                             Optional[str]]] = None):
        self.out_dir = out_dir
        self.gif_name = gif_name
        self.threads = writer_threads()
        self._pool = futures.ThreadPoolExecutor(
            self.threads, thread_name_prefix="nerfsr-writer")
        self._jobs: List[futures.Future] = []      # in view order
        self._open: List[futures.Future] = []      # not yet seen done

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._pool.shutdown(wait=True, cancel_futures=True)
        return False

    def submit(self, visuals: Callable[[], Sequence[Visualizee]]):
        """Queue a view: ``visuals()``, on a writer thread, gives its
        artifacts. Blocks (span ``nerfsr.write.wait``) while ``2 *
        threads`` views are in flight; raises the first failed job's
        exception, with its traceback."""
        self._reap()
        if len(self._open) >= 2 * self.threads:
            with spans.span("nerfsr.write.wait"):
                futures.wait(self._open, return_when=futures.FIRST_COMPLETED)
            self._reap()
        job = self._pool.submit(self._write_view, visuals)
        self._jobs.append(job)
        self._open.append(job)

    def _reap(self):
        done = [job for job in self._open if job.done()]
        self._open = [job for job in self._open if not job.done()]
        for job in done:
            job.result()

    def _write_view(self, visuals):
        """A job: the view's visuals written, and ``{GIF name: encoded
        frame}`` of its image strips."""
        vis = visuals()
        os.makedirs(self.out_dir, exist_ok=True)
        frames = {}
        for v in vis:
            img = _save(v, self.out_dir)
            name = self.gif_name(v) if self.gif_name and img is not None \
                else None
            if name is not None:
                # a GIF visual quantizes its frames over (0, 1)
                if tuple(v.range) != (0, 1):
                    img = _to_uint8(v.data)
                size, block, _ = gif_frame(img)
                frames[name] = (size, block)
        return len(vis), frames

    def wait(self):
        """Block until every job is done; raises the first failure in
        view order."""
        futures.wait(self._open)
        self._open = []
        for job in self._jobs:
            job.result()

    def write_gifs(self) -> int:
        """After ``wait``: each GIF of more than one frame from its
        frames' bytes, in view order. Returns the artifacts written, the
        views' and the GIFs'."""
        n, gifs = 0, {}
        for job in self._jobs:
            count, frames = job.result()
            n += count
            for name, frame in frames.items():
                gifs.setdefault(name, []).append(frame)
        for name, frames in gifs.items():
            if len(frames) > 1:
                os.makedirs(self.out_dir, exist_ok=True)
                with open(os.path.join(self.out_dir, f"{name}.gif"),
                          "wb") as fh:
                    fh.write(gif_bytes(frames))
                n += 1
        return n


# ---------------------------------------------------------------------------
# scalar metrics
# ---------------------------------------------------------------------------

class MetricsWriter:
    """Scalar sink: one JSON line per scalar in
    ``{summary_dir}/{name}/metrics.jsonl``."""

    def __init__(self, summary_dir: str, name: str):
        self.dir = os.path.join(summary_dir, name)
        os.makedirs(self.dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.dir, "metrics.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, step: int):
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "t": time.time()}) + "\n")

    def add_scalars(self, scalars: dict, step: int, prefix: str = ""):
        for k, v in scalars.items():
            self.add_scalar(f"{prefix}{k}", v, step)
        self._jsonl.flush()

    def close(self):
        self._jsonl.close()


class NullMetricsWriter:
    """A sink that writes nothing."""

    def add_scalar(self, tag, value, step):
        pass

    def add_scalars(self, scalars, step, prefix=""):
        pass

    def close(self):
        pass
