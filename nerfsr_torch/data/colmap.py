"""COLMAP sparse-model reader, and a binary writer for synthetic scenes.

Port of ``nerfsr_tpu/data/colmap.py`` (the COLMAP model format,
https://colmap.github.io/format.html): camera, image and point records,
``qvec2rotmat``/``rotmat2qvec``, the binary and text readers of
cameras/images/points3D, and the binary writers. The text reader of
images skips comment lines between an image's header line and its points
line; the points line itself may be empty (an image with no
observations).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

# camera model id -> (name, num_params); focal is always params[0] for the
# SIMPLE_* models the LLFF pipeline consumes.
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    point3d_ids: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), np.int64))

    def qvec2rotmat(self):
        return qvec2rotmat(self.qvec)


@dataclass
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2d_idxs: np.ndarray


def qvec2rotmat(q):
    """Rotation matrix from (w, x, y, z) quaternion."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat2qvec(R):
    """(w, x, y, z) quaternion from rotation matrix (for the writer)."""
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1],
         R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]],
    ]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return q * np.sign(q[0]) if q[0] != 0 else q


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------

def read_cameras_binary(path) -> Dict[int, Camera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            cams[cam_id] = Camera(cam_id, name, width, height, params)
    return cams


def read_images_binary(path) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<idddddddi")
            img_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            cam_id = vals[8]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            data = np.frombuffer(
                f.read(24 * n_pts),
                dtype=np.dtype([("xy", "<2f8"), ("id", "<i8")]))
            images[img_id] = ColmapImage(
                img_id, qvec, tvec, cam_id, name.decode("utf-8"),
                xys=data["xy"].copy(), point3d_ids=data["id"].copy())
    return images


def read_points3d_binary(path) -> Dict[int, Point3D]:
    pts = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<QdddBBBd")
            pid = vals[0]
            xyz = np.array(vals[1:4])
            rgb = np.array(vals[4:7], np.uint8)
            error = vals[7]
            (track_len,) = _read(f, "<Q")
            track = np.frombuffer(
                f.read(8 * track_len),
                dtype=np.dtype([("img", "<i4"), ("p2d", "<i4")]))
            pts[pid] = Point3D(pid, xyz, rgb, error,
                               track["img"].copy(), track["p2d"].copy())
    return pts


def read_model(sparse_dir):
    """Read cameras/images/points3D from a sparse/0 directory (binary,
    else text)."""
    b = lambda n: os.path.join(sparse_dir, n)  # noqa: E731
    if os.path.exists(b("cameras.bin")):
        return (read_cameras_binary(b("cameras.bin")),
                read_images_binary(b("images.bin")),
                read_points3d_binary(b("points3D.bin")))
    return (read_cameras_text(b("cameras.txt")),
            read_images_text(b("images.txt")),
            read_points3d_text(b("points3D.txt")))


def read_cameras_text(path) -> Dict[int, Camera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            cams[int(el[0])] = Camera(
                int(el[0]), el[1], int(el[2]), int(el[3]),
                np.array([float(x) for x in el[4:]]))
    return cams


def read_images_text(path) -> Dict[int, ColmapImage]:
    """Two lines per image: the header, then the POINTS2D line, which is
    empty for an image with no observations. Blank lines are skipped only
    between records (skipping them globally would pair a header with the
    next image's points); comment lines are skipped anywhere."""
    images = {}
    with open(path) as f:
        raw = [ln.rstrip("\n") for ln in f]
    i = 0
    while i < len(raw):
        head = raw[i].strip()
        i += 1
        if not head or head.startswith("#"):
            continue
        el = head.split()
        img_id = int(el[0])
        qvec = np.array([float(x) for x in el[1:5]])
        tvec = np.array([float(x) for x in el[5:8]])
        cam_id = int(el[8])
        name = el[9]
        while i < len(raw) and raw[i].lstrip().startswith("#"):
            i += 1
        pts = raw[i].strip() if i < len(raw) else ""
        i += 1
        pel = pts.split()
        xys = np.array([float(x) for x in pel]).reshape(-1, 3) \
            if pel else np.zeros((0, 3))
        images[img_id] = ColmapImage(
            img_id, qvec, tvec, cam_id, name,
            xys=xys[:, :2], point3d_ids=xys[:, 2].astype(np.int64))
    return images


def read_points3d_text(path) -> Dict[int, Point3D]:
    pts = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            track = np.array([int(x) for x in el[8:]]).reshape(-1, 2) \
                if len(el) > 8 else np.zeros((0, 2), np.int64)
            pts[int(el[0])] = Point3D(
                int(el[0]), np.array([float(x) for x in el[1:4]]),
                np.array([int(x) for x in el[4:7]], np.uint8),
                float(el[7]), track[:, 0], track[:, 1])
    return pts


# ---------------------------------------------------------------------------
# writers (synthetic scenes)
# ---------------------------------------------------------------------------

def write_cameras_binary(cams: List[Camera], path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for c in cams:
            model_id = MODEL_NAME_TO_ID[c.model]
            f.write(struct.pack("<iiQQ", c.id, model_id, c.width, c.height))
            f.write(struct.pack(f"<{len(c.params)}d", *c.params))


def write_images_binary(images: List[ColmapImage], path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images:
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec,
                                im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", len(im.point3d_ids)))
            for xy, pid in zip(im.xys, im.point3d_ids):
                f.write(struct.pack("<ddq", xy[0], xy[1], pid))


def write_points3d_binary(points: List[Point3D], path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points:
            f.write(struct.pack("<QdddBBBd", p.id, *p.xyz, *p.rgb, p.error))
            f.write(struct.pack("<Q", len(p.image_ids)))
            for img_id, p2d in zip(p.image_ids, p.point2d_idxs):
                f.write(struct.pack("<ii", int(img_id), int(p2d)))
