"""The port's host-C ray builder (``nerfsr_torch/csrc_host/raygen.c``,
``utils/raygen.py``) on the CPU, against the JAX package's C++
``nerfsr_tpu.native.build_rays`` (its committed library) at
``tests/test_native.py``'s bars, and against the port's numpy
``pose_rays``; and ``LLFFDataset.ray_buffer``, which builds a
forward-facing scene's training rays with it, against the JAX dataset's.

The JAX library is built with ``-march=native``, where GCC fuses
multiplies and adds; the port's with ``-ffp-contract=off``. So the two
agree to rounding, not bit for bit.
"""

import os
import sys

import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads in a test worker)

from nerfsr_tpu import native
from nerfsr_tpu.config import default_options as j_default_options
from nerfsr_tpu.data import create_dataset as j_create_dataset
from nerfsr_tpu.data.colmap import qvec2rotmat

from nerfsr_torch.config import default_options
from nerfsr_torch.data import create_dataset
from nerfsr_torch.data import llff as port_llff
from nerfsr_torch.utils import raygen

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools.make_synthetic_llff import make_llff_scene, nerf_pose  # noqa: E402

# tests/test_native.py's bars: world rays, and NDC rays (the warp divides
# by the direction's z)
WORLD_TOL = dict(rtol=1e-5, atol=1e-6)
NDC_TOL = dict(rtol=1e-4, atol=1e-5)
H, W = 13, 19          # ragged: neither a multiple of 2 nor of 4


def _random_poses(n, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        q = rng.randn(4)
        R = qvec2rotmat(q / np.linalg.norm(q))
        out.append(np.concatenate([R, rng.randn(3, 1)], 1))
    return np.stack(out).astype(np.float32)


def _facing_poses(n, seed):
    """Forward-facing: cameras near +z looking at the origin, as NDC
    takes them."""
    rng = np.random.RandomState(seed)
    return np.stack([
        nerf_pose(np.array([0.3 * rng.randn(), 0.3 * rng.randn(),
                            4.0 + rng.rand()]), np.zeros(3))
        for _ in range(n)]).astype(np.float32)


@pytest.mark.parametrize("centres", [True, False])
@pytest.mark.parametrize("ndc", [False, True])
def test_build_rays_matches_jax_native(ndc, centres):
    assert native.available()
    c2w = _facing_poses(5, 1) if ndc else _random_poses(5, 0)
    focal = 21.5
    got = raygen.build_rays(c2w, H, W, focal, centres, apply_ndc=ndc)
    want = native.build_rays(c2w, H, W, focal, centres, apply_ndc=ndc)
    tol = NDC_TOL if ndc else WORLD_TOL
    for g, w in zip(got, want):
        assert g.shape == (5, H, W, 3) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, **tol)


@pytest.mark.parametrize("ndc", [False, True])
def test_build_rays_matches_numpy_pose_rays(ndc):
    """Each image against the port's ``pose_rays`` (numpy), which the
    spheric scenes keep."""
    c2w = _facing_poses(3, 2) if ndc else _random_poses(3, 3)
    focal = 17.0
    origins, dirs = raygen.build_rays(c2w, H, W, focal, apply_ndc=ndc)
    cam = port_llff._ray_dirs_np(H, W, focal, True)
    tol = NDC_TOL if ndc else WORLD_TOL
    for i in range(3):
        ref = port_llff.pose_rays(cam, c2w[i], (W, H), focal, (0.0, 1.0),
                                  spheric=not ndc)
        np.testing.assert_allclose(origins[i], ref["origins"], **tol)
        np.testing.assert_allclose(dirs[i], ref["directions"], **tol)


def test_build_rays_threads_give_the_same_bits():
    """Images are shared out among threads; every thread count (1, 3,
    more threads than images, one a core) gives the same bytes."""
    c2w = _random_poses(4, 4)
    runs = [raygen.build_rays(c2w, H, W, 11.0, apply_ndc=False, n_threads=t)
            for t in (1, 3, 16, 0)]
    for run in runs[1:]:
        for a, b in zip(runs[0], run):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("llff")
    make_llff_scene(str(d), hw=(24, 32), n_imgs=4)
    return str(d)


@pytest.mark.parametrize("spheric", [False, True])
def test_ray_buffer_uses_the_c_builder(scene, spheric, monkeypatch):
    """A forward-facing scene's buffer is the C builder's rays (bit for
    bit) and the JAX dataset's (which takes its C++) to test_native.py's
    bars; a spheric scene's takes numpy, as in JAX, and never the C."""
    kw = dict(model="nerf", dataset_mode="llff", dataset_root=scene,
              img_wh=(32, 24), spheric_poses=spheric)
    ds = create_dataset(default_options("train", **kw), "train")
    jbuf = j_create_dataset(j_default_options("train", **kw),
                            "train").ray_buffer()
    calls = []
    build = raygen.build_rays
    monkeypatch.setattr(raygen, "build_rays",
                        lambda *a, **k: calls.append(a) or build(*a, **k))
    buf = ds.ray_buffer()
    assert len(calls) == (0 if spheric else 1)
    assert set(buf) == {"origins", "directions", "near", "far", "rgbs"}
    np.testing.assert_array_equal(buf["rgbs"], jbuf["rgbs"])
    for k in ("near", "far"):
        np.testing.assert_array_equal(buf[k], jbuf[k])
    tol = WORLD_TOL if spheric else NDC_TOL
    for k in ("origins", "directions"):
        np.testing.assert_allclose(buf[k], jbuf[k], **tol)
    if not spheric:
        keep = [i for i in range(len(ds.image_paths)) if i != ds.val_idx]
        o, d = build(ds.poses[keep], 24, 32, ds.focal, True, apply_ndc=True)
        np.testing.assert_array_equal(buf["origins"], o.reshape(-1, 3))
        np.testing.assert_array_equal(buf["directions"], d.reshape(-1, 3))
