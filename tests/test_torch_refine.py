"""The port's refine stage against the JAX package on the CPU: the
networks (outputs and batch statistics), one train step (loss, gradients,
parameters after Adam, statistics), the perspective warps against cv2,
the dataset's warps, samples and tiles, the device sampler's rules, the
warp's correspondences, the checkpoint in both directions, and
warp -> train_refine (with a resume) -> test_refine through the entry
points.
"""

import os
import pathlib
import sys

import cv2
import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in a test worker)

from nerfsr_tpu.config import default_options as j_default_options
from nerfsr_tpu.data import create_dataset as j_create_dataset
from nerfsr_tpu.data import refine as j_refine
from nerfsr_tpu.models import create_model as j_create_model
from nerfsr_tpu.models import networks as j_networks
from nerfsr_tpu.models.refine_system import RefineState as JRefineState
from nerfsr_tpu.ops import warp as j_warp
from nerfsr_tpu.utils import checkpoint as j_ckpt
from nerfsr_tpu.utils.schedule import make_jax_lr_schedule

from nerfsr_torch import test_refine as test_refine_entry
from nerfsr_torch import train_refine as train_refine_entry
from nerfsr_torch import warp as warp_entry
from nerfsr_torch.config import default_options
from nerfsr_torch.data import create_dataset
from nerfsr_torch.data import refine as refine_data
from nerfsr_torch.data.llff import center_poses, spiral_path
from nerfsr_torch.data.synthetic import write_llff_scene
from nerfsr_torch.models import create_model
from nerfsr_torch.models import networks
from nerfsr_torch.ops import warp
from nerfsr_torch.utils import checkpoint as ckpt
from nerfsr_torch.utils import png
from nerfsr_torch.utils.visualizer import _to_uint8
from nerfsr_torch.weights import (export_variables, load_variables,
                                  to_flax_layout, variable_leaves)

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# f32 convolutions in another summation order (oneDNN against XLA):
# outputs and batch statistics of the networks. Typically 2e-6, but
# oneDNN's f32 convolutions have read up to 3.9e-5 from an f64 run of
# the same UNet on this CPU (XLA's 3.4e-7)
NET_ABS = 1e-4
# MaxPoolingModel in training mode: its deepest batch norms see few
# values per channel (2x2 at 16 px, batch 2), which amplifies the
# rounding (seen 2.9e-5; eval outputs 1.2e-7, statistics 3.6e-7)
MAXPOOL_TRAIN_ABS = 1e-4
# one train step: the loss (relative) and each gradient leaf (||d|| /
# ||ref||). The parameters after Adam: an element moves by lr g / (|g| +
# 1e-8), so where |g| is near 1e-8 its move follows g's last bits; all
# but STEP_PARAM_SHARE of each leaf's elements agree within
# STEP_PARAM_ABS (seen 4 of 32,768, by up to 1.1e-5 = 0.011 lr), and
# every element within one lr
STEP_LOSS_REL, STEP_LEAF_REL = 1e-5, 1e-4
STEP_PARAM_ABS, STEP_PARAM_SHARE = 1e-6, 1e-3
# the port's float bilinear warp against cv2's warpPerspective on f32
# images in [0, 1] (seen 2.5e-5)
CV2_ABS = 1e-4
# warp coordinates: a truncation may differ by 1 only where the f64
# coordinate lies within TRUNC_NEAR of an integer (another f32
# rounding), and on at most TRUNC_FLIP_SHARE of the pixels (seen: none
# of 6,144 on each of the scene's views)
TRUNC_NEAR, TRUNC_FLIP_SHARE = 1e-4, 1e-3
# the stitched refinement against JAX's refine_image (seen ~1e-6)
STITCH_ABS = 1e-5
H, W, N_VIEWS = 64, 96, 4


def _jax_opts(**kw):
    base = dict(model="refine", dataset_mode="llff_refine", patch_len=32,
                batch_size=2, num_ref_patches=2, ngf=8, num_downs=5,
                n_epochs=1, n_epochs_decay=0, refine_with_l1=True, lr=1e-3)
    base.update(kw)
    return default_options("train", device="cpu", **base), \
        j_default_options("train", **base)


def _variables_equal(port_vars, jax_vars, atol):
    """Each collection of ``jax_vars`` leaf for leaf in ``port_vars``."""
    for coll in jax_vars:
        got = jax.tree_util.tree_leaves_with_path(port_vars.get(coll, {}))
        want = dict(jax.tree_util.tree_leaves_with_path(
            jax_vars.get(coll, {})))
        assert len(got) == len(want)
        for path, leaf in got:
            np.testing.assert_allclose(leaf, np.asarray(want[path]),
                                       atol=atol, err_msg=str(path))


def _jvars(variables):
    return {k: v for k, v in variables.items() if v}


def _japply(module):
    """``module.apply`` compiled once (eager flax runs op by op)."""
    return jax.jit(module.apply, static_argnames=("train", "mutable"))


def _jax_state(jsys, jopt, variables):
    """A JAX ``RefineState`` of the port's variables with a fresh Adam
    state, and ``jsys.tx`` built as ``RefineSystem.create_state`` builds
    it (without its eager ``init``)."""
    sched = make_jax_lr_schedule(jopt, 1)
    jsys.tx = optax.chain(optax.scale_by_adam(b1=jopt.beta1, b2=0.999),
                          optax.scale_by_schedule(lambda s: -sched(s)))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    return JRefineState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=jsys.tx.init(params))


# ---------------------------------------------------------------------------
# the networks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm,residual", [
    ("batch", False), ("batch", True), ("instance", False),
    ("instance", True)])
def test_unet_matches_jax(norm, residual):
    """ngf 8, 6 downs, 64 px, 27 channels: eval output, train output and
    the new batch statistics, from the same weights."""
    net = networks.UnetGenerator(27, 3, 8, 6, norm, residual,
                                 generator=torch.Generator().manual_seed(0))
    variables = export_variables(net)
    x = np.random.RandomState(1).rand(2, 64, 64, 27).astype(np.float32) * 2 - 1
    apply = _japply(j_networks.UnetGenerator(ngf=8, num_downs=6, norm=norm,
                                             learn_residual=residual))
    net.eval()
    np.testing.assert_allclose(
        net(torch.from_numpy(x)).detach().numpy(),
        np.asarray(apply(_jvars(variables), x, train=False)),
        atol=NET_ABS)
    net.train()
    got = net(torch.from_numpy(x)).detach().numpy()
    if norm == "batch":
        want, mutated = apply(variables, x, train=True,
                              mutable=("batch_stats",))
        _variables_equal(export_variables(net), mutated, NET_ABS)
    else:
        want = apply(_jvars(variables), x, train=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=NET_ABS)


@pytest.mark.parametrize("use_ref", [True, False])
def test_maxpooling_matches_jax(use_ref):
    """Eval and train outputs at 16 px; in training the shared encoder
    runs on the SR patch and then on the candidates, and the statistics
    after both updates match."""
    net = networks.MaxPoolingModel(use_ref,
                                   generator=torch.Generator().manual_seed(0))
    variables = export_variables(net)
    rng = np.random.RandomState(2)
    xs = rng.rand(2, 16, 16, 3).astype(np.float32) * 2 - 1
    xc = rng.rand(2, 2, 16, 16, 3).astype(np.float32) * 2 - 1
    apply = _japply(j_networks.MaxPoolingModel(use_ref=use_ref))
    net.eval()
    np.testing.assert_allclose(
        net(torch.from_numpy(xs), torch.from_numpy(xc)).detach().numpy(),
        np.asarray(apply(variables, xs, xc, train=False)), atol=NET_ABS)
    net.train()
    got = net(torch.from_numpy(xs), torch.from_numpy(xc)).detach().numpy()
    want, mutated = apply(variables, xs, xc, train=True,
                          mutable=("batch_stats",))
    np.testing.assert_allclose(got, np.asarray(want), atol=MAXPOOL_TRAIN_ABS)
    _variables_equal(export_variables(net), mutated, NET_ABS)


def test_conv_transpose_layout_round_trips():
    """The flax layout of a transposed convolution is its kernel flipped
    on both spatial axes: export then load gives the same tensors."""
    net = networks.UnetGenerator(9, 3, 8, 6, "batch", False,
                                 generator=torch.Generator().manual_seed(3))
    other = networks.UnetGenerator(9, 3, 8, 6, "batch", False,
                                   generator=torch.Generator().manual_seed(4))
    load_variables(other, export_variables(net))
    for a, b in zip(net.state_dict().values(), other.state_dict().values()):
        assert torch.equal(a, b)
    with pytest.raises(KeyError, match="only in the variables"):
        load_variables(networks.UnetGenerator(
            9, 3, 8, 6, "instance", False), export_variables(net))


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------

def _batch(seed, n=2, plen=32, k=2):
    rng = np.random.RandomState(seed)
    gt = rng.rand(n, plen, plen, 3).astype(np.float32) * 2 - 1
    sr = np.clip(gt + rng.randn(n, plen, plen, 3).astype(np.float32) * 0.1,
                 -1, 1)
    refs = np.clip(gt[:, None] + rng.randn(n, k, plen, plen, 3).astype(
        np.float32) * 0.05, -1, 1)
    return {"sr_patch": sr, "ref_patches": refs, "gt_patch": gt}


@pytest.mark.parametrize("losses", [
    dict(refine_with_l1=True), dict(refine_with_l1=False,
                                    refine_with_mse=True),
    dict(refine_with_l1=False, refine_with_grad=True),
    dict(refine_with_l1=True, refine_with_vgg=True)])
def test_train_step_matches_jax(losses, tmp_path):
    """One step from the same weights and batch against JAX's
    ``_train_step_impl``: every loss, each gradient leaf (JAX's from its
    first Adam moment, mu = 0.1 g), the parameters after Adam and the
    new statistics. ``--refine_with_vgg`` reads the synthetic VGG19
    archive (``write_synthetic_vgg_npz``) on both sides."""
    if losses.get("refine_with_vgg"):
        losses = dict(losses, vgg_weights=_vgg_npz(tmp_path))
    opt, jopt = _jax_opts(**losses)
    system = create_model(opt, device="cpu")
    state = system.create_state(seed=0, steps_per_epoch=1)
    variables = export_variables(state.net)
    jsys = j_create_model(jopt)
    jstate = _jax_state(jsys, jopt, variables)
    batch = _batch(5)
    jstate, jlosses = jax.jit(jsys._train_step_impl)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state, plosses = system.train_step(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})

    assert set(plosses) == set(jlosses)
    for k in plosses:
        want = float(jlosses[k])
        assert abs(float(plosses[k]) - want) <= STEP_LOSS_REL * abs(want), k
    mu = dict(jax.tree_util.tree_leaves_with_path(jstate.opt_state[0].mu))
    got = export_variables(state.net)
    jparams = dict(jax.tree_util.tree_leaves_with_path(jstate.params))
    for coll, path, t, layout in variable_leaves(state.net):
        if coll != "params":
            continue
        key = tuple(jax.tree_util.DictKey(p) for p in path.split("/"))
        g_jax = np.asarray(mu[key]) / (1 - opt.beta1)
        g_port = to_flax_layout(t.grad, layout)
        rel = np.linalg.norm(g_port - g_jax) / np.linalg.norm(g_jax)
        assert rel <= STEP_LEAF_REL, (path, rel)
        diff = np.abs(_get_path(got["params"], path)
                      - np.asarray(jparams[key]))
        assert diff.max() <= opt.lr, path
        assert np.mean(diff > STEP_PARAM_ABS) <= STEP_PARAM_SHARE, path
    _variables_equal({"batch_stats": got["batch_stats"]},
                     {"batch_stats": jstate.batch_stats}, NET_ABS)
    assert state.step == int(jstate.step) == 1


def _vgg_npz(tmp_path):
    from nerfsr_torch.models.criterions import write_synthetic_vgg_npz
    return write_synthetic_vgg_npz(str(tmp_path / "vgg.npz"), seed=0)


def _get_path(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# the perspective warps
# ---------------------------------------------------------------------------

def test_perspective_helpers_match_cv2_and_jax():
    """The same corners as the JAX dataset's draws (one RandomState
    stream), cv2's homography, cv2's warpPerspective within CV2_ABS, and
    the JAX dataset's valid boxes."""
    rng, jrng = np.random.RandomState(0), np.random.RandomState(0)
    img = np.random.RandomState(1).rand(96, 128, 3).astype(np.float32)
    worst = 0.0
    for _ in range(20):
        start, end = refine_data.random_perspective_params(128, 96, 0.3, rng)
        jstart, jend = j_refine.random_perspective_params(128, 96, 0.3, jrng)
        assert np.array_equal(start, jstart) and np.array_equal(end, jend)
        m = refine_data.get_perspective_transform(start, end)
        np.testing.assert_allclose(
            m, cv2.getPerspectiveTransform(start, end), rtol=1e-9,
            atol=1e-12)
        worst = max(worst, float(np.abs(
            refine_data.warp_perspective(img, start, end)
            - cv2.warpPerspective(img, m, (128, 96))).max()))
        assert np.array_equal(refine_data.valid_bbox(start, end, (128, 96)),
                              j_refine.valid_bbox(start, end, (128, 96)))
    assert worst <= CV2_ABS


# ---------------------------------------------------------------------------
# a scene, its syntheses and correspondences
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A COLMAP scene of N_VIEWS smooth images, and for each view a
    synthesis strip (the view plus noise | another panel), an NDC depth
    map, and two locs files: 3 channels (the warp's) under ``syn`` and 2
    under ``syn2``."""
    d = tmp_path_factory.mktemp("refine")
    rng = np.random.RandomState(0)
    poses, _ = center_poses(spiral_path(np.array([0.2, 0.2, 0.05]), 3.5,
                                        N_VIEWS))
    yy, xx = np.mgrid[0:H, 0:W] / 9.0
    imgs = np.stack([np.stack([np.sin(xx * (1 + c) + i) * np.cos(yy + c)
                               for c in range(3)], -1)
                     for i in range(N_VIEWS)])
    imgs = ((imgs * 0.5 + 0.5) * 255).astype(np.uint8)
    write_llff_scene(str(d / "scene"), poses, imgs, 80.0,
                     rng.randn(400, 3) * 0.5 + [0, 0, -4.0])
    for sub in ("syn", "syn2"):
        os.makedirs(d / sub)
    for i in range(N_VIEWS):
        noisy = np.clip(imgs[i].astype(int) + rng.randint(-20, 20, imgs[i]
                                                          .shape), 0, 255)
        strip = np.concatenate([noisy.astype(np.uint8), imgs[i]], 1)
        np.savez(d / "syn" / f"{i}-fine-depth-ori.npz",
                 matrix=rng.uniform(0.6, 0.8, (H, W)).astype(np.float32))
        for sub in ("syn", "syn2"):
            png.write(str(d / sub / f"{i}-fine-ori.png"), strip)
    # the warp writes the 3-channel locs
    warp_entry.main(["--dataset_root", str(d / "scene"), "--result_dir",
                     str(d / "syn"), "--img_wh", str(W), str(H),
                     "--device", "cpu"])
    for i in range(N_VIEWS):
        locs = np.load(d / "syn" / f"{i}_locs.npz")["arr_0"]
        np.savez(d / "syn2" / f"{i}_locs.npz", locs[..., :2])
    return d


def _refine_opts(scene, sub="syn", **kw):
    return _jax_opts(dataset_root=str(scene / "scene"),
                     syn_dataroot=str(scene / sub), img_wh=(W, H),
                     aug_num=4, **kw)


def test_warp_locs_match_jax(scene):
    """``warp_view`` against JAX's on a view of the scene: every
    truncated coordinate equal, except ones (by 1) whose f64 value lies
    within TRUNC_NEAR of an integer; warped colours equal where the
    coordinates are; and the files the warp wrote."""
    from nerfsr_torch.data.llff import load_colmap_scene
    poses, _, focal, _ = load_colmap_scene(str(scene / "scene"), (W, H))
    ref_w2c = warp.ref_world_to_cam(poses[0])
    ref = np.random.RandomState(3).rand(H, W, 3).astype(np.float32)
    depth = np.load(scene / "syn" / "2-fine-depth-ori.npz")["matrix"]
    locs, warped = warp.warp_view(depth, poses[2], ref_w2c, ref, focal,
                                  (W, H), device="cpu")
    jlocs, jwarped = j_warp.warp_view(depth, poses[2], ref_w2c, ref, focal,
                                      (W, H))
    # the coordinates before truncation, in float64
    z = 1.0 / (1.0 - depth.astype(np.float64) + 1e-6)
    jj, ii = np.mgrid[0:H, 0:W] + 0.5
    pts = np.stack([(ii - W / 2) / focal * z, -(jj - H / 2) / focal * z,
                    -z], -1)
    pts = pts @ poses[2][:, :3].T.astype(np.float64) + poses[2][:, 3]
    pts = pts @ ref_w2c[:, :3].T + ref_w2c[:, 3]
    pts = pts / -pts[..., 2:3]
    exact = np.stack([pts[..., 0] * focal + W / 2,
                      pts[..., 1] * -focal + H / 2], -1)
    diff = locs[..., :2] != jlocs[..., :2]
    near = np.abs(exact - np.round(exact)) < TRUNC_NEAR
    assert (np.abs(locs - jlocs)[..., :2][diff] == 1).all()
    assert near[diff].all()
    same = ~diff.any(-1)
    assert 1 - same.mean() <= TRUNC_FLIP_SHARE
    np.testing.assert_array_equal(warped[same], jwarped[same])
    assert np.array_equal(locs[..., 2], jlocs[..., 2])
    saved = np.load(scene / "syn" / "2_locs.npz")
    assert saved.files == ["arr_0"] and saved["arr_0"].dtype == np.float32
    assert (scene / "syn" / "2-wrapped.png").exists()


def test_warp_takes_the_index_from_the_file_name(scene, tmp_path):
    for i in (1, 3):
        os.link(scene / "syn" / f"{i}-fine-depth-ori.npz",
                tmp_path / f"{i}-fine-depth-ori.npz")
    written = warp.generate_correspondences(
        str(scene / "scene"), str(tmp_path), (W, H), device="cpu")
    assert written == [1, 3]
    assert sorted(f for f in os.listdir(tmp_path) if "locs" in f) == [
        "1_locs.npz", "3_locs.npz"]


# ---------------------------------------------------------------------------
# the dataset
# ---------------------------------------------------------------------------

def test_train_mode_matches_jax(scene):
    """Augmented views within CV2_ABS of the JAX dataset's (cv2) with the
    same valid boxes; the host sampler then draws the same patches."""
    opt, jopt = _refine_opts(scene, with_gt_patch=True)
    ds = create_dataset(opt, "train")
    jds = j_create_dataset(jopt, "train")
    np.testing.assert_allclose(ds.gt_imgs, jds.gt_imgs, atol=CV2_ABS)
    np.testing.assert_allclose(ds.sr_imgs, jds.sr_imgs, atol=CV2_ABS)
    assert np.array_equal(ds.bboxes, jds.bboxes)
    assert np.array_equal(ds.gt_img, jds.gt_img)
    got, want = ds.sample_train_batch(4), jds.sample_train_batch(4)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=CV2_ABS)
    assert {k: v.dtype for k, v in ds.device_buffers().items()} == {
        k: v.dtype for k, v in jds.device_buffers().items()}


def test_val_items_match_jax(scene):
    opt, jopt = _refine_opts(scene)
    ds, jds = create_dataset(opt, "val"), j_create_dataset(jopt, "val")
    assert len(ds) == len(jds) == N_VIEWS
    for i in range(3):
        got, want = ds.sample_val_item(i), jds.sample_val_item(i)
        for k in want:
            assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("mode", ["test_train", "test"])
def test_tiles_match_jax(scene, mode):
    """Tiles, reference patches (the first k valid correspondences,
    column-major) and start locations equal the JAX dataset's on the
    2-channel locs. On the warp's 3-channel locs the port's are the same
    (the -1 filler is ignored), where JAX's reshape to pairs scans every
    other pixel."""
    opt, jopt = _refine_opts(scene, "syn2", patch_len=32)
    ds, jds = create_dataset(opt, mode), j_create_dataset(jopt, mode)
    assert ds.n_images() == jds.n_images() == N_VIEWS
    opt3, _ = _refine_opts(scene, "syn", patch_len=32)
    ds3 = create_dataset(opt3, mode)
    for i in range(N_VIEWS):
        got, want = ds.tiles_for_image(i), jds.tiles_for_image(i)
        assert got.keys() == want.keys()
        for k in want:
            assert np.array_equal(got[k], want[k]), k
        got3 = ds3.tiles_for_image(i)
        assert np.array_equal(got3["ref_patches"], got["ref_patches"])


def test_device_sampler_follows_the_host_rules():
    """The device sampler on stacks whose texels encode (y, x, view):
    every SR/GT cut inside its view's valid box, the GT patch at the SR
    patch's place, references from the unwarped view within
    ``--ref_offset``, and with ``--with_gt_patch`` one reference is the
    GT patch."""
    h = w = 48
    plen, off, k = 16, 8, 3
    for with_gt in (False, True):
        opt, _ = _jax_opts(patch_len=plen, batch_size=32, num_ref_patches=k,
                           ref_offset=off, with_gt_patch=with_gt)
        system = create_model(opt, device="cpu")
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        stack = np.stack([np.stack([yy, xx, np.full_like(yy, a)], -1)
                          for a in range(3)]).astype(np.float32)
        bboxes = np.array([[0, 0, w, h], [4, 6, 40, 44], [10, 2, 30, 20]],
                          np.int32)
        buffers = system.upload_buffers({
            "sr_imgs": stack, "gt_imgs": stack + 100.0,
            "gt_img": stack[0] + 1000.0, "bboxes": bboxes})
        batch = {k2: v.numpy() for k2, v in system.sample_patch_batch(
            buffers, torch.Generator().manual_seed(3)).items()}
        sr, gt, refs = batch["sr_patch"], batch["gt_patch"], \
            batch["ref_patches"]
        assert sr.shape == (32, plen, plen, 3)
        assert refs.shape == (32, k, plen, plen, 3)
        assert len({int(a) for a in sr[:, 0, 0, 2]}) == 3
        for b in range(32):
            ys, xs, a = (int(v) for v in sr[b, 0, 0])
            x0, y0, x1, y1 = bboxes[a]
            assert x0 <= xs and xs + plen <= max(x1, x0 + plen + 1)
            assert y0 <= ys and ys + plen <= max(y1, y0 + plen + 1)
            assert np.array_equal(gt[b], sr[b] + 100.0)
            planted = 0
            for j in range(k):
                if np.array_equal(refs[b, j], gt[b]):
                    planted += 1
                    continue
                ry, rx = refs[b, j, 0, 0, :2] - 1000
                assert refs[b, j, 0, 0, 2] == 1000
                assert max(x0, xs - off) <= rx <= max(
                    max(x0, xs - off), min(x1 - plen, xs + off) - 1)
                assert max(y0, ys - off) <= ry <= max(
                    max(y0, ys - off), min(y1 - plen, ys + off) - 1)
            assert planted == (1 if with_gt else 0)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_refine_checkpoint_both_ways(scene, tmp_path):
    """The port's file read by flax's ``from_bytes`` into a JAX
    ``RefineState``, and a JAX-written file (after a JAX step) loaded by
    the port: parameters, statistics, Adam moments and counts."""
    opt, jopt = _jax_opts(checkpoints_dir=str(tmp_path), name="c")
    system = create_model(opt, device="cpu")
    state = system.create_state(seed=0, steps_per_epoch=1)
    system.train_step(state, {k: torch.from_numpy(v)
                              for k, v in _batch(6).items()})
    path = ckpt.save_checkpoint(opt, state, 1)
    jsys = j_create_model(jopt)
    template = _jax_state(jsys, jopt, export_variables(
        system.build_net(seed=1)))
    with open(path, "rb") as f:
        jstate = flax.serialization.from_bytes(template, f.read())
    assert int(jstate.step) == 1
    variables = export_variables(state.net)
    _variables_equal(variables, {"params": jstate.params,
                                 "batch_stats": jstate.batch_stats}, 0)

    # JAX steps once more and writes; the port reads it
    jstate, _ = jax.jit(jsys._train_step_impl)(
        jstate, {k: jnp.asarray(v) for k, v in _batch(7).items()})
    jopt.name = "j"
    j_ckpt.save_checkpoint(jopt, jstate, 2)
    opt.name = "j"
    back = system.create_state(seed=1, steps_per_epoch=1)
    ckpt.load_checkpoint(opt, back, epoch=2)
    assert back.step == 2
    _variables_equal(export_variables(back.net),
                     {"params": jstate.params,
                      "batch_stats": jstate.batch_stats}, 0)
    sd = ckpt.state_dict(opt, back)
    for name in ("mu", "nu"):
        want = dict(jax.tree_util.tree_leaves_with_path(
            getattr(jstate.opt_state[0], name)))
        got = jax.tree_util.tree_leaves_with_path(sd["opt_state"]["0"][name])
        assert len(got) == len(want)
        for p, leaf in got:
            assert np.array_equal(leaf, np.asarray(want[p])), p
    assert int(sd["opt_state"]["1"]["count"]) == 2


# ---------------------------------------------------------------------------
# the engine and the entry points
# ---------------------------------------------------------------------------

def test_train_resume_test_through_the_entry_points(scene, tmp_path):
    """train_refine 2 epochs, a resume to 3 equal to an unbroken 3-epoch
    run bit for bit, then test_refine on test_train: the stitched panels
    are the port's refine_image, and within STITCH_ABS of JAX's
    refine_image on the same checkpoint and tiles."""
    common = ["--model", "refine", "--dataset_mode", "llff_refine",
              "--dataset_root", str(scene / "scene"), "--img_wh", str(W),
              str(H), "--syn_dataroot", str(scene / "syn"), "--device",
              "cpu", "--checkpoints_dir", str(tmp_path / "ck"),
              "--patch_len", "32", "--ngf", "8", "--num_downs", "5",
              "--num_ref_patches", "2"]
    train = ["--batch_size", "4", "--aug_num", "4", "--steps_per_epoch",
             "4", "--print_freq", "2", "--val_freq", "2", "--vis_freq", "4",
             "--refine_with_l1", "--n_epochs_decay", "0",
             "--summary_dir", str(tmp_path / "runs")]
    train_refine_entry.main(["--name", "r", "--n_epochs", "2"] + common
                            + train)
    resumed = train_refine_entry.main(["--name", "r", "--n_epochs", "3",
                                       "--continue_train"] + common + train)
    whole = train_refine_entry.main(["--name", "u", "--n_epochs", "3"]
                                    + common + train)
    assert resumed.step == whole.step == 12
    for a, b in zip(resumed.net.state_dict().values(),
                    whole.net.state_dict().values()):
        assert torch.equal(a, b)
    assert any("sr-refine-gt" in f for f in os.listdir(
        tmp_path / "ck" / "u" / "1_iter_vis"))

    out = test_refine_entry.main(
        ["--name", "u", "--results_dir", str(tmp_path / "res"),
         "--test_split", "test_train", "--load_epoch", "3"] + common)
    opt, jopt = _refine_opts(scene, checkpoints_dir=str(tmp_path / "ck"),
                             name="u", num_ref_patches=2)
    system = create_model(opt, device="cpu")
    state = system.create_state(seed=0, steps_per_epoch=1)
    ckpt.load_checkpoint(opt, state, epoch=3, params_only=True)
    jsys = j_create_model(jopt)
    jstate = j_ckpt.load_checkpoint(
        jopt, _jax_state(jsys, jopt, export_variables(system.build_net(1))),
        epoch=3)
    ds = create_dataset(opt, "test_train")
    for i in range(N_VIEWS):
        tiles = ds.tiles_for_image(i)
        refined, sr_img, gt_img = system.refine_image(state, tiles)
        jrefined, jsr, jgt = jsys.refine_image(jstate, tiles)
        np.testing.assert_allclose(refined, jrefined, atol=STITCH_ABS)
        assert np.array_equal(sr_img, jsr) and np.array_equal(gt_img, jgt)
        strip = png.read_rgb(os.path.join(out, f"{i}-sr-refine.png"))
        assert strip.shape == (H, 3 * W, 3)
        assert np.array_equal(strip[:, W:2 * W], _to_uint8(refined, (-1, 1)))
        m = system.eval_image_metrics(refined, sr_img, gt_img)
        jm = jsys.eval_image_metrics(refined, sr_img, gt_img)
        for k in jm:
            assert abs(m[k] - jm[k]) <= 1e-4 * max(1.0, abs(jm[k])), k


def test_refine_trains_and_tests_with_orbax(scene, tmp_path):
    """``--ckpt_backend orbax`` through ``train_refine`` and
    ``test_refine``: the epoch and ``latest`` directories, and the
    stitched panels of the orbax epoch's network."""
    common = ["--model", "refine", "--dataset_mode", "llff_refine",
              "--dataset_root", str(scene / "scene"), "--img_wh", str(W),
              str(H), "--syn_dataroot", str(scene / "syn"), "--device",
              "cpu", "--checkpoints_dir", str(tmp_path / "ck"),
              "--patch_len", "32", "--ngf", "8", "--num_downs", "5",
              "--num_ref_patches", "2", "--ckpt_backend", "orbax",
              "--name", "o"]
    state = train_refine_entry.main(
        common + ["--batch_size", "2", "--aug_num", "2", "--steps_per_epoch",
                  "2", "--n_epochs", "1", "--n_epochs_decay", "0",
                  "--refine_with_l1", "--val_epoch_freq", "0",
                  "--summary_dir", str(tmp_path / "runs")])
    assert sorted(f for f in os.listdir(tmp_path / "ck" / "o")
                  if "state" in f) == ["1_state.orbax", "latest_state.orbax"]
    out = test_refine_entry.main(common + [
        "--results_dir", str(tmp_path / "res"), "--test_split",
        "test_train", "--load_epoch", "1"])
    opt, _ = _refine_opts(scene, checkpoints_dir=str(tmp_path / "ck"),
                          name="o", num_ref_patches=2, ckpt_backend="orbax")
    system = create_model(opt, device="cpu")
    loaded = system.create_state(seed=3, steps_per_epoch=1)
    ckpt.load_checkpoint(opt, loaded, epoch=1, params_only=True)
    for a, b in zip(loaded.net.state_dict().values(),
                    state.net.state_dict().values()):
        assert torch.equal(a, b)
    tiles = create_dataset(opt, "test_train").tiles_for_image(0)
    refined, _, _ = system.refine_image(loaded, tiles)
    strip = png.read_rgb(os.path.join(out, "0-sr-refine.png"))
    assert np.array_equal(strip[:, W:2 * W], _to_uint8(refined, (-1, 1)))


def test_input_nc_must_describe_the_stacked_input():
    opt, _ = _jax_opts(input_nc=12, num_ref_patches=2)
    with pytest.raises(ValueError, match="input_nc 12"):
        create_model(opt, device="cpu")
    opt.input_nc = 9
    assert create_model(opt, device="cpu").build_net(0).down_0.in_channels \
        == 9
