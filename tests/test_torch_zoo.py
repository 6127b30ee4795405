"""The network zoo's modules on the CPU against the JAX package: the same
numpy inputs and weights go through both.

- ``NeuTexMLP`` (D4/W32) against flax's, f32, to 1e-5; ``--no_dir``
  refused at construction;
- ``bilateral_volumetric_rendering`` to 1e-6;
- the bug-faithful ``grad_loss``, relative 1e-5 (it grows as the fourth
  power of the gradients);
- ``ResnetGenerator`` (ngf 8, 2 blocks, 16x16), ``ResnetBlock``,
  ``ConvBlock`` and ``Up2x`` in train and eval mode: outputs to 1e-4,
  batch statistics to 1e-6 + 1e-4 of the value, their variables
  crossing with
  ``nerfsr_torch.weights``;
- the pix2pix transforms against JAX's, which resize with cv2: float
  within 1e-4, uint8 within one level (the share of pixels that differ
  is printed), ``get_params`` equal from one ``RandomState``;
- every JAX command line of ``scripts/*.sh``, with ``--suffix``,
  ``--verbose`` and each compat no-op, parsed to JAX's options;
- ``python -m nerfsr_torch.convert_reference_ckpt`` against
  ``tools/convert_reference_ckpt.py``'s key map on a synthetic ``.pth``.
"""

import pathlib
import re
import subprocess
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in a test worker)

from nerfsr_tpu.config import default_options as j_default_options
from nerfsr_tpu.config import parse_options as j_parse_options
from nerfsr_tpu.core.rendering import \
    bilateral_volumetric_rendering as j_bilateral
from nerfsr_tpu.data import transforms as jT
from nerfsr_tpu.models import create_model as j_create_model
from nerfsr_tpu.models import networks as jnet
from nerfsr_tpu.models.criterions import grad_loss as j_grad_loss
from nerfsr_tpu.models.mlp import NeuTexMLP as JNeuTex
from nerfsr_tpu.utils import checkpoint as j_ckpt

from nerfsr_torch.config import default_options, parse_options
from nerfsr_torch.convert_reference_ckpt import main as convert_main
from nerfsr_torch.convert_reference_ckpt import reference_state_to_flax
from nerfsr_torch.core.rendering import bilateral_volumetric_rendering
from nerfsr_torch.data import transforms as T
from nerfsr_torch.models import create_model
from nerfsr_torch.models import networks as tnet
from nerfsr_torch.models.criterions import grad_loss
from nerfsr_torch.models.mlp import NeuTexMLP
from nerfsr_torch.models.nerf_system import NeRFSystem
from nerfsr_torch.utils import checkpoint as ckpt
from nerfsr_torch.weights import (export_params, export_variables,
                                  load_module, load_variables)

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from tools.convert_reference_ckpt import torch_mlp_state_to_flax  # noqa: E402

# f32 forward of a small network, another summation order
MLP_ATOL = 1e-5
BILATERAL_ATOL = 1e-6
GRAD_LOSS_RTOL = 1e-5
# convolutions through another library, NHWC against NCHW
CNN_ATOL = 1e-4
# batch statistics, 1e-6 plus 1e-4 of the value: each batch norm's
# running values move by
# 0.1 of its batch's mean and biased variance (E[x^2] - E[x]^2 in f32 on
# both sides), over inputs that carry the layers before it. Seen: a
# single layer's (ConvBlock, Up2x, the stem) 6.6e-6, the generator's
# deepest block's 2.9e-5 on variances up to 120
STATS_ATOL, STATS_RTOL = 1e-6, 1e-4
RESIZE_FLOAT_ATOL = 1e-4


def t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


# ---------------------------------------------------------------------
# NeuTexMLP
# ---------------------------------------------------------------------

@pytest.mark.parametrize("sigma_only", [False, True])
def test_neutex_mlp_matches_flax(sigma_only):
    c_pos, c_dir = 15, 9
    rng = np.random.RandomState(0)
    xyz = rng.randn(5, 7, c_pos).astype(np.float32)
    drc = rng.randn(5, 7, c_dir).astype(np.float32)
    jm = JNeuTex(depth=4, width=32, skips=(2,))
    variables = _np(jm.init(jax.random.PRNGKey(1), jnp.asarray(xyz),
                            jnp.asarray(drc)))
    # biases off zero, so a bias mapped to the wrong layer shows
    variables = jax.tree_util.tree_map(
        lambda a: a + rng.randn(*a.shape).astype(np.float32) * 0.1,
        variables)
    assert set(variables["params"]) == {
        "xyz_encoding_1", "xyz_encoding_2", "xyz_encoding_3",
        "xyz_encoding_4", "sigma", "xyz_encoding_final", "dir_encoding_1",
        "dir_encoding_2", "rgb"}
    rgb, sigma = jm.apply(variables, jnp.asarray(xyz), jnp.asarray(drc),
                          sigma_only=sigma_only)
    tm = load_module(NeuTexMLP(depth=4, width=32, skips=(2,), c_pos=c_pos,
                               c_dir=c_dir), variables)
    with torch.no_grad():
        got_rgb, got_sigma = tm(t(xyz), t(drc), sigma_only=sigma_only)
    np.testing.assert_allclose(got_sigma.numpy(), np.asarray(sigma),
                               atol=MLP_ATOL)
    if sigma_only:
        assert got_rgb is None and rgb is None
    else:
        np.testing.assert_allclose(got_rgb.numpy(), np.asarray(rgb),
                                   atol=MLP_ATOL)


def test_neutex_system_builds_it_and_refuses_no_dir():
    """``--mlp_network neutex_mlp`` builds NeuTex at every level, off
    kernel C's path; with ``--no_dir`` the system refuses at
    construction, naming both flags (the JAX module fails at its first
    call)."""
    for kw in (dict(model="nerf", dataset_mode="llff"),
               dict(model="nerf_downX", dataset_mode="llff_downX",
                    fast_preset="llff")):
        opt = default_options("train", mlp_network="neutex_mlp", D=2, W=16,
                              **kw)
        system = create_model(opt, device="cpu")
        assert not system.render_cfg.use_fused_mlp
        params = system.init_params(0)
        big = [k for k in params if k != "prop"]
        assert big and all(isinstance(params[k], NeuTexMLP) for k in big)
        opt.no_dir = True
        with pytest.raises(ValueError, match="neutex_mlp.*--no_dir"):
            NeRFSystem(opt, device="cpu")


# ---------------------------------------------------------------------
# bilateral renderer, grad_loss
# ---------------------------------------------------------------------

@pytest.mark.parametrize("white_bkgd,activation",
                         [(False, "relu"), (True, "softplus")])
def test_bilateral_rendering_matches_jax(white_bkgd, activation):
    n, s = 7, 9
    rng = np.random.RandomState(1)
    rgb = rng.rand(n, s, 3).astype(np.float32)
    neighbors = np.clip(rgb[None] + rng.randn(5, n, s, 3) * 0.3, 0, 1
                        ).astype(np.float32).reshape(5 * n, s, 3)
    sigma = (rng.rand(n, s) * 4 - 1).astype(np.float32)
    z = np.sort(rng.rand(n, s), -1).astype(np.float32)
    ref = j_bilateral(jnp.asarray(rgb), jnp.asarray(neighbors),
                      jnp.asarray(sigma), jnp.asarray(z), white_bkgd,
                      activation, gamma=0.5)
    got = bilateral_volumetric_rendering(t(rgb), t(neighbors), t(sigma),
                                         t(z), white_bkgd, activation,
                                         gamma=0.5)
    weights = np.asarray(ref[3])
    # the blend took some samples and left others
    assert 0 < (weights >= 1e-2).mean() < 1
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=BILATERAL_ATOL)


@pytest.mark.parametrize("channels", [1, 3])
def test_grad_loss_matches_jax(channels):
    rng = np.random.RandomState(channels)
    pred = rng.rand(2, 12, 10, channels).astype(np.float32)
    target = rng.rand(2, 12, 10, channels).astype(np.float32) * 0.5
    want = float(j_grad_loss(jnp.asarray(pred), jnp.asarray(target)))
    got = grad_loss(t(pred), t(target)).item()
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=GRAD_LOSS_RTOL)
    assert grad_loss(t(pred), t(pred)).item() == 0.0


# ---------------------------------------------------------------------
# the CNNs
# ---------------------------------------------------------------------

CNNS = {
    "resnet_generator": (lambda: jnet.ResnetGenerator(ngf=8, n_blocks=2),
                         lambda: tnet.ResnetGenerator(ngf=8, n_blocks=2)),
    "resnet_generator_instance": (
        lambda: jnet.ResnetGenerator(ngf=8, n_blocks=1, norm="instance"),
        lambda: tnet.ResnetGenerator(ngf=8, n_blocks=1, norm="instance")),
    "resnet_block": (lambda: jnet.ResnetBlock(3),
                     lambda: tnet.ResnetBlock(3)),
    "conv_block": (lambda: jnet.ConvBlock(4, strides=2, padding=1,
                                          normalization="batch"),
                   lambda: tnet.ConvBlock(3, 4, strides=2, padding=1,
                                          normalization="batch")),
    "conv_block_plain": (lambda: jnet.ConvBlock(5, kernel_size=5),
                         lambda: tnet.ConvBlock(3, 5, kernel_size=5)),
    "up2x": (lambda: jnet.Up2x(4, normalization="batch"),
             lambda: tnet.Up2x(3, 4, normalization="batch")),
}


@pytest.mark.parametrize("name", sorted(CNNS))
def test_cnn_matches_flax(name):
    """Eval and train mode on the same variables: outputs to CNN_ATOL and
    (train) the moved batch statistics to STATS_ATOL; the flax variables
    cross both ways."""
    make_j, make_t = CNNS[name]
    x = np.random.RandomState(2).rand(2, 16, 16, 3).astype(np.float32)
    jm, tm = make_j(), make_t()
    variables = _np(jm.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    # every variable moved off its init by up to 0.1, so a batch-norm
    # scale, bias or running value mapped to another layer shows
    rng = np.random.RandomState(4)
    variables = jax.tree_util.tree_map(
        lambda a: a + (rng.rand(*a.shape).astype(np.float32) - 0.5) * 0.2,
        variables)
    load_variables(tm, variables)
    back = export_variables(tm)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(a, b)
    tm.eval()
    with torch.no_grad():
        got = tm(t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(variables,
                                                        jnp.asarray(x))),
                               atol=CNN_ATOL)
    tm.train()
    with torch.no_grad():
        got = tm(t(x)).numpy()
    if "batch_stats" in variables:
        want, moved = jm.apply(variables, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
        moved = _np(moved)["batch_stats"]
        mine = export_variables(tm)["batch_stats"]
        assert jax.tree_util.tree_structure(mine) == \
            jax.tree_util.tree_structure(moved)
        for a, b in zip(jax.tree_util.tree_leaves(mine),
                        jax.tree_util.tree_leaves(moved)):
            np.testing.assert_allclose(a, b, rtol=STATS_RTOL,
                                       atol=STATS_ATOL)
    else:
        want = jm.apply(variables, jnp.asarray(x), train=True)
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), atol=CNN_ATOL)


def test_resnet_generator_gradients_flow():
    tm = tnet.ResnetGenerator(ngf=8, n_blocks=2,
                              generator=torch.Generator().manual_seed(0))
    x = torch.rand(2, 16, 16, 3)
    out = tm(x)
    assert out.shape == (2, 16, 16, 3)
    out.square().mean().backward()
    for name, p in tm.named_parameters():
        assert p.grad is not None and p.grad.abs().max() > 0, name


# ---------------------------------------------------------------------
# the pix2pix transforms
# ---------------------------------------------------------------------

@pytest.mark.parametrize("method", ["nearest", "bilinear", "bicubic",
                                    "lanczos"])
def test_resize_matches_cv2(method):
    rng = np.random.RandomState(5)
    shares = []
    for (h, w), (nw, nh) in (((17, 23), (46, 34)), ((40, 30), (15, 20)),
                             ((32, 32), (11, 8)), ((24, 20), (20, 24))):
        for c in (3, 1):
            f32 = rng.rand(h, w, c).astype(np.float32)
            u8 = (rng.rand(h, w, c) * 255).astype(np.uint8)
            got, want = T.resize(f32, (nw, nh), method), \
                jT.resize(f32, (nw, nh), method)
            assert got.shape == want.shape and got.dtype == want.dtype
            np.testing.assert_allclose(got, want, atol=RESIZE_FLOAT_ATOL)
            got, want = T.resize(u8, (nw, nh), method), \
                jT.resize(u8, (nw, nh), method)
            assert got.shape == want.shape and got.dtype == np.uint8
            diff = np.abs(got.astype(int) - want.astype(int))
            assert diff.max() <= 1
            shares.append((diff > 0).mean())
    print(f"[resize {method}] uint8 pixels one level off cv2: "
          f"{max(shares):.4f} at most, {np.mean(shares):.4f} on average")


def test_transform_helpers_match_jax(capsys):
    img = (np.random.RandomState(6).rand(30, 41, 3) * 255).astype(np.uint8)
    # get_params: the same draws from one RandomState
    for pre in ("resize_and_crop", "scale_width_and_crop", "crop", "none"):
        for seed in range(4):
            assert T.get_params(pre, (41, 30), 36, 16,
                                np.random.RandomState(seed)) == \
                jT.get_params(pre, (41, 30), 36, 16,
                              np.random.RandomState(seed))
    # crop: PIL's zero-padded box; flip
    for pos in ((0, 0), (30, 20), (39, 28)):
        np.testing.assert_array_equal(T.crop(img, pos, 16),
                                      jT.crop(img, pos, 16))
    np.testing.assert_array_equal(T.crop(img[:10, :12], (3, 3), 16),
                                  img[:10, :12])
    np.testing.assert_array_equal(T.flip(img, True), jT.flip(img, True))
    # grayscale: (H, W, 1) in the image's dtype, as JAX
    for x in (img, img / 255.0):
        g, jg = T.to_grayscale(x), jT.to_grayscale(x)
        assert g.shape == jg.shape == (30, 41, 1) and g.dtype == jg.dtype
        np.testing.assert_allclose(g, jg, atol=1e-6)
    # scale_width and make_power_2 alone drop a single channel, as cv2
    gray = T.to_grayscale(img)
    for fn, jfn in ((lambda x: T.scale_width(x, 20, 8),
                     lambda x: jT.scale_width(x, 20, 8)),
                    (lambda x: T.make_power_2(x, 4),
                     lambda x: jT.make_power_2(x, 4))):
        got, want = fn(gray), jfn(gray)
        assert got.shape == want.shape and got.ndim == 2
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert T.scale_width(img, 41, 16) is img
    # make_power_2 warns once
    capsys.readouterr()
    T._WARNED_POWER2 = False
    T.make_power_2(img, 4)
    T.make_power_2(img, 8)
    assert capsys.readouterr().out.count("multiple of") == 1


@pytest.mark.parametrize("kw", [
    dict(preprocess="resize_and_crop", load_size=36, crop_size=16),
    dict(preprocess="scale_width_and_crop", load_size=36, crop_size=16,
         method="bilinear"),
    dict(preprocess="crop", crop_size=16, no_flip=True),
    dict(preprocess="none", grayscale=True, method="nearest"),
    dict(preprocess="scale_width", load_size=24, crop_size=16,
         grayscale=True, convert=False)], ids=lambda kw: kw["preprocess"])
def test_get_transform_matches_jax(kw):
    img = (np.random.RandomState(7).rand(30, 41, 3) * 255).astype(np.uint8)
    for seed in range(3):
        got = T.get_transform(rng=np.random.RandomState(seed), **kw)(img)
        want = jT.get_transform(rng=np.random.RandomState(seed), **kw)(img)
        assert got.shape == want.shape and got.dtype == want.dtype
        # one uint8 level, in (-1, 1) after the conversion
        atol = 1 if got.dtype == np.uint8 else 2.0 / 255 + 1e-6
        assert np.abs(got.astype(np.float64) - want).max() <= atol


# ---------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------

_PHASE = {"train.py": "train", "train_blender.py": "train",
          "train_refine.py": "train", "test.py": "test",
          "test_refine.py": "test"}


def _script_command_lines():
    """(script, entry, argv) of every python command of scripts/*.sh, as
    bash expands it with the scripts' default arguments."""
    out = []
    for script in sorted((REPO / "scripts").glob("*.sh")):
        printed = subprocess.run(
            ["bash", "-c", 'python() { printf "%s\\0" "$@"; echo; }; '
             '. "$0"', str(script)], capture_output=True, text=True,
            check=True, timeout=30).stdout
        for line in printed.splitlines():
            argv = line.split("\0")[:-1]
            if argv and argv[0] in _PHASE:
                out.append((script.name, argv[0], argv[1:]))
    return out


EXTRA = [[], ["--suffix", "{model}_{downscale}"], ["--verbose"],
         ["--accelerator", "ddp", "--num_threads", "2", "--eval_batch_size",
          "3", "--point_chunk", "1024", "--embedding",
          "positional_encoding", "--with_sr", "--n_layers_D", "4",
          "--profile_port", "9999"]]


@pytest.mark.parametrize("extra", EXTRA, ids=["plain", "suffix", "verbose",
                                              "no_ops"])
def test_script_command_lines_parse_as_jax(extra):
    lines = _script_command_lines()
    assert len(lines) == 11
    for script, entry, argv in lines:
        phase = _PHASE[entry]
        got = vars(parse_options(phase, argv + extra))
        want = vars(j_parse_options(phase, argv + extra))
        assert got.pop("device") == "cuda"
        # accepted and ignored; JAX's default follows its environment
        for opts in (got, want):
            opts.pop("compilation_cache_dir")
        assert got == want, script
        if extra[:1] == ["--suffix"]:
            assert got["name"].endswith(f"_{want['model']}_"
                                        f"{want['downscale']}")


def test_no_op_flags_keep_jax_choices():
    with pytest.raises(SystemExit):
        parse_options("train", ["--name", "x", "--dataset_root", ".",
                                "--img_wh", "8", "8", "--accelerator",
                                "tpu"])
    with pytest.raises(SystemExit):
        parse_options("train", ["--name", "x", "--dataset_root", ".",
                                "--img_wh", "8", "8", "--embedding",
                                "hash_grid"])


# ---------------------------------------------------------------------
# the reference checkpoint converter
# ---------------------------------------------------------------------

def _reference_state(depth, width, c_pos, c_dir, prefix, seed):
    rng = np.random.RandomState(seed)
    sd = {}

    def lin(name, n_in, n_out):
        sd[prefix + name + ".weight"] = torch.from_numpy(
            rng.randn(n_out, n_in).astype(np.float32))
        sd[prefix + name + ".bias"] = torch.from_numpy(
            rng.randn(n_out).astype(np.float32))

    for i in range(depth):
        n_in = c_pos if i == 0 else (width + c_pos if i == 4 else width)
        lin(f"xyz_encoding_{i + 1}.0", n_in, width)
    lin("xyz_encoding_final", width, width)
    lin("sigma", width, 1)
    lin("dir_encoding.0", width + c_dir, width // 2)
    lin("rgb.0", width // 2, 3)
    return sd


def test_converter_matches_the_reference_tool(tmp_path):
    """A synthetic ``{epoch}_net_{Coarse,Fine}.pth`` pair with
    ``module.`` prefixes: the port's key map gives the tool's leaves,
    and the written checkpoint holds them, for the port and for the JAX
    package."""
    depth, width, c_pos, c_dir = 6, 32, 63, 27
    ref = tmp_path / "ref"
    ref.mkdir()
    sds = {}
    for i, net in enumerate(("Coarse", "Fine")):
        sds[net] = _reference_state(depth, width, c_pos, c_dir, "module.", i)
        torch.save(sds[net], ref / f"7_net_{net}.pth")
    for sd in sds.values():
        mine = reference_state_to_flax(sd, depth)
        tool = torch_mlp_state_to_flax(sd, depth)
        assert jax.tree_util.tree_structure(mine) == \
            jax.tree_util.tree_structure(tool)
        for a, b in zip(jax.tree_util.tree_leaves(mine),
                        jax.tree_util.tree_leaves(tool)):
            np.testing.assert_array_equal(a, b)
    path = convert_main([str(ref), "7", str(tmp_path / "ck"), "conv",
                         "--D", str(depth), "--W", str(width)])
    assert path.endswith("7_state.msgpack")
    assert (tmp_path / "ck" / "conv" / "latest_state.msgpack").exists()
    opt = default_options("test", model="nerf", dataset_mode="llff",
                          D=depth, W=width, name="conv",
                          checkpoints_dir=str(tmp_path / "ck"))
    system = create_model(opt, device="cpu")
    state = system.create_state(seed=3, steps_per_epoch=1)
    ckpt.load_checkpoint(opt, state, epoch=7)
    got = export_params(state.params)
    for level, net in (("coarse", "Coarse"), ("fine", "Fine")):
        tool = torch_mlp_state_to_flax(sds[net], depth)
        for a, b in zip(jax.tree_util.tree_leaves(got[level]),
                        jax.tree_util.tree_leaves(tool)):
            np.testing.assert_array_equal(a, b)
    raw = ckpt.read_checkpoint(path)
    assert int(raw["step"]) == 0 and sorted(raw["opt_state"]) == ["0", "1"]
    # the JAX package reads the file into its own state
    jopt = j_default_options("test", model="nerf", dataset_mode="llff",
                             D=depth, W=width, name="conv",
                             checkpoints_dir=str(tmp_path / "ck"))
    jsys = j_create_model(jopt)
    jstate = j_ckpt.load_checkpoint(
        jopt, jsys.create_state(jax.random.PRNGKey(0), steps_per_epoch=1),
        epoch=7)
    for level, net in (("coarse", "Coarse"), ("fine", "Fine")):
        tool = torch_mlp_state_to_flax(sds[net], depth)
        for a, b in zip(jax.tree_util.tree_leaves(
                _np(jstate.params[level])), jax.tree_util.tree_leaves(tool)):
            np.testing.assert_array_equal(a, b)


def test_converter_runs_as_a_module(tmp_path):
    ref = tmp_path / "ref"
    ref.mkdir()
    for i, net in enumerate(("Coarse", "Fine")):
        torch.save(_reference_state(2, 16, 63, 27, "", i),
                   ref / f"1_net_{net}.pth")
    subprocess.run([sys.executable, "-m", "nerfsr_torch.convert_reference_"
                    "ckpt", str(ref), "1", str(tmp_path / "ck"), "m", "--D",
                    "2", "--W", "16", "--model", "nerf_downX"],
                   cwd=REPO, check=True, timeout=120)
    assert (tmp_path / "ck" / "m" / "1_state.msgpack").exists()


def test_port_imports_no_cv2_or_pil_subprocess():
    code = (
        "import importlib, pkgutil, sys, nerfsr_torch\n"
        "for m in pkgutil.walk_packages(nerfsr_torch.__path__, "
        "'nerfsr_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('cv2', 'PIL', 'jax', 'flax', 'optax', 'nerfsr_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
    pattern = re.compile(r"^\s*(import|from)\s+(cv2|PIL)\b", re.MULTILINE)
    for f in sorted((REPO / "nerfsr_torch").rglob("*.py")):
        assert not pattern.search(f.read_text()), f
