"""The zoo's systems on the CPU against the JAX package: NeuTexMLP inside
the NeRF systems, and the template system through the engine.

- ``--mlp_network neutex_mlp`` (D4/W32, f32, on the module path): one
  ``nerf`` (parity, 16 + 16 samples) and one ``nerf_downX`` (``--fast_
  preset llff``) ``_loss_fn``, the loss to 1e-5 and every gradient leaf
  to ``tests/test_torch_train.py``'s bars; an eval render of a view to
  the serving slice's bar; its msgpack checkpoint read across both ways;
  a chunk's body (``train_steps_scan``) against the eager steps bit for
  bit, with ``--fix_layers`` on a NeuTex-only leaf; the engine end to end
  through the entry points with a resume;
- ``--model template``: 5 steps on the same injected rows, the first
  mse to 1e-6 and the later ones to 2e-5 (the two Adams round apart by
  an ulp), and the parameters after them; its checkpoint both ways;
  ``python -m nerfsr_torch.train`` with no ``--model`` trains it, and
  with the defaults raises at the first validation, after that epoch's
  checkpoint, where the JAX engine raises.
"""

import os
import pathlib
import sys

import flax.serialization as fs
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsr_tpu import engine as j_engine
from nerfsr_tpu.config import default_options as j_default_options
from nerfsr_tpu.data import create_dataset as j_create_dataset
from nerfsr_tpu.models import create_model as j_create_model
from nerfsr_tpu.utils import checkpoint as j_ckpt

from nerfsr_torch import test as test_entry
from nerfsr_torch import train as train_entry
from nerfsr_torch.config import default_options
from nerfsr_torch.data import create_dataset
from nerfsr_torch.data.views import LLFFDownXViews
from nerfsr_torch.models import create_model
from nerfsr_torch.models.nerf_system import NeRFSystem
from nerfsr_torch.models.template_system import TemplateSystem
from nerfsr_torch.utils import checkpoint as ckpt
from nerfsr_torch.weights import export_params, load_jax_params, param_leaves

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from tools.make_synthetic_llff import make_llff_scene  # noqa: E402

NEUTEX = dict(mlp_network="neutex_mlp", D=4, W=32, precision="f32")
MODELS = {
    "nerf": dict(model="nerf", dataset_mode="llff", img_wh=(16, 12),
                 N_coarse=16, N_importance=16),
    "nerf_downX": dict(model="nerf_downX", dataset_mode="llff_downX",
                       img_wh=(16, 12), downscale=2, fast_preset="llff"),
}
# tests/test_torch_train.py's bars: the loss of another summation order,
# gradients per leaf, norm-relative (the first layer's carry the
# 2^9-frequency encodings' roundings), and their median
LOSS_RTOL = 1e-5
GRAD_REL, GRAD_REL_MEDIAN = 2e-2, 2e-3
# the serving slice's f32 bar (tests/test_torch_slice.py)
F32_ATOL = 2e-4
# the template's mse: equal at the first step (seen: bit for bit); after
# it each side's Adam rounds its update at another place (optax divides
# the bias-corrected moments, torch scales the step size), an ulp of a
# parameter (seen 2.4e-7), which moves the mse of 64 rows by up to
# 6.5e-6 of itself
TEMPLATE_FIRST_MSE_RTOL, TEMPLATE_MSE_RTOL = 1e-6, 2e-5
TEMPLATE_PARAM_ATOL = 1e-6


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("llff")
    make_llff_scene(str(d), hw=(12, 16), n_imgs=4)
    return str(d)


def _tree(params):
    return jax.tree_util.tree_map(np.array, params)


def _neutex(model, phase="train", **extra):
    kw = dict(MODELS[model], **NEUTEX, **extra)
    jsys = j_create_model(j_default_options(phase, **kw))
    jstate = jsys.create_state(jax.random.PRNGKey(0), steps_per_epoch=4)
    tree = _tree(jstate.params)
    # a +3 sigma bias gives both sides a scene with content
    for net in tree.values():
        net["params"]["sigma"]["bias"] += 3.0
    system = create_model(default_options(phase, **kw), device="cpu")
    return jsys, jstate, tree, system


def _grad_tree(params):
    return {key: {"params": {
        name: {"kernel": lin.weight.grad.numpy().T,
               "bias": lin.bias.grad.numpy()}
        for name, lin in module.named_children()
        if isinstance(lin, torch.nn.Linear)}}
        for key, module in params.items()}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_neutex_loss_and_grads_match_jax(scene, name):
    extra = dict(randomized=False, noise_std=0.0, dataset_root=scene)
    jsys, _, tree, system = _neutex(name, **extra)
    assert not system.render_cfg.use_fused_mlp
    buf = create_dataset(default_options("train", **MODELS[name], **NEUTEX,
                                         **extra), "train").ray_buffer()
    batch = {k: v[:48] for k, v in buf.items()}
    (j_loss, j_losses), j_grads = jax.value_and_grad(
        lambda p: jsys._loss_fn(p, batch, jax.random.PRNGKey(1), 0),
        has_aux=True)(jax.tree_util.tree_map(jnp.asarray, tree))
    state = system.create_state(0, steps_per_epoch=4)
    load_jax_params(state.params, tree)
    loss, losses = system._loss_fn(
        state.params, {k: torch.from_numpy(v) for k, v in batch.items()},
        None, 0)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=LOSS_RTOL)
    assert set(losses) == set(j_losses)
    for k in j_losses:
        np.testing.assert_allclose(losses[k].item(), float(j_losses[k]),
                                   rtol=1e-4, err_msg=k)
    rel = {}
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(j_grads),
                            jax.tree_util.tree_leaves(
                                _grad_tree(state.params))):
        a = np.asarray(a, np.float64)
        rel[jax.tree_util.keystr(path)] = float(
            np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-12))
        assert np.abs(b).max() > 0, path
    # NeuTex's 9 layers at each big level, the proposal net's 4 (llff)
    assert len(rel) == (2 * 18 if name == "nerf" else 18 + 8)
    assert any("dir_encoding_2" in k for k in rel)
    assert max(rel.values()) < GRAD_REL, rel
    assert np.median(list(rel.values())) < GRAD_REL_MEDIAN, rel


def test_neutex_render_eval_matches_jax():
    jsys, _, tree, system = _neutex("nerf_downX", phase="test")
    views = LLFFDownXViews.spiral(14.0, (16, 12), 2, 3,
                                  radii=(0.2, 0.2, 0.05))
    ref = jsys.render_eval(jax.tree_util.tree_map(jnp.asarray, tree),
                           views, 1)
    assert float(np.asarray(ref["fine_rgb_ori"]).std()) > 0.01
    got = system.render_eval(load_jax_params(system.init_params(0), tree),
                             views, 1)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], np.asarray(ref[k]),
                                   atol=F32_ATOL, err_msg=k)


def _batch_from(system, scene):
    buf = create_dataset(system.opt, "train").ray_buffer()
    return {k: torch.from_numpy(v[:32]) for k, v in buf.items()}


def test_neutex_checkpoint_crosses_both_ways(scene, tmp_path):
    """A JAX NeuTex checkpoint loads into the port, parameters and
    moments; a port one after two steps loads into the JAX package."""
    extra = dict(dataset_root=scene, checkpoints_dir=str(tmp_path),
                 name="neutex")
    jsys, jstate, tree, system = _neutex("nerf_downX", **extra)
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray,
                                                          tree))
    jopt = j_default_options("train", **MODELS["nerf_downX"], **NEUTEX,
                             **extra)
    j_ckpt.save_checkpoint(jopt, jstate, 1)
    state = system.create_state(5, steps_per_epoch=4)
    ckpt.load_checkpoint(system.opt, state, epoch=1)
    for a, b in zip(jax.tree_util.tree_leaves(export_params(state.params)),
                    jax.tree_util.tree_leaves(_tree(jstate.params))):
        np.testing.assert_array_equal(a, b)
    batch = _batch_from(system, scene)
    for _ in range(2):
        system.train_step(state, batch)
    ckpt.save_checkpoint(system.opt, state, 2)
    restored = j_ckpt.load_checkpoint(jopt, jstate, epoch=2)
    assert int(restored.step) == 2
    for a, b in zip(jax.tree_util.tree_leaves(_tree(restored.params)),
                    jax.tree_util.tree_leaves(export_params(state.params))):
        np.testing.assert_array_equal(a, b)
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                restored.opt_state[0].mu)}
    for path, p, is_kernel in param_leaves(state.params):
        m = state.optimizer.state[p]["exp_avg"].numpy()
        np.testing.assert_array_equal(flat[path], m.T if is_kernel else m)


def test_neutex_chunk_body_equals_the_eager_steps(scene):
    """``train_steps_scan``'s body against ``train_steps`` from one seed,
    bit for bit, with ``--fix_layers`` freezing a leaf only NeuTex has:
    the frozen leaf stays put, the others move."""
    kw = dict(MODELS["nerf_downX"], **NEUTEX, dataset_root=scene,
              fix_layers="fine/params/dir_encoding_2/kernel", batch_size=8)
    states = []
    for route in ("train_steps", "train_steps_scan"):
        system = create_model(default_options("train", **kw), device="cpu")
        state = system.create_state(0, steps_per_epoch=10)
        before = {path: p.detach().clone()
                  for path, p, _ in param_leaves(state.params)}
        buffer = {k: torch.from_numpy(v) for k, v in create_dataset(
            system.opt, "train").ray_buffer().items()}
        gen = torch.Generator().manual_seed(3)
        state, losses = getattr(system, route)(state, buffer, 3, gen)
        assert np.isfinite(float(losses["tot"])) and state.step == 3
        states.append(state)
    for (path, a, _), (_, b, _) in zip(param_leaves(states[0].params),
                                       param_leaves(states[1].params)):
        assert torch.equal(a, b), path
        frozen = path == "fine/params/dir_encoding_2/kernel"
        assert torch.equal(a, before[path]) == frozen, path


def test_neutex_engine_end_to_end(scene, tmp_path):
    """``--mlp_network neutex_mlp`` through the entry points: train an
    epoch, resume to a second, test from it."""
    common = ["--name", "neutex", "--model", "nerf_downX", "--dataset_mode",
              "llff_downX", "--dataset_root", scene, "--img_wh", "16", "12",
              "--downscale", "2", "--fast_preset", "llff", "--precision",
              "f32", "--mlp_network", "neutex_mlp", "--D", "2", "--W", "16",
              "--device", "cpu", "--checkpoints_dir", str(tmp_path / "ck")]
    train = ["--batch_size", "16", "--steps_per_epoch", "3", "--val_freq",
             "0", "--summary_dir", str(tmp_path / "runs")]
    train_entry.main(common + train + ["--n_epochs", "1"])
    state = train_entry.main(common + train + ["--n_epochs", "2",
                                               "--continue_train"])
    assert state.step == 6
    test_entry.main(common + ["--results_dir", str(tmp_path / "res"),
                              "--test_split", "test_train", "--load_epoch",
                              "2"])
    assert (tmp_path / "res" / "neutex" / "test_train_2" /
            "0-fine-ori.png").exists()


# ---------------------------------------------------------------------
# the template system
# ---------------------------------------------------------------------

def _template_systems(tmp_path, **extra):
    kw = dict(batch_size=64, lr=1e-2, n_epochs=3, n_epochs_decay=2,
              checkpoints_dir=str(tmp_path), name="tpl", **extra)
    jopt = j_default_options("train", **kw)
    jsys = j_create_model(jopt)
    jstate = jsys.create_state(jax.random.PRNGKey(0), steps_per_epoch=2)
    opt = default_options("train", device="cpu", **kw)
    assert opt.model == jopt.model == "template"
    system = create_model(opt, device="cpu")
    assert isinstance(system, TemplateSystem)
    state = system.create_state(seed=1, steps_per_epoch=2)
    # the JAX state's parameters and (empty) moments into the port
    ckpt.load_state_dict(opt, state, fs.to_state_dict(
        jax.tree_util.tree_map(np.asarray, jstate)))
    return jopt, jsys, jstate, opt, system, state


def test_template_steps_match_jax(tmp_path):
    """5 steps (the schedule crosses two epoch ends) on the same rows:
    the mse of each and the parameters after them."""
    jopt, jsys, jstate, opt, system, state = _template_systems(tmp_path)
    ds, jds = create_dataset(opt, "train"), j_create_dataset(jopt, "train")
    np.testing.assert_array_equal(ds.x, jds.x)
    buffer = {k: torch.from_numpy(v) for k, v in ds.ray_buffer().items()}
    rng = np.random.RandomState(0)
    for step in range(5):
        idx = rng.randint(0, len(ds), 64)
        jstate, j_losses = jsys.train_step(
            jstate, {k: v[idx] for k, v in jds.ray_buffer().items()},
            jax.random.PRNGKey(0))
        state, losses = system.train_step_from_buffer(
            state, buffer, idx=torch.from_numpy(idx))
        assert set(losses) == set(j_losses) == {"mse", "tot"}
        np.testing.assert_allclose(
            losses["mse"].item(), float(j_losses["mse"]), err_msg=step,
            rtol=TEMPLATE_MSE_RTOL if step else TEMPLATE_FIRST_MSE_RTOL)
    want = ckpt.state_dict(opt, state)["params"]
    for a, b in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(_tree(jstate.params))):
        np.testing.assert_allclose(a, b, atol=TEMPLATE_PARAM_ATOL)
    assert state.step == int(jstate.step) == 5
    # the rows it draws itself: min(batch, 256) of them, in range
    assert system.sample_indices(len(ds)).shape == (64,)


def test_template_checkpoint_crosses_both_ways(tmp_path):
    jopt, jsys, jstate, opt, system, state = _template_systems(tmp_path)
    buffer = {k: torch.from_numpy(v) for k, v in
              create_dataset(opt, "train").ray_buffer().items()}
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        state, _ = system.train_step_from_buffer(state, buffer, gen)
    ckpt.save_checkpoint(opt, state, 1)
    restored = j_ckpt.load_checkpoint(jopt, jstate, epoch=1)
    sd = fs.to_state_dict(jax.tree_util.tree_map(np.asarray, restored))
    mine = ckpt.state_dict(opt, state)
    assert int(sd["step"]) == 3
    for a, b in zip(jax.tree_util.tree_leaves(mine),
                    jax.tree_util.tree_leaves(sd)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # JAX -> port: one more JAX step, saved, read by a fresh port state
    restored, _ = jsys.train_step_from_buffer(
        restored, create_dataset(opt, "train").ray_buffer(),
        jax.random.PRNGKey(4))
    j_ckpt.save_checkpoint(jopt, restored, 2)
    fresh = system.create_state(seed=9, steps_per_epoch=2)
    ckpt.load_checkpoint(opt, fresh, epoch=2)
    for a, b in zip(jax.tree_util.tree_leaves(ckpt.state_dict(opt, fresh)),
                    jax.tree_util.tree_leaves(fs.to_state_dict(
                        jax.tree_util.tree_map(np.asarray, restored)))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _argv(tmp_path, *extra):
    return ["--name", "t", "--dataset_root", str(tmp_path), "--img_wh", "8",
            "8", "--checkpoints_dir", str(tmp_path / "ck"), "--summary_dir",
            str(tmp_path / "runs"), *extra]


def test_template_trains_through_the_entry_point(tmp_path, capsys):
    """No ``--model``: the template trains, its mse falls, it resumes,
    and the epoch-end render of ``--val_epoch_split`` is skipped as in
    the JAX engine."""
    argv = _argv(tmp_path, "--device", "cpu", "--val_freq", "0",
                 "--val_epoch_freq", "0", "--vis_epoch_freq", "2",
                 "--batch_size", "100", "--lr", "1e-2", "--print_freq", "5",
                 "--n_epochs_decay", "0")
    first = train_entry.main(argv + ["--n_epochs", "2"])
    assert first.step == 20
    state = train_entry.main(argv + ["--n_epochs", "4", "--continue_train"])
    assert state.step == 40
    out = capsys.readouterr().out
    assert "resumed from epoch 2 at step 20" in out
    assert out.count("vis_epoch render skipped") == 2
    mses = [float(line.split("mse=")[1].split()[0])
            for line in out.splitlines() if line.startswith("[e")]
    assert len(mses) == 8 and mses[-1] < 0.5 * mses[0]
    assert (tmp_path / "ck" / "t" / "4_state.msgpack").exists()


def test_template_validation_raises_where_jax_raises(tmp_path):
    """The JAX defaults: both engines save epoch 1's checkpoint, then
    raise ``AttributeError`` at the validation (the template renders
    nothing); the JAX package reads the port's file."""
    with pytest.raises(AttributeError, match="TemplateSystem"):
        train_entry.main(_argv(tmp_path, "--device", "cpu"))
    jopt = j_default_options("train", name="t", dataset_root=str(tmp_path),
                             img_wh=(8, 8),
                             checkpoints_dir=str(tmp_path / "jck"),
                             summary_dir=str(tmp_path / "jruns"))
    with pytest.raises(AttributeError, match="TemplateSystem"):
        j_engine.train(jopt)
    names = {"1_state.msgpack", "latest_state.msgpack"}
    assert names <= set(os.listdir(tmp_path / "ck" / "t"))
    assert names <= set(os.listdir(tmp_path / "jck" / "t"))
    jsys = j_create_model(jopt)
    jstate = jsys.create_state(jax.random.PRNGKey(0), steps_per_epoch=1)
    jopt.checkpoints_dir = str(tmp_path / "ck")
    restored = j_ckpt.load_checkpoint(jopt, jstate, epoch=1)
    assert int(restored.step) == 1


def test_template_and_neutex_options_build_systems():
    """The command lines that the port refused before it had these
    modules now build their systems."""
    opt = default_options("train", device="cpu")
    assert opt.model == "template"
    assert isinstance(create_model(opt, device="cpu"), TemplateSystem)
    opt = default_options("train", model="nerf", dataset_mode="llff",
                          mlp_network="neutex_mlp", device="cpu")
    for build in (lambda: create_model(opt, device="cpu"),
                  lambda: NeRFSystem(opt, device="cpu")):
        assert not build().render_cfg.use_fused_mlp
