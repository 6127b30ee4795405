"""The port's chunk of training steps (``train_steps_scan``) and its
one-image eval body on the CPU, where the same bodies run eagerly that
the card replays as CUDA graphs (``nerfsr_torch/graphs.py``):

- three steps of ``NeRFSystem.train_steps_scan`` with JAX's draws
  injected against the JAX package's ``train_steps_scan`` (NeRF-SR x2 on
  ``--fast_preset llff`` with the pad anneal ending inside the chunk and
  on ``parity``, and vanilla NeRF);
- each NeRF system's chunk body reads nothing back to the host (what a
  capture forbids), with ``Tensor.item`` and the other reads made to
  raise (the refine system's: ``tests/test_torch_scan_refine.py``);
- the learning rate and the resample pad as device tensors, the device
  step after uneven chunks, the chunks against the eager per-step loops
  and the eval body against a chunk loop (bit for bit), and a checkpoint
  of the device-resident Adam read by both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in a test worker)

from nerfsr_tpu.config import default_options as j_default_options
from nerfsr_tpu.models import create_model as j_create_model
from nerfsr_tpu.utils import checkpoint as j_ckpt

from nerfsr_torch.config import default_options
from nerfsr_torch.core.rays import get_rays, make_rays, ndc_rays
from nerfsr_torch.data.views import LLFFDownXTrainViews, LLFFDownXViews
from nerfsr_torch.models import create_model
from nerfsr_torch.models.render import _annealed_pad
from nerfsr_torch.utils import checkpoint as ckpt
from nerfsr_torch.utils.schedule import write_lr
from nerfsr_torch.weights import (export_params, load_jax_params,
                                  param_leaves)

HR_WH = (16, 12)
FOCAL = 14.0
K = 3
CASES = {
    # NeRF-SR x2, --fast_preset llff; the pad anneals over 2 steps, so the
    # chunk runs at pads 0.01, 0.005 and 0 (the device step's pad)
    "downX-llff": dict(model="nerf_downX", dataset_mode="llff_downX",
                       downscale=2, fast_preset="llff", prop_pad_anneal=2),
    "downX-parity": dict(model="nerf_downX", dataset_mode="llff_downX",
                         downscale=2, fast_preset="parity", N_coarse=16,
                         N_importance=16),
    "nerf-parity": dict(model="nerf", dataset_mode="llff",
                        fast_preset="parity", N_coarse=16,
                        N_importance=16),
}
# the last step's losses: f32 sums in another order through the MLP and
# the composite (test_torch_train.py's bars: the total, each term)
LOSS_RTOL, TERM_RTOL = 1e-5, 1e-4
# the chunk against JAX's runs at this lr: Adam's first update moves every
# weight by +-lr, so a gradient within rounding of zero turns a whole lr
# around; at the default 5e-4 those turns alone moved the later steps'
# gradients by up to 3% of a leaf and the losses by 1.6e-4 (measured), at
# 1e-5 the losses by 3e-5 at most (the interlevel term)
LR = 1e-5
# a firm element's gradient: above this share of its leaf's largest at
# every step (test_train_step_matches_jax takes 1e-3 for one step; after
# it the two sides' parameters differ where a gradient turned, and JAX's
# scanned program rounds its gradients apart from its eager ones by about
# 1e-3 of a leaf's largest), and within 1% of the port's
FIRM_SHARE, FIRM_AGREE = 1e-2, 1e-2
# what a firm element's later update may move, in lr a step (seen: 0.14
# lr over the chunk at most)
FIRM_LR = 0.1


def _kw(case, **extra):
    kw = dict(img_wh=HR_WH, precision="f32", batch_size=48, n_epochs=4,
              n_epochs_decay=2, randomized=False, noise_std=0.0,
              **CASES[case])
    kw.update(extra)
    return kw


def _buffer(case):
    """Two training views' rays (16x12, 8x6 LR): grouped for NeRF-SR,
    the HR rays flat with their HR colours for vanilla NeRF."""
    views = LLFFDownXViews.spiral(FOCAL, HR_WH, 2, 3, radii=(0.2, 0.2, .05))
    imgs = np.random.RandomState(4).rand(3, HR_WH[1], HR_WH[0], 3)
    buf = LLFFDownXTrainViews(views.poses, imgs, FOCAL, HR_WH, 2
                              ).ray_buffer("cpu", include_var=False)
    buf = {k: v.numpy() for k, v in buf.items()}
    if CASES[case]["model"] == "nerf":
        flat = {k: buf[k].reshape(-1, buf[k].shape[-1])
                for k in ("origins", "directions", "near", "far")}
        flat["rgbs"] = buf["rgbs_ori"].reshape(-1, 3)
        return flat
    return buf


def _jax_indices(key, k, batch, n_total):
    """The rows JAX's ``train_steps_scan`` draws at steps 0..k-1
    (``nerf_system.py:633-637``)."""
    out = []
    for step in range(k):
        idx_key, _ = jax.random.split(jax.random.fold_in(key, step))
        out.append(np.asarray(jax.random.randint(idx_key, (batch,), 0,
                                                 n_total)))
    return np.stack(out)


def _sigma_plus_3(tree):
    for net in tree.values():
        net["params"]["sigma"]["bias"] += 3.0
    return tree


def _grad_leaves(params):
    """Each parameter's gradient in the JAX layout's leaf order."""
    return jax.tree_util.tree_leaves({key: {"params": {
        name: {"kernel": lin.weight.grad.numpy().T,
               "bias": lin.bias.grad.numpy()}
        for name, lin in module.named_children()
        if isinstance(lin, torch.nn.Linear)}}
        for key, module in params.items()})


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_steps_scan_matches_jax(case):
    """K steps of the port's chunk, fed JAX's rows, against JAX's
    ``train_steps_scan``, at lr ``LR``. Adam moves a weight by about lr a
    step, so where a gradient lies within the two sides' difference of
    zero the sign of an update may differ: every parameter is held to
    2 lr K (``test_train_step_matches_jax``'s bound over K steps). Where
    at every step both sides' gradients agree (``FIRM_AGREE``) and lie
    well away from zero (``FIRM_SHARE``), the first update (lr times a
    sign) agrees to f32 rounding, that test's atol, and a later one (lr
    times the ratio of Adam's moments, which move with the gradients'
    differences) to ``FIRM_LR`` lr more a step; held against JAX's steps
    run one at a time, whose gradients made them firm. The last step's
    losses (its rows, its pad, the parameters after K - 1 steps) are held
    to ``LOSS_RTOL`` (each term ``TERM_RTOL``). The chunk equals the same
    steps run as K one-step chunks, bit for bit."""
    buf = _buffer(case)
    kw = _kw(case, lr=LR)
    jsys = j_create_model(j_default_options("train", **kw))
    template = jsys.create_state(jax.random.PRNGKey(0), steps_per_epoch=4)
    tree = _sigma_plus_3(jax.tree_util.tree_map(np.array, template.params))

    def fresh():          # train_steps_scan donates the state it is given
        params = jax.tree_util.tree_map(jnp.asarray, tree)
        return template.replace(step=jnp.zeros((), jnp.int32),
                                params=params,
                                opt_state=jsys.tx.init(params))
    jbuf = {k: jnp.asarray(v) for k, v in buf.items()}
    key = jax.random.PRNGKey(5)
    idx = _jax_indices(key, K, 48, len(buf["rgbs"]))
    tbuf = {k: torch.from_numpy(v) for k, v in buf.items()}

    def port():
        system = create_model(default_options("train", **kw), device="cpu")
        state = system.create_state(0, steps_per_epoch=4)
        load_jax_params(state.params, tree)
        return system, state

    # one step at a time on both sides: the gradients of every step (JAX's
    # at its own parameters, fold_in by the state's step as in the chunk)
    firm, one = None, fresh()
    system, steps = port()
    for step in range(K):
        batch = {k: v[idx[step]] for k, v in buf.items()}
        j_grads = jax.tree_util.tree_leaves(jax.grad(lambda p: jsys._loss_fn(
            p, batch, jax.random.PRNGKey(1), step)[0])(one.params))
        one, _ = jsys.train_steps_scan(one, jbuf, 1, key)
        steps, _ = system.train_steps_scan(
            steps, tbuf, 1, idx=torch.from_numpy(idx[step:step + 1]))
        j_grads = [np.asarray(g) for g in j_grads]
        if firm is None:
            firm = [np.ones(g.shape, bool) for g in j_grads]
        firm = [f & (np.abs(gj) > max(FIRM_SHARE * np.abs(gj).max(), 1e-5))
                & (np.abs(gj - gp) <= FIRM_AGREE * np.abs(gj))
                for f, gj, gp in zip(firm, j_grads,
                                     _grad_leaves(steps.params))]
    jstate, j_losses = jsys.train_steps_scan(fresh(), jbuf, K, key)

    system, state = port()
    state, losses = system.train_steps_scan(state, tbuf, K,
                                            idx=torch.from_numpy(idx))
    assert state.step == K == int(jstate.step) and int(state.step_t) == K
    for a, b in zip(state.params.parameters(), steps.params.parameters()):
        assert torch.equal(a, b)
    n_close = n_all = 0
    for a, b, c, p0, f in zip(
            jax.tree_util.tree_leaves(export_params(state.params)),
            jax.tree_util.tree_leaves(jstate.params),
            jax.tree_util.tree_leaves(one.params),
            jax.tree_util.tree_leaves(tree), firm):
        b, c = np.asarray(b), np.asarray(c)
        atol = 1e-6 + 1e-6 * np.abs(p0).max()
        # the scan and JAX's one-step chunks: XLA rounds the two programs
        # apart, so the firm elements are held against the steps whose
        # gradients made them firm
        for ref in (b, c):
            assert np.abs(a - ref).max() <= 2 * LR * K * (1 + 1e-5)
        np.testing.assert_allclose(a[f], c[f], rtol=0,
                                   atol=atol + FIRM_LR * LR * (K - 1))
        n_close += int(f.sum())
        n_all += f.size
    assert n_close > 0.25 * n_all
    for k in j_losses:
        np.testing.assert_allclose(
            float(losses[k]), float(j_losses[k]),
            rtol=LOSS_RTOL if k == "tot" else TERM_RTOL, err_msg=k)


# ---------------------------------------------------------------------
# what a capture forbids
# ---------------------------------------------------------------------

HOST_READS = ("item", "tolist", "__bool__", "__float__", "__int__", "cpu",
              "numpy")


@pytest.fixture
def no_host_reads(monkeypatch):
    """Inside the ``with``: every read of a tensor's value into the host
    raises, as it would break a CUDA-graph capture on the card."""
    import contextlib

    @contextlib.contextmanager
    def forbid():
        with monkeypatch.context() as m:
            for name in HOST_READS:
                def read(*_, _name=name, **__):
                    raise AssertionError(f"Tensor.{_name} inside a chunk")
                m.setattr(torch.Tensor, name, read)
            yield
    return forbid


def _tiny(case, **extra):
    kw = dict(_kw(case, D=2, W=32, batch_size=16, randomized=True,
                  noise_std=1.0), **extra)
    system = create_model(default_options("train", **kw), device="cpu")
    buf = {k: torch.from_numpy(v) for k, v in _buffer(case).items()}
    return system, buf


@pytest.mark.parametrize("case", ["nerf-parity", "downX-llff",
                                  "downX-parity"])
def test_nerf_chunk_reads_nothing_back(case, no_host_reads):
    """One chunk of each NeRF system (randomized, sigma noise, the pad
    anneal) with every host read made to raise; full width on the fused
    MLP's path for NeRF-SR llff."""
    full = case == "downX-llff"
    system, buf = _tiny(case, **(dict(D=8, W=256) if full else {}))
    assert system.render_cfg.use_fused_mlp == full
    state = system.create_state(0, steps_per_epoch=2)
    gen = torch.Generator().manual_seed(3)
    with no_host_reads():
        state, losses = system.train_steps_scan(state, buf, 3, gen)
    assert state.step == 3 and int(state.step_t) == 3
    assert all(torch.isfinite(v) for v in losses.values())


def test_eval_body_reads_nothing_back(no_host_reads):
    """The one-image eval body (every chunk of a view, NDC rays from the
    pose) with every host read made to raise."""
    system, _ = _tiny("downX-llff")
    params = system.init_params(0)
    views = LLFFDownXViews.spiral(FOCAL, HR_WH, 2, 2)
    dirs = system._eval_dirs_device(views.eval_dirs(), 192, 64)
    spec = views.eval_raygen_spec(1)
    pose = system._pose_pair(spec)
    with no_host_reads(), torch.no_grad():
        out = system._render_dirs_chunks(params, dirs, pose, spec["geom"],
                                         system._EVAL_KEEP)
    assert out["fine_rgb"].shape == (3, 64, 3)


# ---------------------------------------------------------------------
# the device tensors a chunk reads
# ---------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["linear", "exp", "step"])
def test_lr_tensor_follows_the_schedule(policy):
    """The learning rate a chunk reads is the f32 of ``lr_fn(step)``: at
    every step through two epoch ends, written by ``write_lr``, and after
    chunks that cross an epoch's end (each equal to the eager loop, which
    writes the value every step, bit for bit)."""
    extra = dict(lr_policy=policy, n_epochs=4, n_epochs_decay=3,
                 lr_decay_epochs=1, lr_decay_gamma=0.5)
    system, buf = _tiny("nerf-parity", **extra)
    state = system.create_state(0, steps_per_epoch=2)
    for step in range(6):
        write_lr(state.optimizer, system.lr_fn, step)
        got = state.optimizer.param_groups[0]["lr"]
        assert isinstance(got, torch.Tensor)
        assert got.item() == np.float32(system.lr_fn(step))
    assert len({np.float32(system.lr_fn(s)) for s in range(6)}) > 1

    eager, _ = _tiny("nerf-parity", **extra)
    ref = eager.create_state(0, steps_per_epoch=2)
    for k in (3, 2, 4):               # steps 0-2, 3-4, 5-8: epoch ends inside
        start = state.step
        state, losses = system.train_steps_scan(
            state, buf, k, torch.Generator().manual_seed(start))
        ref, ref_losses = eager.train_steps(
            ref, buf, k, torch.Generator().manual_seed(start))
        assert state.optimizer.param_groups[0]["lr"].item() == \
            np.float32(system.lr_fn(state.step - 1))
        for a, b in zip(state.params.parameters(), ref.params.parameters()):
            assert torch.equal(a, b)
        for name in losses:
            assert torch.equal(losses[name], ref_losses[name])


def test_pad_tensor_equals_the_host_pad():
    """The resample pad from the device step equals the host's float
    (rounded to f32) before, at and after the anneal's end, and the eval
    pad is the final one."""
    system, _ = _tiny("downX-llff", prop_pad_anneal=8, prop_pad=0.013,
                      prop_pad_final=0.001)
    cfg = system.render_cfg
    assert cfg.prop_pad_anneal == 8
    for step in (0, 1, 3, 7, 8, 9, 1000):
        pad = _annealed_pad(cfg, torch.tensor(step))
        assert pad.dtype == torch.float32 and pad.shape == ()
        assert pad.item() == np.float32(_annealed_pad(cfg, step))
    assert _annealed_pad(cfg, torch.tensor(8)).item() == np.float32(0.001)
    assert _annealed_pad(cfg, None) == 0.001


def test_device_step_follows_uneven_chunks():
    """The device step equals the host step after chunks of 3, 1 and 5
    steps, graphed-route and eager chunks alike, and after a resume sets
    the host step."""
    system, buf = _tiny("downX-llff")
    state = system.create_state(0, steps_per_epoch=4)
    gen = torch.Generator().manual_seed(0)
    for k, scan in ((3, True), (1, True), (5, False), (2, True)):
        run = system.train_steps_scan if scan else system.train_steps
        state, _ = run(state, buf, k, gen)
        assert int(state.step_t) == state.step
    assert state.step == 11
    state.step = 40               # as a checkpoint load sets it
    state, _ = system.train_steps_scan(state, buf, 1, gen)
    assert (state.step, int(state.step_t)) == (41, 41)


# ---------------------------------------------------------------------
# chunks and eval bodies against their loops
# ---------------------------------------------------------------------

def _same_state(a, b):
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)


@pytest.mark.parametrize("case", ["downX-llff", "nerf-parity"])
def test_nerf_chunk_equals_the_eager_loop(case):
    """A randomized chunk (jitter, sigma noise, the pad anneal) equals the
    eager loop from the same seed bit for bit: parameters, moments and
    the losses of the last step."""
    runs = []
    for scan in (True, False):
        system, buf = _tiny(case)
        state = system.create_state(0, steps_per_epoch=3)
        gen = torch.Generator().manual_seed(11)
        run = system.train_steps_scan if scan else system.train_steps
        state, losses = run(state, buf, 5, gen)
        runs.append((state, losses))
    (a, la), (b, lb) = runs
    _same_state(a.params, b.params)
    for p, q in zip(a.params.parameters(), b.params.parameters()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a.optimizer.state[p][key],
                               b.optimizer.state[q][key])
    assert la.keys() == lb.keys()
    for k in la:
        assert torch.equal(la[k], lb[k]), k


@pytest.mark.parametrize("case", ["downX-llff", "downX-parity"])
def test_eval_body_equals_the_chunk_loop(case):
    """The one-image eval body over (chunks, chunk, 3) directions equals
    rendering each chunk by itself from the pose (rays, NDC, bounds built
    here), bit for bit."""
    system, _ = _tiny(case)
    params = system.init_params(0)
    views = LLFFDownXViews.spiral(FOCAL, HR_WH, 2, 2)
    dirs = system._eval_dirs_device(views.eval_dirs(), 192, 64)
    spec = views.eval_raygen_spec(1)
    pose = system._pose_pair(spec)
    _, h, w, focal, near, far = spec["geom"]
    with torch.no_grad():
        out = system._render_dirs_chunks(params, dirs, pose, spec["geom"],
                                         system._EVAL_KEEP)
        for i, d in enumerate(dirs):
            ro, rd = ndc_rays(h, w, focal, 1.0, *get_rays(d, pose[0]))
            _, vd = ndc_rays(h, w, focal, 1.0, *get_rays(d, pose[1]))
            ref = system.render(params, make_rays(ro, rd, near, far, vd),
                                randomized=False)
            for k in out:
                assert torch.equal(out[k][i], ref[k]), (i, k)
    assert set(out) == {"fine_rgb", "fine_depth"} | (
        {"coarse_rgb", "coarse_depth"} if case == "downX-parity" else set())


# ---------------------------------------------------------------------
# the device-resident Adam in checkpoints
# ---------------------------------------------------------------------

def test_adam_checkpoint_round_trip_both_packages(tmp_path):
    """Two chunks' state saved in the JAX layout: JAX reads the same
    parameters, moments and count; the port reads it back with each
    step count on the parameter's device and the learning rate a
    tensor, and the next chunk from the loaded state equals the next
    chunk of the original bit for bit."""
    kw = dict(checkpoints_dir=str(tmp_path), name="scan")
    system, buf = _tiny("downX-llff", **kw)
    opt = system.opt
    state = system.create_state(0, steps_per_epoch=4)
    for k in (2, 3):
        state, _ = system.train_steps_scan(
            state, buf, k, torch.Generator().manual_seed(k))
    ckpt.save_checkpoint(opt, state, 1)

    jopt = j_default_options("train", **_kw("downX-llff", D=2, W=32,
                                             batch_size=16, **kw))
    jsys = j_create_model(jopt)
    template = jsys.create_state(jax.random.PRNGKey(0), steps_per_epoch=4)
    restored = j_ckpt.load_checkpoint(jopt, template, epoch=1)
    adam = restored.opt_state[0]
    assert int(restored.step) == int(adam.count) == 5
    got = export_params(state.params)
    for a, b in zip(jax.tree_util.tree_leaves(restored.params),
                    jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(np.asarray(a), b)
    for path, p, is_kernel in param_leaves(state.params):
        net, _, layer, leaf = path.split("/")
        for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            m = state.optimizer.state[p][key].numpy()
            np.testing.assert_array_equal(
                np.asarray(tree[net]["params"][layer][leaf]),
                m.T if is_kernel else m)

    other, _ = _tiny("downX-llff", **kw)
    loaded = other.create_state(0, steps_per_epoch=4)
    ckpt.load_checkpoint(opt, loaded, epoch=1)
    assert loaded.step == 5
    for p in loaded.params.parameters():
        st = loaded.optimizer.state[p]["step"]
        assert st.device == p.device and st.item() == 5.0
    assert isinstance(loaded.optimizer.param_groups[0]["lr"], torch.Tensor)
    a, _ = system.train_steps_scan(state, buf, 3,
                                   torch.Generator().manual_seed(9))
    b, _ = other.train_steps_scan(loaded, buf, 3,
                                  torch.Generator().manual_seed(9))
    _same_state(a.params, b.params)
