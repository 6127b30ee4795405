"""Data parallelism of the port (``nerfsr_torch/parallel/mesh.py``) on
the CPU: two gloo ranks of ``python -m nerfsr_torch.train``'s entry point
on a tiny synthetic COLMAP scene (NeRF-SR x2, ``--fast_preset llff``,
randomized, with sigma noise), one process a rank:

    python -m nerfsr_torch.train <flags> --device cpu \\
        --coordinator 127.0.0.1:PORT --num_processes 2 --process_id {0,1}

held against the same run in one process without a group:

- the two ranks' final states (parameters and Adam moments) are equal
  bit for bit;
- one step's gradient from the same weights and batch equals the
  one-rank step's (the draws are the world's rows on both);
- 3 steps at lr 1e-5 agree with the one-rank run;
- the eval image, each rank rendering its share of every chunk and
  gathering the others', equals the one-rank render of the same weights;
- only rank 0 wrote checkpoints, options, metrics and visuals;
- ``--mesh_devices 2`` without ``--num_processes`` spawns the two ranks
  itself and ends at rank 0's checkpoint of the explicit run, bit for
  bit.

Each process has a time limit of its own.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in a test worker)

from nerfsr_torch import train as train_entry
from nerfsr_torch.config import parse_options
from nerfsr_torch.data import create_dataset
from nerfsr_torch.data.llff import center_poses, spiral_path
from nerfsr_torch.data.synthetic import write_llff_scene
from nerfsr_torch.models import create_model
from nerfsr_torch.parallel import mesh
from nerfsr_torch.weights import param_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROC_TIMEOUT_S = 240
H, W = 24, 32
LR, K = 1e-5, 3
# one step's gradient, two ranks against one: the same rows and draws,
# the means summed in halves (f32 rounding), per leaf and norm-relative
GRAD_RTOL = 1e-5
# the eval image from the same weights: the same rays, rendered in
# shares of each chunk
IMAGE_ATOL = 1e-6

# what each rank runs: the entry point, then one step's gradient from the
# seed's weights on the first rows of the buffer, then the val view's
# render of the trained weights; it saves them under OUT/rank{r}.pt
RANK_SCRIPT = """
import sys, torch
from nerfsr_torch import engine, train
from nerfsr_torch.config import parse_options
from nerfsr_torch.data import create_dataset
from nerfsr_torch.parallel import mesh
from nerfsr_torch.weights import param_leaves
out, argv = sys.argv[1], sys.argv[2:]
state = train.main(argv)
opt = parse_options("train", argv)
res = {"state": {p: t.detach().clone() for p, t, _ in
                 param_leaves(state.params)}}
for p, t, _ in param_leaves(state.params):
    for k, v in state.optimizer.state[t].items():
        res["state"][p + "/" + k] = v.clone()
system = engine.setup(opt)
fresh = system.create_state(seed=opt.seed, steps_per_epoch=3)
buf = create_dataset(opt, "train").ray_buffer()
batch = {k: torch.from_numpy(v[:opt.batch_size]) for k, v in buf.items()}
system.train_step(fresh, batch, torch.Generator().manual_seed(5))
res["grads"] = {p: t.grad.clone() for p, t, _ in param_leaves(fresh.params)}
res["render"] = system.render_eval(state.params,
                                   create_dataset(opt, "val"), 0)
torch.save(res, f"{out}/rank{mesh.rank()}.pt")
mesh.shutdown()
"""


def _argv(scene, root, tag):
    return ["--name", "dist", "--model", "nerf_downX", "--dataset_mode",
            "llff_downX", "--dataset_root", scene, "--img_wh", str(W),
            str(H), "--downscale", "2", "--fast_preset", "llff",
            "--precision", "f32", "--D", "2", "--W", "32", "--device",
            "cpu", "--batch_size", "16", "--lr", str(LR), "--n_epochs", "1",
            "--n_epochs_decay", "0", "--steps_per_epoch", str(K),
            "--scan_steps", str(K), "--val_freq", "0", "--val_epoch_freq",
            "1", "--save_epoch_freq", "1", "--checkpoints_dir",
            os.path.join(root, f"ck_{tag}"), "--summary_dir",
            os.path.join(root, f"runs_{tag}")]


def _env():
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


def _run(procs):
    """Wait for each process within its limit; kill the others on a
    timeout. Returns the logs."""
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=PROC_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a rank timed out (a collective that never met?)")
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"process {i} failed:\n{log[-4000:]}"
    return logs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The scene, the two ranks' results and the one-rank references."""
    root = tmp_path_factory.mktemp("dist")
    rng = np.random.RandomState(0)
    poses, _ = center_poses(spiral_path(np.array([0.2, 0.2, 0.05]), 3.5, 4))
    yy, xx = np.mgrid[0:H, 0:W] / 5.0
    imgs = np.stack([np.stack([np.sin(xx * (1 + c) + i) * np.cos(yy + c)
                               for c in range(3)], -1) for i in range(4)])
    imgs = ((imgs * 0.5 + 0.5) * 255).astype(np.uint8)
    scene = write_llff_scene(str(root / "scene"), poses, imgs, 28.0,
                             rng.randn(200, 3) * 0.5 + [0, 0, -4.0])
    port = mesh.free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(root)]
        + _argv(scene, str(root), f"p{r}")
        + ["--coordinator", f"127.0.0.1:{port}", "--num_processes", "2",
           "--process_id", str(r)],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    # meanwhile: --mesh_devices 2 spawns its own ranks
    spawned = subprocess.Popen(
        [sys.executable, "-m", "nerfsr_torch.train", "--mesh_devices", "2"]
        + _argv(scene, str(root), "spawn"), cwd=REPO, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _run(procs + [spawned])
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False)
             for r in (0, 1)]

    # the one-rank references, in this process
    argv = _argv(scene, str(root), "one")
    one = train_entry.main(argv)
    opt = parse_options("train", argv)
    system = create_model(opt, device="cpu")
    fresh = system.create_state(seed=opt.seed, steps_per_epoch=K)
    buf = create_dataset(opt, "train").ray_buffer()
    system.train_step(fresh, {k: torch.from_numpy(v[:opt.batch_size])
                              for k, v in buf.items()},
                      torch.Generator().manual_seed(5))
    state = system.create_state(seed=0, steps_per_epoch=K)
    with torch.no_grad():
        for p, t, _ in param_leaves(state.params):
            t.copy_(ranks[0]["state"][p])
    render = system.render_eval(state.params, create_dataset(opt, "val"), 0)
    return {"root": root, "ranks": ranks, "one": one, "fresh": fresh,
            "render": render}


def test_ranks_end_equal(runs):
    a, b = (r["state"] for r in runs["ranks"])
    assert a.keys() == b.keys() and len(a) > 10
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_one_step_gradient_matches_one_rank(runs):
    grads = runs["ranks"][0]["grads"]
    for p, t, _ in param_leaves(runs["fresh"].params):
        ref = t.grad.double()
        got = grads[p].double()
        assert float((got - ref).norm()) <= GRAD_RTOL * float(ref.norm()), p
        assert torch.equal(grads[p], runs["ranks"][1]["grads"][p]), p


def test_three_steps_match_one_rank(runs):
    """Every weight within 2 lr K of the one-rank run's (an Adam step is
    about lr times a sign, which may turn where a gradient is within
    rounding of zero), and nearly all of them within rounding of it."""
    got = runs["ranks"][0]["state"]
    n_close = n_all = 0
    for p, t, _ in param_leaves(runs["one"].params):
        d = (got[p] - t.detach()).abs()
        assert float(d.max()) <= 2 * LR * K * (1 + 1e-5), p
        n_close += int((d <= 1e-7 + 1e-6 * float(t.detach().abs().max()))
                       .sum())
        n_all += d.numel()
    assert n_close >= 0.99 * n_all, n_close / n_all


def test_eval_image_matches_one_rank(runs):
    for rank in runs["ranks"]:
        got = rank["render"]
        assert got.keys() == runs["render"].keys()
        for k, v in runs["render"].items():
            np.testing.assert_allclose(got[k], v, rtol=0, atol=IMAGE_ATOL,
                                       err_msg=k)


def test_only_the_master_writes(runs):
    root = runs["root"]
    names = set(os.listdir(root / "ck_p0" / "dist"))
    assert {"1_state.msgpack", "latest_state.msgpack", "train_opt.txt",
            "1_val_vis"} <= names
    assert os.listdir(root / "ck_p0" / "dist" / "1_val_vis")
    assert os.path.getsize(root / "runs_p0" / "dist" / "metrics.jsonl") > 0
    assert not os.path.exists(root / "ck_p1")
    assert not os.path.exists(root / "runs_p1")


def test_spawned_ranks_equal_the_explicit_ones(runs):
    """``--mesh_devices 2`` (no ``--num_processes``) on the CPU spawns two
    gloo ranks: its checkpoint is the explicit run's byte for byte."""
    root = runs["root"]
    with open(root / "ck_spawn" / "dist" / "1_state.msgpack", "rb") as f:
        spawned = f.read()
    with open(root / "ck_p0" / "dist" / "1_state.msgpack", "rb") as f:
        explicit = f.read()
    assert spawned == explicit
