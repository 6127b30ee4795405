"""The writer threads (``utils/visualizer.py:ViewWriter``) and the loops
that write through them (``engine.test``, ``engine.validate``) on the
CPU: every file byte for byte what the serial writers (``save_visuals``,
``write_gif``) write of the same visuals, at 1, 2 and 4 threads; GIF
frames in view order whatever order the jobs end in; a job's exception
raised in the caller; no call back before its files are on disk; at most
two views a thread in flight; span totals exact when several threads
close spans at once; ``test``'s ``timings`` with ``wait_s``."""

import copy
import functools
import hashlib
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads in a test worker)

from nerfsr_torch import engine, spans
from nerfsr_torch.config import default_options
from nerfsr_torch.data import create_dataset
from nerfsr_torch.data.llff import center_poses, spiral_path
from nerfsr_torch.data.synthetic import write_llff_scene
from nerfsr_torch.models import create_model
from nerfsr_torch.utils import checkpoint as ckpt
from nerfsr_torch.utils import visualizer
from nerfsr_torch.utils.visualizer import (ViewWriter, Visualizee, gif_bytes,
                                           gif_frame, save_visuals,
                                           write_gif)

HW = (24, 32)
N_VIEWS = 4
TIMEOUT_S = 60.0
# sha256 of write_gif(_frames()) and of save_visuals' PNG of _strip(),
# as the serial writers wrote them before the pool
GIF_SHA = "56162d855b54810235c4d4f8ee7788b8048c64d83a3a1590ac13c25b820f28fc"
PNG_SHA = "1f2eac14f4a8fa9a075d3dccdd31629a267160007f787217a3236aabf447333f"


def _frames():
    """Three frames of more than 256 colours (the colour cube), one of a
    single colour (its own palette) and a gray one."""
    yy, xx = np.mgrid[0:21, 0:34]
    out = [(np.stack([xx * 7 + yy * 3 + 40 * k, xx * xx + yy * 5,
                      (yy * 11) ^ k], -1) % 256).astype(np.uint8)
           for k in range(3)]
    out.append(np.full((21, 34, 3), (10, 200, 30), np.uint8))
    out.append(out[0][..., 1])
    return out


def _strip():
    f = _frames()
    return np.concatenate([f[0].astype(np.float32) / 255,
                           f[1].astype(np.float32) / 300], 1)


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _threads(monkeypatch, n):
    """Writers of ``n`` threads from here on in the test."""
    monkeypatch.setattr(visualizer, "writer_threads", lambda: n)


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("cpus,want", [(1, 1), (2, 1), (4, 3), (9, 8),
                                       (64, 8)])
def test_writer_threads_follow_the_affinity(monkeypatch, cpus, want):
    monkeypatch.setattr(os, "sched_getaffinity",
                        lambda pid: set(range(cpus)))
    assert visualizer.writer_threads() == want
    with ViewWriter("unused") as w:
        assert w.threads == want


def test_write_gif_is_its_frames_encoded_then_assembled(tmp_path):
    frames = _frames()
    path = str(tmp_path / "a.gif")
    shown = write_gif(path, frames)
    assert _sha(path) == GIF_SHA
    encoded = [gif_frame(f) for f in frames]
    with open(path, "rb") as f:
        assert f.read() == gif_bytes([(s, b) for s, b, _ in encoded])
    for a, (_, _, b) in zip(shown, encoded):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="differ in size"):
        gif_bytes([encoded[0][:2], gif_frame(frames[0][:5])[:2]])
    save_visuals([Visualizee("image", _strip(), "s")], str(tmp_path))
    assert _sha(tmp_path / "s.png") == PNG_SHA


def _strip_view(i, wait=0.0, order=None):
    """View ``i``'s visuals: an image strip (a GIF frame), a matrix and a
    second strip kind; sleeps ``wait`` s first."""
    time.sleep(wait)
    if order is not None:
        order.append(i)
    f = _frames()
    depth = np.linspace(0, 1, 21 * 34, dtype=np.float32).reshape(21, 34)
    return [Visualizee("image", np.roll(_strip(), 3 * i, 1),
                       name=f"{i}-fine"),
            Visualizee("image", f[i % 4], name=f"{i}-fine-ori"),
            Visualizee("matrix", depth * (i + 1), name=f"{i}-fine-depth",
                       range=(0, 2))]


def _serial(out_dir, views):
    """The serial writers on the same visuals: each view's save_visuals,
    then a GIF per strip kind."""
    frames = {}
    for vis in views:
        save_visuals(vis, out_dir)
        for v in vis:
            if v.kind == "image":
                frames.setdefault(v.name.split("-", 1)[1], []).append(
                    v.data)
    save_visuals([Visualizee("gif", f, name=k) for k, f in frames.items()],
                 out_dir)


@pytest.mark.parametrize("threads", [1, 2, 4])
def test_pool_writes_the_serial_writers_bytes(tmp_path, monkeypatch,
                                             threads):
    _threads(monkeypatch, threads)
    want, got = str(tmp_path / "serial"), str(tmp_path / "pool")
    _serial(want, [_strip_view(i) for i in range(6)])
    with ViewWriter(got, gif_name=engine._gif_name) as w:
        for i in range(6):
            w.submit(functools.partial(_strip_view, i))
        w.wait()
        assert w.write_gifs() == 6 * 3 + 2
    assert _files(got) == _files(want)


def test_gif_frames_keep_view_order_when_later_jobs_finish_first(
        tmp_path, monkeypatch):
    _threads(monkeypatch, 4)
    order = []
    want, got = str(tmp_path / "serial"), str(tmp_path / "pool")
    _serial(want, [_strip_view(i) for i in range(6)])
    with ViewWriter(got, gif_name=engine._gif_name) as w:
        for i in range(6):
            w.submit(functools.partial(_strip_view, i,
                                       wait=0.4 if i == 0 else 0.0,
                                       order=order))
        w.wait()
        w.write_gifs()
    assert order[-1] == 0           # the first view's job ended last
    assert _files(got) == _files(want)


def _broken_view():
    raise ValueError("boom")


def _slow_view(path, wait):
    time.sleep(wait)
    return [Visualizee("image", _frames()[3], name=path)]


@pytest.mark.parametrize("where", ["submit", "wait"])
def test_a_jobs_exception_reaches_the_caller(tmp_path, monkeypatch, where):
    _threads(monkeypatch, 2)
    out = str(tmp_path)
    with pytest.raises(ValueError, match="boom") as err:
        with ViewWriter(out) as w:
            w.submit(functools.partial(_slow_view, "slow", 0.3))
            w.submit(_broken_view)
            if where == "submit":
                deadline = time.monotonic() + TIMEOUT_S
                while time.monotonic() < deadline:
                    time.sleep(0.01)
                    w.submit(functools.partial(_slow_view, "late", 0.0))
                raise AssertionError("no submit raised the job's error")
            w.wait()
    assert any(e.name == "_broken_view" for e in err.traceback)
    # leaving the writer waited for the job that was running
    assert os.path.exists(os.path.join(out, "slow.png"))


def test_no_call_returns_before_its_files_are_on_disk(tmp_path,
                                                     monkeypatch):
    _threads(monkeypatch, 3)
    out = str(tmp_path)
    rng = np.random.RandomState(0)
    with ViewWriter(out) as w:
        for i in range(9):
            w.submit(functools.partial(_slow_view, f"v{i}",
                                       float(rng.rand()) * 0.05))
        w.wait()
        assert sorted(os.listdir(out)) == sorted(f"v{i}.png"
                                                 for i in range(9))


def test_at_most_two_views_a_thread_in_flight(tmp_path, monkeypatch):
    _threads(monkeypatch, 2)
    go = threading.Event()
    started = []

    def held(i):
        started.append(i)
        go.wait(TIMEOUT_S)
        return []

    with ViewWriter(str(tmp_path)) as w:
        for i in range(4):                 # 2k: the submits return
            w.submit(functools.partial(held, i))
        fifth = threading.Thread(target=w.submit,
                                 args=(functools.partial(held, 4),))
        fifth.start()
        fifth.join(0.3)
        assert fifth.is_alive()            # the fifth waits for a slot
        assert sorted(started) == [0, 1]   # two threads run, two queue
        go.set()
        fifth.join(TIMEOUT_S)
        assert not fifth.is_alive()
        w.wait()
        assert sorted(started) == [0, 1, 2, 3, 4]


def test_span_totals_exact_under_concurrent_closes(monkeypatch):
    """Threads close spans of one name at once (a barrier before each
    name); the totals' lookup yields the interpreter between finding no
    entry and making one, so an unlocked update would lose counts."""
    n_threads, n_names = 8, 60
    seconds = [[] for _ in range(n_threads)]
    barrier = threading.Barrier(n_threads, timeout=TIMEOUT_S)

    def get(self, key, default=None):
        found = dict.get(self, key, default)
        time.sleep(0)
        return found

    def work(k):
        for j in range(n_names):
            barrier.wait()
            with spans.span(f"nerfsr.s{j}") as outer:
                with spans.span("nerfsr.inner") as inner:
                    pass
            seconds[k].append((outer.seconds, inner.seconds))

    monkeypatch.setattr(spans.Totals, "get", get)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with spans.recording() as rec:
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(TIMEOUT_S)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    for j in range(n_names):
        got = rec[f"nerfsr.s{j}"]
        want = [seconds[k][j] for k in range(n_threads)]
        assert got["count"] == n_threads, j
        assert got["seconds"] == pytest.approx(sum(o for o, _ in want),
                                               rel=1e-9)
        assert got["self_s"] == pytest.approx(
            sum(o - i for o, i in want), rel=1e-9, abs=1e-12)
    inner = rec["nerfsr.inner"]
    assert inner["count"] == n_threads * n_names
    assert inner["seconds"] == pytest.approx(
        sum(i for per in seconds for _, i in per), rel=1e-9)


# ---------------------------------------------------------------------------
# the engine's loops
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A COLMAP scene of ``N_VIEWS`` smooth 32x24 images."""
    d = tmp_path_factory.mktemp("writers")
    h, w = HW
    poses, _ = center_poses(spiral_path(np.array([0.2, 0.2, 0.05]), 3.5,
                                        N_VIEWS))
    yy, xx = np.mgrid[0:h, 0:w] / 9.0
    imgs = np.stack([np.stack([np.sin(xx * (1 + c) + i) * np.cos(yy + c)
                               for c in range(3)], -1)
                     for i in range(N_VIEWS)])
    imgs = ((imgs * 0.5 + 0.5) * 255).astype(np.uint8)
    write_llff_scene(str(d / "scene"), poses, imgs, 30.0,
                     np.random.RandomState(0).randn(400, 3) * 0.5
                     + [0, 0, -4.0])
    return str(d / "scene")


def _options(scene, root, **extra):
    return default_options(
        "test", device="cpu", model="nerf_downX", dataset_mode="llff_downX",
        dataset_root=scene, img_wh=(HW[1], HW[0]), downscale=2,
        fast_preset="llff", precision="f32", D=2, W=32, name="writers",
        checkpoints_dir=os.path.join(root, "ck"), test_split="test_train",
        load_epoch=1, results_dir=os.path.join(root, "res"), **extra)


@pytest.fixture(scope="module")
def serial(scene, tmp_path_factory):
    """(options, the serial writers' directory): ``test``'s renders of a
    checkpoint written view by view with ``save_visuals``, then the
    GIFs."""
    root = str(tmp_path_factory.mktemp("serial"))
    opt = _options(scene, root)
    system = create_model(opt, device="cpu")
    state = system.create_state(seed=0, steps_per_epoch=1)
    ckpt.save_checkpoint(opt, state, 1)
    dataset = create_dataset(opt, "test_train")
    views = []
    for i, out in enumerate(system.render_eval_many(
            state.params, dataset, range(len(dataset)), quantize_rgb=True)):
        sample = dataset.image_rays(i)
        views.append(system.eval_visuals(
            out, sample, i, with_gt=sample.get("rgbs") is not None,
            depth_bounds=dataset.depth_bounds))
    out_dir = os.path.join(root, "serial")
    _serial(out_dir, views)
    return opt, out_dir


@pytest.mark.parametrize("threads", [1, 2, 4])
def test_pooled_test_writes_the_serial_bytes(serial, monkeypatch, threads):
    opt, want = serial
    _threads(monkeypatch, threads)
    got = engine.test(opt)
    files = _files(got)
    assert files == _files(want)
    assert {"fine.gif", "fine-ori.gif", f"{N_VIEWS - 1}-fine-ori.png",
            f"{N_VIEWS - 1}-fine-depth-ori.npz"} <= set(files)
    os.rename(got, f"{got}-{threads}")


def test_pooled_validate_writes_the_serial_bytes(serial, tmp_path):
    opt, want = serial
    system = create_model(opt, device="cpu")
    state = system.create_state(seed=0, steps_per_epoch=1)
    ckpt.load_checkpoint(opt, state, epoch=1, params_only=True)
    got = str(tmp_path / "val")
    metrics = engine.validate(opt, system, state.params,
                              create_dataset(opt, "test_train"),
                              out_dir=got)
    assert metrics
    assert _files(got) == _files(want)


def test_test_timings_keep_their_keys_and_add_wait_s(serial, tmp_path):
    opt = copy.copy(serial[0])
    opt.results_dir = str(tmp_path / "res")
    timings = {}
    engine.test(opt, timings=timings)
    assert set(timings) == {"call_s", "setup_s", "data_s", "seconds",
                            "write_s", "wait_s", "encode_s", "views"}
    t = timings
    assert t["views"] == N_VIEWS
    assert 0 < t["write_s"] <= t["seconds"]
    assert 0 <= t["wait_s"] <= t["seconds"]
    assert t["encode_s"] > 0
    assert t["call_s"] >= t["setup_s"] + t["seconds"]
