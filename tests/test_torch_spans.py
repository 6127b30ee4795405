"""The port's spans (``nerfsr_torch/spans.py``) on the CPU: off they
cost a flag check and nothing else; nested they give each span's self
seconds and parent; under ``torch.profiler`` they are the profiler's
user annotations; ``engine.test(timings=)`` and ``engine.train(timings=)``
report through them; ``render_eval_many`` spans each view's enqueue,
wait, copy back and postprocess once, and no span is open while it
yields."""

import time

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in a test worker)
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

from nerfsr_torch import engine, spans
from nerfsr_torch.config import default_options
from nerfsr_torch.data import create_dataset
from nerfsr_torch.data.llff import center_poses, spiral_path
from nerfsr_torch.data.synthetic import write_llff_scene
from nerfsr_torch.models import create_model
from nerfsr_torch.utils import checkpoint as ckpt

HW = (24, 32)
N_VIEWS = 3
EVAL_SPANS = ("nerfsr.eval.enqueue", "nerfsr.eval.wait",
              "nerfsr.eval.readback", "nerfsr.eval.postprocess")


def _fake_clock(monkeypatch):
    """``time.perf_counter`` reading 0, 1, 2, ... s, one step a read."""
    ticks = iter(range(1000))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))


def test_off_reads_no_clock_and_enters_no_record_function(monkeypatch):
    def refuse(*_):
        raise AssertionError("a span that is off did work")

    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    monkeypatch.setattr(time, "perf_counter", refuse)
    before = spans.totals()
    assert spans.span("nerfsr.a") is spans.span("nerfsr.b")

    @spans.spanned("nerfsr.c")
    def inner(x):
        return x + 1

    with spans.span("nerfsr.a"):
        with spans.span("nerfsr.b"):
            assert inner(1) == 2
    with spans.recording(False) as rec:
        with spans.span("nerfsr.a"):
            pass
    assert rec == {} and spans.totals() == before


def test_nested_spans_give_self_seconds_and_parent(monkeypatch):
    _fake_clock(monkeypatch)
    with spans.recording() as outer_rec:
        with spans.span("nerfsr.outer"):              # 0 .. 5
            for _ in range(2):
                with spans.span("nerfsr.inner"):      # 1 .. 2, 3 .. 4
                    pass
        with spans.recording() as inner_rec:
            with spans.timed("nerfsr.alone") as t:    # 6 .. 7
                pass
    assert t.seconds == 1.0
    assert outer_rec == {
        "nerfsr.outer": {"count": 1, "seconds": 5.0, "self_s": 3.0,
                         "parent": None},
        "nerfsr.inner": {"count": 2, "seconds": 2.0, "self_s": 2.0,
                         "parent": "nerfsr.outer"},
        "nerfsr.alone": {"count": 1, "seconds": 1.0, "self_s": 1.0,
                         "parent": None}}
    assert inner_rec == {"nerfsr.alone": outer_rec["nerfsr.alone"]}
    assert outer_rec.seconds("nerfsr.inner") == 2.0
    assert outer_rec.seconds("nerfsr.missing") == 0.0


def test_timed_reads_the_clock_with_nothing_recording():
    before = spans.totals()
    with spans.timed("nerfsr.alone") as t:
        time.sleep(0.01)
    assert t.seconds >= 0.01
    assert spans.totals() == before


def test_spans_are_the_profilers_user_annotations():
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("enclosing"):
            with spans.span("nerfsr.a"):
                for _ in range(2):
                    with spans.span("nerfsr.b"):
                        torch.ones(4).add_(1)
    events = {}
    for e in prof.events():
        events.setdefault(e.name, []).append(e)
    assert len(events["nerfsr.a"]) == 1 and len(events["nerfsr.b"]) == 2
    for e in events["nerfsr.a"] + events["nerfsr.b"]:
        assert e.is_user_annotation
    assert events["nerfsr.a"][0].cpu_parent.name == "enclosing"
    assert all(e.cpu_parent.name == "nerfsr.a" for e in events["nerfsr.b"])
    got = spans.totals()
    assert got["nerfsr.a"]["count"] == 1 and got["nerfsr.a"]["parent"] is None
    assert got["nerfsr.b"]["count"] == 2
    assert got["nerfsr.b"]["parent"] == "nerfsr.a"
    assert 0 < got["nerfsr.b"]["seconds"] <= got["nerfsr.a"]["seconds"]
    # off again once the profiler stops
    assert spans.span("nerfsr.a") is spans.span("nerfsr.b")
    spans.reset()
    assert spans.totals() == {}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A COLMAP scene of ``N_VIEWS`` smooth 32x24 images."""
    d = tmp_path_factory.mktemp("spans")
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


def _options(phase, scene, tmp_path, **extra):
    return default_options(
        phase, device="cpu", model="nerf_downX", dataset_mode="llff_downX",
        dataset_root=scene, img_wh=(HW[1], HW[0]), downscale=2,
        fast_preset="llff", precision="f32", D=2, W=32, name="spans",
        checkpoints_dir=str(tmp_path / "ck"), **extra)


def test_engine_test_timings_come_from_its_spans(scene, tmp_path):
    opt = _options("test", scene, tmp_path, test_split="test_train",
                   results_dir=str(tmp_path / "res"), load_epoch=1)
    system = create_model(opt, device="cpu")
    ckpt.save_checkpoint(opt, system.create_state(seed=0,
                                                  steps_per_epoch=1), 1)
    before = spans.totals()
    timings = {}
    out_dir = engine.test(opt, timings=timings)
    assert set(timings) == {"call_s", "setup_s", "data_s", "seconds",
                            "write_s", "wait_s", "encode_s", "views"}
    assert timings["views"] == N_VIEWS
    for i in range(N_VIEWS):
        assert (tmp_path / "res" / "spans" / "test_train_1"
                / f"{i}-fine-ori.png").exists()
    t = timings
    assert 0 < t["write_s"] <= t["seconds"]
    assert t["call_s"] >= t["setup_s"] + t["seconds"]
    assert 0 <= t["wait_s"] <= t["seconds"]
    assert t["encode_s"] > 0            # on the writer threads
    assert 0 < t["data_s"] <= t["setup_s"]
    assert spans.totals() == before     # no profiler: nothing process-wide
    assert engine.test(opt) == out_dir


def test_engine_train_epoch_seconds_and_chunks(scene, tmp_path):
    opt = _options("train", scene, tmp_path, batch_size=16, n_epochs=2,
                   steps_per_epoch=2, scan_steps=2,
                   summary_dir=str(tmp_path / "runs"))
    timings = {}
    with spans.recording() as rec:
        engine.train(opt, timings=timings)
    assert timings["steps_per_epoch"] == 2
    assert sorted(timings["epoch_s"]) == [1, 2]
    assert sum(timings["epoch_s"].values()) == pytest.approx(
        rec.seconds("nerfsr.train.epoch"))
    assert rec["nerfsr.train.epoch"]["count"] == 2
    chunk = rec["nerfsr.train.chunk"]
    assert chunk["count"] == 2 and chunk["parent"] == "nerfsr.train.epoch"


def test_render_eval_many_spans_each_view_once(scene, tmp_path):
    opt = _options("test", scene, tmp_path, test_split="test_train")
    system = create_model(opt, device="cpu")
    params = system.init_params(seed=0)
    dataset = create_dataset(opt, "test_train")
    single = [system.render_eval(params, dataset, i)
              for i in range(N_VIEWS)]
    with spans.recording() as rec:
        many = []
        for out in system.render_eval_many(params, dataset,
                                           range(N_VIEWS)):
            with spans.span("nerfsr.consumer"):
                many.append(out)
    assert len(many) == N_VIEWS
    for a, b in zip(single, many):
        assert set(a) == set(b)
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    for name in EVAL_SPANS:
        assert rec[name]["count"] == N_VIEWS, name
        assert rec[name]["parent"] is None, name
    # the consumer's time is its own: no eval span is open at a yield
    assert rec["nerfsr.consumer"]["parent"] is None


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0.0, 2.0), (1.0, 3.0)], 3.0),               # overlap counted once
    ([(5.0, 6.0), (0.0, 1.0), (5.5, 5.7)], 2.0),   # nested, unsorted
    ([(0.0, 1.0), (1.0, 2.0)], 2.0)])              # touching
def test_profile_slice_busy_time_is_a_union(intervals, want):
    from nerfsr_torch.profile_slice import busy_us
    assert busy_us(intervals) == want
