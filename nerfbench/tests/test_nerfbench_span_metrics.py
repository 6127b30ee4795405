"""The per-layer metrics read from the system's spans, on a made-up
context and made-up span totals: each reads its spans over the traced
units or its keys over the calls, and gives None where a span, a key or
the context it needs is missing (as against a system without spans)."""

import types

import pytest

from nerfbench import spec
from nerfsr_torch import spans


def _metric(name):
    return spec.metric(name)


def _totals(monkeypatch, got):
    monkeypatch.setattr(spans, "totals", lambda: spans.Totals(
        {k: {"count": 1, "seconds": v, "self_s": v, "parent": None}
         for k, v in got.items()}))


def _trace(units):
    return types.SimpleNamespace(units=units)


def test_dispatch_host_ms(monkeypatch):
    m = _metric("dispatch_host_ms.train")
    ctx = {"kind": "train", "trace": _trace(100)}
    _totals(monkeypatch, {"nerfsr.train.chunk": 0.005,
                          "nerfsr.graph.replay": 0.004})
    assert m.read(ctx) == pytest.approx(0.05)
    for bad in ({"kind": "render", "trace": _trace(100)},
                {"kind": "train"}, {"kind": "train", "trace": _trace(0)}):
        assert m.read(bad) is None
    _totals(monkeypatch, {"nerfsr.graph.replay": 0.004})
    assert m.read(ctx) is None


def test_eval_host_ms(monkeypatch):
    m = _metric("eval_host_ms.render")
    ctx = {"kind": "render", "trace": _trace(10)}
    got = {"nerfsr.eval.enqueue": 0.02, "nerfsr.eval.wait": 0.4,
           "nerfsr.eval.readback": 0.01, "nerfsr.eval.postprocess": 0.1}
    _totals(monkeypatch, got)
    assert m.read(ctx) == pytest.approx(13.0)     # the wait left out
    assert m.read({"kind": "train", "trace": _trace(10)}) is None
    for name in ("nerfsr.eval.enqueue", "nerfsr.eval.readback",
                 "nerfsr.eval.postprocess"):
        _totals(monkeypatch, {k: v for k, v in got.items() if k != name})
        assert m.read(ctx) is None, name


CALLS = [{"call_s": 10.0, "setup_s": 3.0, "data_s": 1.0, "encode_s": 4.0,
          "seconds": 7.0, "write_s": 5.0, "views": 20},
         {"call_s": 30.0, "setup_s": 5.0, "data_s": 3.0, "encode_s": 8.0,
          "seconds": 25.0, "write_s": 15.0, "views": 20}]


@pytest.mark.parametrize("name,want", [
    ("test_setup_share_pct.test", 20.0),
    ("test_data_share_pct.test", 10.0),
    ("test_encode_share_pct.test", 30.0)])
def test_test_shares(name, want):
    m = _metric(name)
    assert m.read({"kind": "test", "spans": CALLS}) == pytest.approx(want)
    assert m.read({"kind": "train", "spans": CALLS}) is None
    assert m.read({"kind": "test", "spans": []}) is None
    assert m.read({"kind": "test"}) is None
    # the parent's timings: the loop's seconds and writes alone
    old = [{"seconds": 7.0, "write_s": 5.0, "views": 20}]
    assert m.read({"kind": "test", "spans": old}) is None
    part = [dict(CALLS[0]), {k: v for k, v in CALLS[1].items()
                             if k != m.KEY}]
    assert m.read({"kind": "test", "spans": part}) is None
