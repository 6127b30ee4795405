"""``test_writer_wait_share_pct.test`` on made-up ``timings``: the loop's
waits for the writer threads over the calls' seconds, and nothing where
a call's ``timings`` lack ``wait_s`` (a system without writer threads)
or the context is not a test's."""

import pytest

from nerfbench import spec


def test_writer_wait_share():
    m = spec.metric("test_writer_wait_share_pct.test")
    calls = [{"call_s": 10.0, "seconds": 7.0, "write_s": 2.0,
              "wait_s": 1.0, "encode_s": 12.0, "views": 20},
             {"call_s": 30.0, "seconds": 25.0, "write_s": 4.0,
              "wait_s": 3.0, "encode_s": 30.0, "views": 20}]
    assert m.read({"kind": "test", "spans": calls}) == pytest.approx(10.0)
    assert (m.LAYER, m.MOVES, m.UNIT, m.BETTER) == (
        "writers", "test_image_ms", "%", "lower")
    parent = [{k: v for k, v in c.items() if k != "wait_s"} for c in calls]
    assert m.read({"kind": "test", "spans": parent}) is None
    assert m.read({"kind": "test", "spans": [calls[0], parent[1]]}) is None
    assert m.read({"kind": "train", "spans": calls}) is None
    assert m.read({"kind": "test", "spans": []}) is None
    assert m.read({"kind": "test"}) is None
