"""The trace's reduction (the union of busy intervals, the idle gaps and
their host labels), the benchmark's PNG reader and its frozen Lanczos."""

import io

import numpy as np
import pytest

from nerfbench import png, trace
from nerfbench.reference.lanczos import lanczos_downscale


def test_union_counts_an_overlap_once():
    iv = [("a", 0, 10), ("b", 5, 15), ("c", 20, 30), ("d", 22, 25)]
    assert trace.union_us(iv, 0, 40) == 25
    assert trace.union_us(iv, 8, 22) == 9
    assert trace.gaps(iv, 0, 40) == [(15, 20), (30, 40)]


def test_gaps_labelled_by_the_innermost_host_op():
    dev = [("k", 0, 10), ("k", 20, 30)]
    host = [("outer", 0, 40), ("inner", 12, 18)]
    tr = trace.Trace(dev, host, (0, 40), units=2)
    assert tr.busy_s == pytest.approx(20e-6)
    assert tr.window_s == pytest.approx(40e-6)
    assert tr.idle == {"inner": 10, "outer": 10}
    assert tr.idle_pct() == pytest.approx(50.0)
    assert tr.device_s(["k"]) == pytest.approx(20e-6)
    assert tr.device_s(["nothing"]) is None
    b = tr.breakdown()
    assert b["device_ops"] == [["k", pytest.approx(20e-6)]]
    assert len(b["idle_gaps"]) == 2


@pytest.mark.parametrize("optimize", [False, True])
def test_png_reader_gives_pil_s_pixels(optimize):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(0)
    img = np.cumsum(rng.integers(0, 9, (37, 53, 3)), 1).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG", optimize=optimize)
    assert np.array_equal(png.decode(buf.getvalue()), img)


def test_png_reader_reads_the_systems_writer(tmp_path):
    from nerfsr_torch.utils import png as port_png
    img = np.random.default_rng(1).integers(0, 256, (20, 30, 3), np.uint8)
    port_png.write(str(tmp_path / "a.png"), img)
    assert np.array_equal(png.decode((tmp_path / "a.png").read_bytes()),
                          img)


def test_lanczos_gives_pil_s_bytes():
    Image = pytest.importorskip("PIL.Image")
    img = np.random.default_rng(2).integers(0, 256, (38, 50, 3), np.uint8)
    want = np.asarray(Image.fromarray(img).resize((25, 19), Image.LANCZOS))
    assert np.array_equal(lanczos_downscale(img, 2), want)


def test_tail_over_every_image():
    from nerfbench.drivers.render import tail_ms
    arrivals = [0.1 * (i + 1) for i in range(40)]
    arrivals[12:] = [a + 0.6 for a in arrivals[12:]]  # image 12 late by 0.6 s
    assert tail_ms(0.0, arrivals, q=100) == pytest.approx(700.0)
    assert tail_ms(0.0, arrivals) == pytest.approx(100.0)
    arrivals[30:] = [a + 0.6 for a in arrivals[30:]]  # and image 30
    # two late images in 40 lie above the 95th percentile's rank
    assert tail_ms(0.0, arrivals) > 100.0
