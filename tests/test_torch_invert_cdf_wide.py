"""Kernel A's wide routes (more than 128 bins a ray, ``csrc/invert_cdf.cu``)
modelled in numpy, in the order the card sums and searches, against the
JAX package's ``_invert_cdf`` and the port's plain version on the CPU.

The model takes the kernels' geometry as parameters: WPR warps a ray (T =
32 WPR threads) and, on the streamed route, the chunk of CDF entries it
keeps. The tests read the card's cut-overs, sub-chunk and chunk from the
source, so the model follows the launcher. Every f32 operation is the
kernels': the total (each thread's entries t, t + T, ... in order, a
shuffle-xor tree, the warp totals in warp order), pdf = (w + eps) /
total, each warp's segment scanned 128 entries at a time (a lane's four
consecutive entries summed serially, the lane sums Hillis-Steele scanned
by shuffles, a carry from sub-chunk to sub-chunk), the segments'
offsets, the branch-free search, the clamp, the eps rule and the lerp
(nvcc contracts bb + t (ba - bb) into one fused multiply-add).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in a test worker)

from nerfsr_tpu.core.sampling import _invert_cdf as j_invert_cdf

from nerfsr_torch.core.rendering import compute_weights as plain_weights
from nerfsr_torch.core.sampling import _invert_cdf as plain_invert_cdf

F32 = np.float32
EPS = F32(1e-5)
# the card's bar for kernel A (tests/test_torch_gpu.py, chip_smoke.py)
Z_ATOL = 1e-4
SOURCE = (Path(__file__).resolve().parent.parent / "nerfsr_torch" / "csrc"
          / "invert_cdf.cu").read_text()


def _cu_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


SUB = _cu_const("kSub")      # CDF entries a warp scans at a time


def _card_wpr(b):
    """Warps a ray the launcher gives the shared route at b bins (None:
    past it, the streamed route)."""
    for limit, wpr in (("kOneWarpBins", 1), ("kEightWarpBins", 8)):
        if b <= _cu_const(limit):
            return wpr
    return None


def _fma(a, b, c):
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(F32)


def _t(x):
    return torch.from_numpy(np.asarray(x, F32).copy())


def _warp_scan(x):
    """Inclusive shuffle-up scan over the last axis (32 lanes)."""
    lane = np.arange(32)
    for d in (1, 2, 4, 8, 16):
        x = np.where(lane >= d, x + x[..., np.maximum(lane - d, 0)], x)
    return x


def _total(v, wpr):
    """load_row and ray_total: v (n, nw) = w + eps -> the total (n,)."""
    n, nw = v.shape
    t = 32 * wpr
    vp = np.zeros((n, -(-nw // t) * t), F32)
    vp[:, :nw] = v
    acc = np.zeros((n, t), F32)
    for j in range(vp.shape[1] // t):
        acc = acc + vp[:, j * t:(j + 1) * t]
    acc = acc.reshape(n, wpr, 32)
    lane = np.arange(32)
    for m in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lane ^ m]
    assert (acc == acc[..., :1]).all()      # every lane has the same bits
    if wpr == 1:
        return acc[:, 0, 0]
    total = np.zeros(n, F32)
    for k in range(wpr):
        total = total + acc[:, k, 0]
    return total


def _scan_chunk(v, total, before, wpr):
    """scan_chunk: the CDF entries of v (n, m) = w + eps of a chunk, the
    entry before it `before` (n,). Warp w scans its segment SUB entries
    at a time (lane l: entries 4l .. 4l + 3 summed serially, the lane sums
    scanned, a carry from sub-chunk to sub-chunk); its offset is `before`
    plus the earlier segments' last local entries, in order."""
    n, m = v.shape
    seg = -(-m // (wpr * SUB)) * SUB
    local = np.zeros((n, m), F32)
    lasts = []
    for warp in range(wpr):
        s0 = min(warp * seg, m)
        s1 = min(s0 + seg, m)
        carry = np.zeros(n, F32)
        for c in range(s0, s1, SUB):
            idx = (c + np.arange(SUB)).reshape(32, 4)
            ok = idx < s1
            x = np.where(ok, v[:, np.minimum(idx, m - 1)] / total[:, None,
                                                                  None],
                         F32(0))
            p = x.copy()
            for j in (1, 2, 3):
                p[..., j] = p[..., j - 1] + x[..., j]
            incl = _warp_scan(p[..., 3])
            excl = np.concatenate([np.zeros((n, 1), F32), incl[:, :-1]], -1)
            o = (carry[:, None] + excl)[..., None] + p
            local[:, idx[ok]] = o[:, ok]
            carry = o[:, 31, 3]
        lasts.append(carry)
    cdf = np.zeros((n, m), F32)
    off = before.astype(F32)
    for warp in range(wpr):
        s0 = min(warp * seg, m)
        s1 = min(s0 + seg, m)
        cdf[:, s0:s1] = off[:, None] + local[:, s0:s1]
        off = off + lasts[warp]
    return cdf


def _search(cdf, u):
    """upper_bound: a fixed ceil(log2 len) halvings by selects."""
    base = np.zeros(u.shape, np.int64)
    m = cdf.shape[-1]
    while m > 1:
        half = m >> 1
        cand = np.take_along_axis(cdf, base + half, -1)
        base = np.where(cand <= u, base + half, base)
        m -= half
    return base + (np.take_along_axis(cdf, base, -1) <= u)


def _lerp(u, cb, ca, bb, ba):
    denom = ca - cb
    denom = np.where(denom < EPS, F32(1), denom)
    return _fma((u - cb) / denom, ba - bb, bb)


def shared_route(bins, w, u, wpr):
    """The shared route: the whole CDF, then every query searched in it.
    Returns (z, cdf)."""
    n, nb = bins.shape
    v = w + EPS
    total = _total(v, wpr)
    cdf = np.zeros((n, nb), F32)
    cdf[:, 1:] = _scan_chunk(v, total, np.zeros(n, F32), wpr)
    cnt = _search(cdf, u)
    below, above = np.maximum(cnt - 1, 0), np.minimum(cnt, nb - 1)
    take = np.take_along_axis
    return _lerp(u, take(cdf, below, -1), take(cdf, above, -1),
                 take(bins, below, -1), take(bins, above, -1)), cdf


def streamed_route(bins, w, u, wpr, chunk):
    """The streamed route: the CDF a chunk at a time (the entry before it
    at index 0), each query finished in the chunk whose [first, last)
    holds its u, the rest clamped at the end. Returns (z, cdf, the
    number of places each query was finished)."""
    assert chunk % SUB == 0
    n, nb = bins.shape
    nw = nb - 1
    v = w + EPS
    total = _total(v, wpr)
    cdf = np.zeros((n, nb), F32)
    z = np.full(u.shape, np.nan, F32)
    done = np.zeros(u.shape, np.int64)
    carry = np.zeros(n, F32)
    take = np.take_along_axis
    for c0 in range(0, nw, chunk):
        m = min(chunk, nw - c0)
        buf = np.zeros((n, m + 1), F32)
        buf[:, 0] = carry
        buf[:, 1:] = _scan_chunk(v[:, c0:c0 + m], total, carry, wpr)
        cdf[:, c0 + 1:c0 + m + 1] = buf[:, 1:]
        lo, hi = buf[:, :1], buf[:, m:]
        carry = hi[:, 0]
        hit = (lo <= u) & (u < hi)
        cnt = np.clip(_search(buf, u), 1, m)
        zc = _lerp(u, take(buf, cnt - 1, -1), take(buf, cnt, -1),
                   take(bins, c0 + cnt - 1, -1), take(bins, c0 + cnt, -1))
        z = np.where(hit, zc, z)
        done += hit
    last = carry[:, None]
    top = u >= last
    bottom = ~top & ~(u >= 0)
    z = np.where(top, _lerp(u, last, last, bins[:, -1:], bins[:, -1:]), z)
    z = np.where(bottom, _lerp(u, F32(0), F32(0), bins[:, :1], bins[:, :1]),
                 z)
    return z, cdf, done + top + bottom


def searchsorted_lerp(bins, cdf, u):
    """The function's tail on a given CDF: searchsorted-right, clamps, eps
    rule, lerp (the kernels' order)."""
    nb = bins.shape[1]
    cnt = np.stack([np.searchsorted(c, x, side="right")
                    for c, x in zip(cdf, u)])
    below, above = np.maximum(cnt - 1, 0), np.minimum(cnt, nb - 1)
    take = np.take_along_axis
    return _lerp(u, take(cdf, below, -1), take(cdf, above, -1),
                 take(bins, below, -1), take(bins, above, -1))


def hist(n, b, seed):
    """Sorted bins, uniform weights with a degenerate (all-0) row and a
    row of concentrated mass."""
    rng = np.random.RandomState(seed)
    z = np.sort(rng.rand(n, b + 1).astype(F32), -1)
    bins = 0.5 * (z[:, :-1] + z[:, 1:])
    w = rng.rand(n, b - 1).astype(F32)
    w[0] = 0.0
    w[1, :2] = 100.0
    return bins, w


def stratified(n, q, seed):
    return ((np.arange(q) + np.random.RandomState(seed).rand(n, q)) / q
            ).astype(F32)


def references(bins, w, u):
    ref_jax = np.asarray(j_invert_cdf(jnp.asarray(bins), jnp.asarray(w),
                                      jnp.asarray(u)))
    ref_plain = plain_invert_cdf(_t(bins), _t(w), _t(u)).numpy()
    return ref_jax, ref_plain


def assert_near_refs(got, bins, w, u):
    for ref in references(bins, w, u):
        np.testing.assert_allclose(got, ref, rtol=0, atol=Z_ATOL)


def eps_rule_moved(got, bins, w, u):
    """The queries past Z_ATOL from either reference, checked to be what
    the `denom < eps -> 1` rule moves (the card's rule, tests/
    test_torch_gpu.py): each in a bin, or beside one, whose CDF step (the
    plain version's) is under 2 eps, by at most those bins' width. Returns
    the rows they lie in."""
    pdf = (w + EPS) / (w + EPS).sum(-1, keepdims=True, dtype=F32)
    cdf = np.concatenate([np.zeros_like(pdf[:, :1]), np.cumsum(pdf, -1)], -1)
    rows = set()
    for ref in references(bins, w, u):
        diff = np.abs(got - ref)
        r, c = np.nonzero(diff > Z_ATOL)
        if not len(r):
            continue
        k = np.stack([np.searchsorted(cdf[i], u[i, j], side="right")
                      for i, j in zip(r, c)]).reshape(-1, 1)
        near = np.clip(k - 1 + np.arange(-1, 2), 0, bins.shape[1] - 2)
        step = np.take_along_axis(cdf[r], near + 1, 1) - np.take_along_axis(
            cdf[r], near, 1)
        width = np.take_along_axis(bins[r], near + 1, 1) - np.take_along_axis(
            bins[r], near, 1)
        assert (step.min(-1) < 2 * EPS).all()
        assert (diff[r, c] <= width.max(-1) + Z_ATOL).all()
        rows.update(r.tolist())
    return rows


SHAPES = [(b, q) for b in (129, 191, 255, 1024, 4097) for q in (16, 37)] + [
    (255, 192)]      # --n_prop 256 --n_prop2 192: 255 bins to 192 queries


@pytest.mark.parametrize("b,q", SHAPES)
def test_shared_route_order_vs_jax_and_plain(b, q):
    """The shared route at the warps a ray the launcher gives b bins, on
    stratified u, against the JAX package's _invert_cdf and the port's
    plain version at the card's bar; its search gives exactly
    searchsorted-right on its own CDF."""
    n = 64 if b < 4097 else 16
    bins, w = hist(n, b, seed=b + q)
    u = stratified(n, q, seed=q)
    got, cdf = shared_route(bins, w, u, _card_wpr(b))
    assert_near_refs(got, bins, w, u)
    np.testing.assert_array_equal(got, searchsorted_lerp(bins, cdf, u))


@pytest.mark.parametrize("wpr", [1, 8])
def test_shared_route_every_geometry(wpr):
    """Every warps-a-ray instantiation at 1024 bins (whatever the
    launcher picks) on unsorted u in [0, 1), 0 and 1 included."""
    bins, w = hist(32, 1024, seed=wpr)
    u = np.random.RandomState(wpr).rand(32, 37).astype(F32)
    u[:, 0], u[:, 1] = 0.0, 1.0
    got, cdf = shared_route(bins, w, u, wpr)
    assert_near_refs(got, bins, w, u)
    np.testing.assert_array_equal(got, searchsorted_lerp(bins, cdf, u))


def _streamed_rows(case):
    """1000 bins, a chunk of SUB = 128 entries (the least the kernel
    takes; 8 chunks) at one warp a ray: a query on
    each chunk's edge, u = 0, u at and above the last CDF entry, unsorted
    u, an all-zero row and two rows of concentrated mass (the second's
    other bins' steps under eps)."""
    n, b, q = 6, 1000, 37
    bins, w = hist(n, b, seed=11)
    w[2, 500:503] = 1e4                            # mass in the middle
    u = np.random.RandomState(12).rand(n, q).astype(F32)
    if case == "sorted":
        u = np.sort(u, -1)
    _, cdf, _ = streamed_route(bins, w, u, 1, SUB)
    if case == "chunk_edge":
        edges = cdf[:, SUB:1000:SUB]               # each chunk's last entry
        u[:, :edges.shape[1]] = edges
        u[:, 10:10 + edges.shape[1]] = np.nextafter(edges, F32(0))
    elif case == "ends":
        u[:, 0] = 0.0
        u[:, 1] = cdf[:, -1]
        u[:, 2] = np.nextafter(cdf[:, -1], F32(0))
        u[:, 3] = 1.5
        u[:, 4] = -0.25
        u[:, 5] = 1.0
    return bins, w, u


@pytest.mark.parametrize("case", ["unsorted", "sorted", "chunk_edge",
                                  "ends"])
def test_streamed_route_small_chunk(case):
    """The streamed route's chunk logic at a chunk of 128 entries over
    1000 bins: every query finished in exactly one place, the result
    exactly searchsorted-right on the same CDF, and within the card's bar
    of the JAX function and the plain version but where the eps rule
    moves a query."""
    bins, w, u = _streamed_rows(case)
    got, cdf, done = streamed_route(bins, w, u, 1, SUB)
    assert (done == 1).all()
    np.testing.assert_array_equal(got, searchsorted_lerp(bins, cdf, u))
    # only row 2 has bins whose CDF step is under eps (1e4 of mass in
    # three bins): there a query on a chunk's edge may flip the eps rule
    assert eps_rule_moved(got, bins, w, u) <= {2}
    below = u < 0                 # the zero prefix's clamp: bins[0]
    np.testing.assert_array_equal(got[below], np.broadcast_to(
        bins[:, :1], u.shape)[below])


@pytest.mark.parametrize("b", [9000, 70000])
def test_streamed_route_card_geometry(b):
    """The streamed route at the card's warps and chunk (the kernel's
    kStreamWarps, kChunk) past one chunk, on stratified u and the ends,
    against the references at the card's bar."""
    wpr, chunk = _cu_const("kStreamWarps"), _cu_const("kChunk")
    bins, w = hist(4, b, seed=b)
    u = stratified(4, 24, seed=b)
    u[:, 0], u[:, -1] = 0.0, 1.0
    got, cdf, done = streamed_route(bins, w, u, wpr, chunk)
    assert (done == 1).all()
    assert_near_refs(got, bins, w, u)
    np.testing.assert_array_equal(got, searchsorted_lerp(bins, cdf, u))


def test_wide_order_pad0_empty_bins():
    """255 bins as the annealed path makes them (pad 0, proposal weights
    with many empty bins, totals near 1), under the rule of
    test_torch_kernels.py's test_warp_invert_cdf_order_pad0_empty_bins:
    an empty bin's pdf is eps / total, within f32 rounding of the `denom <
    eps -> 1` threshold, so another summation order can flip the rule and
    move a query inside its bin by up to the bin's width. Every such
    query lies in an empty bin and moves by at most its width, and there
    are no more of them than twice the references' own count."""
    rng = np.random.RandomState(17)
    n, s, q = 512, 256, 24
    z = np.sort(rng.rand(n, s).astype(F32), -1)
    sigma = (rng.randn(n, s) * 30 - 15).astype(F32)
    w = plain_weights(_t(sigma), _t(z)).numpy()
    bins = 0.5 * (z[:, :-1] + z[:, 1:])
    w = w[:, 1:-1]                                       # pad 0
    u = ((np.arange(q) + 0.5) / q * np.ones((n, 1))).astype(F32)
    got, cdf = shared_route(bins, w, u, _card_wpr(s - 1))
    ref_jax, ref = references(bins, w, u)
    assert (w == 0).mean() > 0.3                          # many empty bins
    refs_moved = int((np.abs(ref - ref_jax) > Z_ATOL).sum())
    for other in (ref, ref_jax):
        moved = np.abs(got - other) > Z_ATOL
        assert moved.sum() <= 2 * max(refs_moved, 1), (moved.sum(),
                                                         refs_moved)
        rows, cols = np.nonzero(moved)
        k = (cdf[rows] <= u[rows, cols, None]).sum(-1)   # above index
        below, above = np.maximum(k - 1, 0), np.minimum(k, s - 2)
        assert (w[rows, np.minimum(below, s - 3)] == 0).all()
        width = bins[rows, above] - bins[rows, below]
        assert (np.abs(got - other)[moved] <= width + Z_ATOL).all()


def test_model_reads_the_cards_constants():
    """The cut-overs and chunk the model takes from the source are there
    and consistent: a warp a ray, then 8, then streaming, and a chunk of
    whole sub-chunks (a warp's 32 lanes, four entries each)."""
    assert 128 < _cu_const("kOneWarpBins") < _cu_const("kEightWarpBins")
    assert _cu_const("kStreamWarps") == 8
    assert _cu_const("kChunk") % SUB == 0 and SUB == 4 * 32
    assert [_card_wpr(b) for b in (129, 1024, 2048, 4097, 30000)] == [
        1, 1, 8, 8, None]
