"""Kernel F's wrapper (``nerfsr_torch/kernels/posenc.py``) on the CPU.

The kernel runs only on the card (``tests/test_torch_gpu.py`` holds it
to the chain bit for bit there). Here: which tensors take the kernel and
which the chain, that the chain's output is the plain version's, a
Python mirror of the kernel's output-index map (its tiles and its
thread-to-element walk, ``csrc/posenc.cu``) held against the plain
version, the library's tables, and the call sites' ``repeat``.
"""

import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in a test worker)

from nerfsr_torch.core import encoding
from nerfsr_torch.kernels import COUNTS, LAUNCHES_PER_CALL, _lib, reset_counts
from nerfsr_torch.kernels import mlp as kmlp
from nerfsr_torch.kernels import posenc as kposenc

# (C, F, identity, log scale): the fine points (deg_pos 10), the
# directions (deg_dir 4), the proposal rounds (deg_prop 6), --no_xyz,
# --no_logscale and no frequencies (--deg_dir 0: the identity alone)
CONFIGS = [(3, 10, True, True), (3, 4, True, True), (3, 6, True, True),
           (3, 10, False, True), (3, 4, True, False), (3, 0, True, True)]
CONFIG_IDS = ["pos", "dir", "prop", "no_identity", "linear",
              "identity_only"]


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_sin():
    """torch's CPU ``sin``, in the first call of a process that splits its
    tensor over the thread pool, has been seen to return the second
    thread's share off by up to 1.5e-4 (1 process in 50-60 under pytest
    with 8 threads; every later call agrees with f64 to 3.5e-8). The bit
    for bit comparisons here hold the wrapper's route to the chain, not
    torch's first call, so each thread's share is computed once first.
    The cause is open (PERF.md, section 7 (p))."""
    torch.sin(torch.zeros(torch.get_num_threads() * 4096))


def _points(n, c=3, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.rand((n, c), generator=gen) * 4.0 - 2.0


def _kernel_constant(name):
    src = (_lib.CSRC / "posenc.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _tensor_like(dtype=torch.float32, requires_grad=False):
    """What ``check_input`` reads of a CUDA tensor, without a card."""
    return SimpleNamespace(device=torch.device("cuda"), dtype=dtype,
                           requires_grad=requires_grad)


@pytest.mark.parametrize("like,error", [
    (_tensor_like(), None),
    (_tensor_like(requires_grad=True), ValueError),
    (_tensor_like(dtype=torch.float64), TypeError),
    (_tensor_like(dtype=torch.bfloat16), TypeError),
    (_tensor_like(dtype=torch.float16), TypeError),
    (_tensor_like(dtype=torch.float64, requires_grad=True), TypeError),
], ids=["f32", "requires_grad", "f64", "bf16", "f16", "f64_grad"])
def test_cuda_input_kernel_f_cannot_take_raises(like, error):
    """A CUDA f32 tensor that needs no gradient goes to F; any other CUDA
    tensor raises, and never takes the chain in F's place."""
    if error is None:
        kposenc.check_input(like)
    else:
        with pytest.raises(error, match="posenc"):
            kposenc.check_input(like)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("cfg", CONFIGS, ids=CONFIG_IDS)
def test_chain_route_is_the_plain_version(cfg, dtype):
    """On the CPU every call takes the chain: the plain version's bits,
    for every dtype, with leading dimensions kept; no launch counted."""
    c, nf, ident, log = cfg
    x = _points(2 * 7 * 5, c).reshape(2, 7, 5, c).to(dtype)
    reset_counts()
    got = kposenc.positional_encoding(x, nf, ident, log)
    want = encoding.positional_encoding(x, nf, ident, log)
    assert got.dtype == dtype and got.shape == want.shape
    assert got.shape[-1] == encoding.posenc_channels(c, nf, ident)
    assert torch.equal(got, want)
    assert COUNTS["posenc"] == 0


def test_chain_route_keeps_autograd():
    """A CPU input that requires a gradient gets the chain's autograd."""
    x = _points(33).requires_grad_()
    kposenc.positional_encoding(x, 10).square().sum().backward()
    y = x.detach().clone().requires_grad_()
    encoding.positional_encoding(y, 10).square().sum().backward()
    assert torch.equal(x.grad, y.grad)


@pytest.mark.parametrize("repeat", [1, 16, 64])
def test_repeat_is_the_chain_on_repeated_rows(repeat):
    """With ``repeat`` S, row r of the output encodes input row r // S."""
    x = _points(37)
    got = kposenc.positional_encoding(x, 4, repeat=repeat)
    rows = x[:, None, :].expand(37, repeat, 3).reshape(-1, 3)
    assert torch.equal(kposenc.repeat_rows(x, repeat), rows)
    assert torch.equal(got, encoding.positional_encoding(rows, 4))
    with pytest.raises(ValueError, match="repeat"):
        kposenc.positional_encoding(x.reshape(1, 37, 3), 4, repeat=2)


def _mirror(x, nf, ident, log, repeat):
    """Kernel F's output as its threads write it: tiles of kRows output
    rows; within a tile, item i of (rows x channels) takes channel i //
    rows and row i % rows, reads input row (r0 + row) // repeat, and puts
    its identity at column ch and frequency k's sine and cosine at base +
    2kC + ch and base + (2k + 1)C + ch of the tile's row. The values come
    from the chain's own angles, sines and cosines (the same CPU calls as
    the chain), so the map alone is under test. Returns the output and
    how often each element was written."""
    k_rows = _kernel_constant("kRows")
    n, c = x.shape
    rows = n * repeat
    base = c if ident else 0
    c_out = base + 2 * nf * c
    freqs = encoding.frequencies(nf, log)
    angles = x[..., None, :] * freqs[:, None]            # (n, F, C)
    xs, sines, cosines = (t.numpy() for t in (x, torch.sin(angles),
                                             torch.cos(angles)))
    out = np.full(rows * c_out, np.nan, np.float32)
    writes = np.zeros(rows * c_out, np.int64)

    def put(at, value):
        out[at] = value
        writes[at] += 1

    for r0 in range(0, rows, k_rows):
        nrows = min(k_rows, rows - r0)
        for i in range(nrows * c):
            ch, lr = divmod(i, nrows)
            in_row = (r0 + lr) // repeat
            o = (r0 + lr) * c_out + ch
            if ident:
                put(o, xs[in_row, ch])
            for k in range(nf):
                put(o + base + 2 * k * c, sines[in_row, k, ch])
                put(o + base + (2 * k + 1) * c, cosines[in_row, k, ch])
    return torch.from_numpy(out).reshape(rows, c_out), writes


@pytest.mark.parametrize("n,repeat", [(1, 1), (127, 1), (300, 1), (5, 16),
                                      (9, 64)])
@pytest.mark.parametrize("cfg", CONFIGS, ids=CONFIG_IDS)
def test_kernel_index_map_mirror(cfg, n, repeat):
    """The mirror of F's walk writes every output element once and gives
    the plain version's bits: one row, a ragged tile, tiles past the
    first, and repeats of 16 and 64 across tile edges."""
    c, nf, ident, log = cfg
    x = _points(n, c, seed=n + repeat)
    got, writes = _mirror(x, nf, ident, log, repeat)
    assert (writes == 1).all()
    want = encoding.positional_encoding(kposenc.repeat_rows(x, repeat), nf,
                                        ident, log)
    assert torch.equal(got, want)


def test_frequencies_are_the_chains():
    """The table F reads is the chain's: 2^k, or evenly spaced from 1 to
    2^(F - 1) by ``torch.linspace``."""
    assert torch.equal(encoding.frequencies(10),
                       2.0 ** torch.arange(10, dtype=torch.float32))
    assert torch.equal(encoding.frequencies(4, False),
                       torch.linspace(1.0, 8.0, 4))
    assert encoding.frequencies(6, dtype=torch.float64).dtype == \
        torch.float64


def test_library_lists_kernel_f():
    """F is built with the other kernels, counted as one launch a call,
    and bound with its C signature; the kernel's tile keeps its stores
    16-byte aligned."""
    assert "posenc.cu" in _lib.SOURCES
    assert (_lib.CSRC / "posenc.cu").exists()
    assert COUNTS["posenc"] >= 0 and LAUNCHES_PER_CALL["posenc"] == 1
    assert set(COUNTS) == set(LAUNCHES_PER_CALL)
    assert len(_lib._SIGNATURES["nerfsr_posenc"]) == 10
    assert _kernel_constant("kRows") % 4 == 0


@pytest.mark.parametrize("plain", [False, True])
def test_fused_nerf_mlp_repeat_equals_expanded_directions(plain):
    """The fused MLP's directions by ``repeat`` give the bits of the
    per-point copies the render path used to build."""
    torch.manual_seed(0)
    from nerfsr_torch.models.mlp import VanillaMLP
    mlp = VanillaMLP(c_pos=63, c_dir=27)
    flat = kmlp.flatten_params(mlp)
    n, s = 6, 16
    pts, dirs = _points(n * s, seed=1), _points(n, seed=2)
    x0, dmb = kmlp.embed(pts, dirs, repeat=s, plain=plain)
    assert torch.equal(dmb, encoding.positional_encoding(
        kposenc.repeat_rows(dirs, s), kmlp.DEG_DIR))
    got = kmlp.fused_nerf_mlp(flat, pts, dirs, plain=plain, repeat=s)
    want = kmlp.fused_nerf_mlp(flat, pts, kposenc.repeat_rows(dirs, s),
                               plain=plain)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
