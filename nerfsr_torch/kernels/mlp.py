"""Kernels C and E: fused NeRF MLP forward and backward
(``csrc/fused_mlp_tc.cu``, ``csrc/fused_mlp_bwd_tc.cu`` in bf16;
``csrc/fused_mlp_tf32.cu``, ``csrc/fused_mlp_bwd_tf32.cu`` in f32).

Twin of ``nerfsr_tpu/ops/experimental/pallas_mlp.py``: ``fused_nerf_mlp``'s
forward (``_fwd`` / ``_fwd_pass``, kernel C) and its custom VJP's
backward with ``bwd_mode="pallas"`` (``_bwd`` / ``_bwd_kernel_v3``, kernel
E): the D8/W256 VanillaMLP with the skip at layer 4, on positional
encodings computed outside the kernels (kernel F, ``kernels/posenc.py``,
or on the plain path the chain of ``core/encoding.py``). Only the
architecture that ``NeRFSystem._fused_mlp_ok`` accepts takes this path.

Numerics of ``compute_dtype``: float32 computes in f32. bfloat16 (the
"mixed" precision) rounds the inputs, the weights and every activation
that feeds a matmul (post-ReLU trunk activations, feat, the direction
branch) to bf16, accumulates in f32 and adds the bias in f32; sigma and
rgb_pre stay f32. The backward recomputes the forward by that rule and
rounds every backpropagated gradient to bf16 after its ReLU mask (the
sigma cotangent stays f32); the weight and bias gradients accumulate in
f32. ``fused_mlp_plain`` and ``fused_mlp_bwd_plain`` are that rule in
PyTorch.

``fused_mlp_fwd`` is a ``torch.autograd.Function`` over (params_flat,
x0, dmb): forward kernel C, backward kernel E. It returns no gradient for
x0 and dmb, the JAX contract (their gradients are zero: sample points
come from detached depths). A CPU tensor takes the plain versions; a
CUDA tensor launches the kernels or raises. The compute dtype picks the
kernels, all on the tensor cores: bfloat16 runs ``csrc/fused_mlp_tc.cu``
and ``csrc/fused_mlp_bwd_tc.cu``; float32 runs ``csrc/fused_mlp_tf32.cu``
and ``csrc/fused_mlp_bwd_tf32.cu``, whose products are 3xTF32 (each
operand split into a tf32 big part and a tf32 small part, three tf32
products summed in f32: within ~2^-22 of the f32 product term by term).

The packed weights are cached on the parameters' identity and version
counters (``packed``): serving packs once for all chunks of all views,
training once per step for kernels C and E together. An in-place update
of a parameter (an optimizer step, ``copy_`` under ``no_grad``) bumps its
version and repacks; a write through ``.data`` is not seen, and neither
is the replay of a CUDA graph, which runs no Python: ``forget_packed``
empties the cache around every capture (so the graph records its own
packing) and after every replay that moves parameters.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from nerfsr_torch.core.encoding import positional_encoding
from nerfsr_torch.kernels import _lib
from nerfsr_torch.kernels import posenc as kposenc

D = 8
W = 256
SKIP = 4          # concat the input embedding before layer index 4
DEG_POS = 10
DEG_DIR = 4
C_POS = 3 + 3 * 2 * DEG_POS   # 63
C_DIR = 3 + 3 * 2 * DEG_DIR   # 27
W_HALF = W // 2

# parameter order in the flat tuple and in the kernel's packed buffers
PARAM_NAMES = tuple(
    [f"xyz_encoding_{i + 1}" for i in range(D)]
    + ["xyz_encoding_final", "sigma", "dir_encoding", "rgb"])
_IN_DIMS = ([C_POS] + [W] * (SKIP - 1) + [C_POS + W] + [W] * (D - SKIP - 1)
            + [W, W, W + C_DIR, W_HALF])
_OUT_DIMS = [W] * D + [W, 1, W_HALF, 3]
N_WEIGHTS = sum(i * o for i, o in zip(_IN_DIMS, _OUT_DIMS))   # 593,408
N_BIASES = sum(_OUT_DIMS)                                      # 2,436
# kernel E's partial sums of the packed gradients (both routes)
E_SPLITS = 16

# The bf16 tensor-core kernels (csrc/mlp_tc.cuh). Weights go in as
# chunks of 64 reduction rows (32 for the direction layer's dmb rows),
# each the exact shared-memory image wgmma reads: B (N, K) K-major in
# 8 x 8 core matrices, [N/8][K/8][8][8]. x0 is padded 63 -> 64 and dmb
# 27 -> 32 with zero rows.
TC_X0 = 64
TC_DMB = 32
TC_CHUNK = 64
TC_FWD_IMAGE = 593_920          # bf16 values: 34 x 64x256, 4 x 64x128, 32x128
TC_BWD_IMAGE = 34 * TC_CHUNK * W
TC_HEADS = W + W_HALF * 3       # f32: w_sig, then w_rgb (128, 3)
# kernel E's bf16 scratch rows (csrc/fused_mlp_bwd_tc.cu): activations
# a0 | a1 | a2 | x0 (64) | a3 .. a7 | feat | dmb (32) | g, and gradients
# gh0 .. gh7 | gfeat | gg | grgb_pre (8)
TC_ACT_WIDTH = 8 * W + TC_X0 + W + TC_DMB + W_HALF             # 2,528
TC_GRAD_WIDTH = 8 * W + W + W_HALF + 8                         # 2,440

# The f32 tensor-core kernels (csrc/mlp_tf32.cuh), 3xTF32. Weights go in
# as chunks of 16 reduction rows, each a big image then a small image of
# B (N, 16) K-major in 8 x 4 core matrices, [N/8][4][8][4], with the
# reduction rows of every group of 8 in TF32_K_ORDER (the hardware reads a
# register fragment's k-slot l % 4 + 4 h from the value at reduction index
# 2 (l % 4) + h: csrc/wgmma.cuh).
TF32_CHUNK = 16
TF32_K_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)
TF32_FWD_IMAGE = 2 * TC_FWD_IMAGE        # f32 values: big and small
TF32_BWD_IMAGE = 2 * 34 * TC_CHUNK * W
# kernel E's f32 scratch (csrc/fused_mlp_bwd_tf32.cu): the bf16 rows'
# features, in f32, feature-major in tiles of 32 points; rows rounded up
# to E1's 128-point blocks
F32_ACT_WIDTH = TC_ACT_WIDTH
F32_GRAD_WIDTH = TC_GRAD_WIDTH
F32_BLOCK_POINTS = 128


def flatten_params(mlp) -> tuple:
    """VanillaMLP module -> flat (kernel (in, out), bias (1, out)) tuple in
    PARAM_NAMES order, the layout of the JAX package's ``flatten_params``
    (a kernel is the transpose of ``Linear.weight``)."""
    flat = []
    for name in PARAM_NAMES:
        lin = getattr(mlp, name)
        flat.append(lin.weight.t())
        flat.append(lin.bias.reshape(1, -1))
    return tuple(flat)


def _rounder(compute_dtype):
    if compute_dtype == torch.bfloat16:
        return lambda t: t.to(torch.bfloat16).to(t.dtype)
    if compute_dtype == torch.float32:
        return lambda t: t.float()
    raise ValueError(f"compute dtype {compute_dtype}: bfloat16 or float32")


def fused_mlp_plain(params_flat, x0: torch.Tensor, dmb: torch.Tensor,
                    compute_dtype=torch.float32):
    """Plain PyTorch version of kernel C on pre-embedded inputs:
    x0 (P, 63), dmb (P, 27) -> rgb (P, 3), sigma (P,), f32 matmuls."""
    r = _rounder(compute_dtype)
    x0 = r(x0)
    dmb = r(dmb)
    h = x0
    for i in range(D):
        wk, bk = params_flat[2 * i], params_flat[2 * i + 1]
        if i == SKIP:
            h = torch.cat([x0, h], dim=-1)
        h = r(torch.relu(h @ r(wk) + bk))
    w_fin, b_fin, w_sig, b_sig, w_dir, b_dir, w_rgb, b_rgb = \
        params_flat[2 * D:]
    feat = r(h @ r(w_fin) + b_fin)
    sigma = h @ r(w_sig) + b_sig
    g = r(torch.relu(torch.cat([feat, dmb], dim=-1) @ r(w_dir) + b_dir))
    rgb = torch.sigmoid(g @ r(w_rgb) + b_rgb)
    return rgb, sigma[:, 0]


def tc_chunk_image(b: torch.Tensor) -> torch.Tensor:
    """B (N, K) -> its wgmma image: K-major 8 x 8 core matrices,
    [N/8][K/8][8][8], flat."""
    n, k = b.shape
    return b.reshape(n // 8, 8, k // 8, 8).permute(0, 2, 1, 3).reshape(-1)


def _rows_padded(w: torch.Tensor, r0: int, r1: int, k: int) -> torch.Tensor:
    """Rows r0:r1 of a kernel (in, out), zero-padded to k rows."""
    out = w.new_zeros((k, w.shape[1]))
    out[:r1 - r0] = w[r0:r1]
    return out


def tc_fwd_chunks(kernels):
    """The forward image's chunks as B (N, K) = the rows of W^T that one
    chunk covers, in the kernel's consumption order (csrc/mlp_tc.cuh):
    layer 0, layers 1-3, layer 4 (x0 rows, then h rows), layers 5-7,
    final, direction layer (feat rows in 4 chunks, then dmb rows)."""
    chunks = []
    for i in range(D):
        w = kernels[i]
        if i in (0, SKIP):
            chunks.append(_rows_padded(w, 0, C_POS, TC_X0).t())
        h0 = C_POS if i == SKIP else 0
        if i > 0:
            chunks += [w[h0 + c:h0 + c + TC_CHUNK].t()
                       for c in range(0, W, TC_CHUNK)]
    w_fin, w_dir = kernels[D], kernels[D + 2]
    chunks += [w_fin[c:c + TC_CHUNK].t() for c in range(0, W, TC_CHUNK)]
    chunks += [w_dir[c:c + TC_CHUNK].t() for c in range(0, W, TC_CHUNK)]
    chunks.append(_rows_padded(w_dir, W, W + C_DIR, TC_DMB).t())
    return chunks


def tc_bwd_chunks(kernels):
    """The backward image's chunks as B (N, K) = W[h rows, out block]
    (the product gh @ W^T reduces over the layer's outputs), in the
    kernel's order: the direction layer's feat rows, final, layers 7..1."""
    mats = [kernels[D + 2][:W], kernels[D]]
    mats += [kernels[i][C_POS:] if i == SKIP else kernels[i]
             for i in range(D - 1, 0, -1)]
    return [m[:, c:c + TC_CHUNK] for m in mats
            for c in range(0, m.shape[1], TC_CHUNK)]


_image_index: dict = {}


def _tc_index(chunks_fn, device, image_fn=None) -> torch.Tensor:
    """Where each value of a weight image comes from: an index into the
    kernels' transposes (each ``(out, in)`` row-major) back to back in
    PARAM_NAMES order, then one zero (the padding rows). Built once per
    image and device by running the chunk packer (and ``image_fn``, by
    default ``tc_chunk_image``) on the indices."""
    image_fn = image_fn or tc_chunk_image
    key = (chunks_fn, device, image_fn)
    if key not in _image_index:
        src = torch.arange(1, N_WEIGHTS + 1, dtype=torch.float64)
        kernels, o = [], 0
        for i, n in zip(_IN_DIMS, _OUT_DIMS):
            kernels.append(src[o:o + i * n].view(n, i).t())
            o += i * n
        idx = torch.cat([image_fn(c) for c in chunks_fn(kernels)])
        idx = idx.long() - 1
        idx[idx < 0] = N_WEIGHTS
        _image_index[key] = idx.to(device)
    return _image_index[key]


def _tc_image(params_flat, chunks_fn) -> torch.Tensor:
    """A bf16 weight image: one gather from the kernels' transposes."""
    src = torch.cat([k.t().reshape(-1) for k in params_flat[0::2]]
                    + [params_flat[0].new_zeros(1)]).to(torch.bfloat16)
    return src[_tc_index(chunks_fn, src.device)]


def pack_tc(params_flat):
    """Kernel C's bf16 buffers: the forward weight image (bf16), the
    packed f32 biases and the f32 head weights (w_sig, then w_rgb, as
    bf16 values)."""
    biases = torch.cat([b.reshape(-1) for b in params_flat[1::2]]).float()
    heads = torch.cat([params_flat[2 * D + 2].reshape(-1),
                       params_flat[2 * D + 6].reshape(-1)])
    return (_tc_image(params_flat, tc_fwd_chunks), biases.contiguous(),
            heads.to(torch.bfloat16).float().contiguous())


def pack_tc_bwd(params_flat):
    """Kernel E's second bf16 image (the input-gradient products)."""
    return _tc_image(params_flat, tc_bwd_chunks)


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest tf32 value (10 mantissa bits), ties away from
    zero: ``cvt.rna.tf32.f32``."""
    b = t.float().contiguous().view(torch.int32)
    mag = ((b & 0x7FFFFFFF) + 0x1000) & -0x2000
    return (mag | (b & -0x80000000)).view(torch.float32)


def tf32_split(t: torch.Tensor):
    """(big, small): big = tf32(t), small = tf32(t - big), the kernels'
    split; big + small is within 2^-22 |t| of t."""
    big = tf32_round(t)
    return big, tf32_round(t.float() - big)


def tf32_chunk_image(b: torch.Tensor, ordered: bool = True) -> torch.Tensor:
    """B (N, K) -> its tf32 wgmma image: K-major 8 x 4 core matrices,
    [N/8][K/4][8][4], flat; with ``ordered``, the reduction rows of every
    group of 8 in TF32_K_ORDER first."""
    n, k = b.shape
    if ordered:
        b = b.reshape(n, k // 8, 8)[..., list(TF32_K_ORDER)].reshape(n, k)
    return b.reshape(n // 8, 8, k // 4, 4).permute(0, 2, 1, 3).reshape(-1)


def tf32_fwd_chunks(kernels):
    """The f32 forward image's chunks as B (N, 16), in the kernel's
    consumption order (csrc/mlp_tf32.cuh): the chunks of
    ``tc_fwd_chunks``, cut into 16 reduction rows."""
    return [c[:, k:k + TF32_CHUNK] for c in tc_fwd_chunks(kernels)
            for k in range(0, c.shape[1], TF32_CHUNK)]


def tf32_bwd_chunks(kernels):
    """The f32 backward image's chunks as B (N, 16) = W[h rows, 16 outputs],
    in the kernel's order (``tc_bwd_chunks``'s)."""
    return [c[:, k:k + TF32_CHUNK] for c in tc_bwd_chunks(kernels)
            for k in range(0, c.shape[1], TF32_CHUNK)]


def _tf32_index(chunks_fn, device) -> torch.Tensor:
    """Where each value of an f32 image comes from: ``_tc_index``'s index
    over the tf32 chunk images, each chunk's span followed by itself
    shifted into the small parts (``_tf32_image``'s source is the kernels'
    big parts, their zero, then their small parts and zero). Built once
    per image and device."""
    key = ("tf32", chunks_fn, device)
    if key not in _image_index:
        idx = _tc_index(chunks_fn, device, tf32_chunk_image)
        sizes = [c.numel() for c in chunks_fn(
            [torch.empty((i, o), device="meta")
             for i, o in zip(_IN_DIMS, _OUT_DIMS)])]
        spans = idx.split(sizes)
        _image_index[key] = torch.cat(
            [part for span in spans for part in (span, span + N_WEIGHTS + 1)])
    return _image_index[key]


def _tf32_image(params_flat, chunks_fn) -> torch.Tensor:
    """An f32 weight image: the kernels' transposes split into big and
    small parts, then one gather (``_tf32_index``)."""
    src = torch.cat([k.t().reshape(-1) for k in params_flat[0::2]]
                    + [params_flat[0].new_zeros(1)]).float()
    big, small = tf32_split(src)
    return torch.cat([big, small])[_tf32_index(chunks_fn, src.device)]


def pack_tf32(params_flat):
    """Kernel C's f32 buffers: the forward weight image (f32 big and small
    chunks), the packed f32 biases and the f32 head weights (w_sig, then
    w_rgb)."""
    biases = torch.cat([b.reshape(-1) for b in params_flat[1::2]]).float()
    heads = torch.cat([params_flat[2 * D + 2].reshape(-1),
                       params_flat[2 * D + 6].reshape(-1)]).float()
    return (_tf32_image(params_flat, tf32_fwd_chunks), biases.contiguous(),
            heads.contiguous())


def pack_tf32_bwd(params_flat):
    """Kernel E's f32 buffers beside ``pack_tf32``'s: the backward image
    (the input-gradient products on the tensor cores) and every kernel
    (in, out) row-major back to back in f32 (its forward recompute's SIMT
    products)."""
    return (_tf32_image(params_flat, tf32_bwd_chunks),
            torch.cat([k.reshape(-1) for k in params_flat[0::2]]).float())


_CACHE_SLOTS = 4
_cache: "collections.OrderedDict" = collections.OrderedDict()


def forget_packed():
    """Empty the packing cache (``packed``)."""
    _cache.clear()


def packed(params_flat, kind: str):
    """The packed buffers of ``kind`` ("tc", "tc_bwd", "tf32", "tf32_bwd")
    for these parameters, packed again only when a parameter is another
    tensor or its version counter moved. The entry holds the parameters
    (the bases of views such as ``weight.t()``), so their ids stay
    theirs while it lives."""
    bases = tuple(t if t._base is None else t._base for t in params_flat)
    key = (kind,) + tuple(id(b) for b in bases)
    versions = tuple(t._version for t in params_flat)
    hit = _cache.get(key)
    if hit is not None and hit[0] == versions:
        _cache.move_to_end(key)
        return hit[2]
    with torch.no_grad():
        if kind == "tc":
            value = pack_tc(params_flat)
        elif kind == "tc_bwd":
            value = pack_tc_bwd(params_flat)
        elif kind == "tf32":
            value = pack_tf32(params_flat)
        elif kind == "tf32_bwd":
            value = pack_tf32_bwd(params_flat)
        else:
            raise ValueError(f"packing kind {kind}")
    _cache[key] = (versions, bases, value)
    _cache.move_to_end(key)
    while len(_cache) > _CACHE_SLOTS:
        _cache.popitem(last=False)
    return value


@functools.lru_cache(maxsize=None)
def _check_tc_layout():
    """The bf16 kernels' image and scratch sizes as the library reports
    them (checked once per process)."""
    vals = [ctypes.c_int() for _ in range(7)]
    _lib.lib().nerfsr_fused_mlp_tc_layout(*map(ctypes.byref, vals[:3]))
    _lib.lib().nerfsr_fused_mlp_bwd_tc_layout(*map(ctypes.byref, vals[3:]))
    got = tuple(v.value for v in vals)
    want = (2 * TC_FWD_IMAGE, 2 * TC_BWD_IMAGE, TC_HEADS, TC_ACT_WIDTH,
            TC_GRAD_WIDTH, E_SPLITS, N_WEIGHTS + N_BIASES)
    if got != want:
        raise RuntimeError(f"tensor-core kernel layout {got}, expected "
                           f"{want}")


@functools.lru_cache(maxsize=None)
def _check_tf32_layout():
    """The f32 kernels' image and scratch sizes as the library reports
    them (checked once per process)."""
    vals = [ctypes.c_int() for _ in range(7)]
    _lib.lib().nerfsr_fused_mlp_tf32_layout(*map(ctypes.byref, vals[:3]))
    _lib.lib().nerfsr_fused_mlp_bwd_tf32_layout(
        *map(ctypes.byref, vals[3:]))
    got = tuple(v.value for v in vals)
    want = (4 * TF32_FWD_IMAGE, 4 * TF32_BWD_IMAGE, TC_HEADS,
            F32_ACT_WIDTH, F32_GRAD_WIDTH, E_SPLITS, N_WEIGHTS + N_BIASES)
    if got != want:
        raise RuntimeError(f"f32 tensor-core kernel layout {got}, expected "
                           f"{want}")


def _kernel_c(params_flat, x0: torch.Tensor, dmb: torch.Tensor,
              compute_dtype):
    """Launch kernel C: x0 (P, 63), dmb (P, 27) f32 -> rgb (P, 3) f32,
    sigma (P,) f32; bf16 or, in f32, 3xTF32 on the tensor cores."""
    p, dev = x0.shape[0], x0.device
    _lib.check_cuda(x0, "x0", (p, C_POS))
    _lib.check_cuda(dmb, "dmb", (p, C_DIR), device=dev)
    rgb = torch.empty((p, 3), dtype=torch.float32, device=dev)
    sigma = torch.empty((p,), dtype=torch.float32, device=dev)
    bf16 = compute_dtype == torch.bfloat16
    img, b, heads = packed(params_flat, "tc" if bf16 else "tf32")
    _lib.check_cuda(img, "weight image",
                    (TC_FWD_IMAGE,) if bf16 else (TF32_FWD_IMAGE,),
                    torch.bfloat16 if bf16 else torch.float32, device=dev)
    _lib.check_cuda(b, "packed biases", (N_BIASES,), device=dev)
    _lib.check_cuda(heads, "head weights", (TC_HEADS,), device=dev)
    if bf16:
        _check_tc_layout()
    else:
        _check_tf32_layout()
    entry = _lib.lib().nerfsr_fused_mlp_fwd_tc if bf16 \
        else _lib.lib().nerfsr_fused_mlp_fwd_tf32
    with torch.cuda.device(dev):
        err = entry(x0.data_ptr(), dmb.data_ptr(), img.data_ptr(),
                    b.data_ptr(), heads.data_ptr(), rgb.data_ptr(),
                    sigma.data_ptr(), p, _lib.stream_ptr(x0))
    _lib.check(err, "fused_mlp_fwd")
    _lib.COUNTS["fused_mlp_fwd"] += 1
    return rgb, sigma


def tc_probe(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One 256 -> 256 product through the tensor-core tile, its ring and
    descriptors: x (128, 256) bf16 @ w (256, 256) as a trunk layer's
    kernel (rounded to bf16) -> (128, 256) f32. Pins the image and
    descriptor layout on its own; no launch count (not a main-path
    kernel)."""
    _lib.check_cuda(x, "x", (128, W), torch.bfloat16)
    _lib.check_cuda(w, "w", (W, W), device=x.device)
    kb = w.to(torch.bfloat16)
    img = torch.cat([tc_chunk_image(kb[c:c + TC_CHUNK].t())
                     for c in range(0, W, TC_CHUNK)]).contiguous()
    d = torch.empty((128, W), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib.lib().nerfsr_tc_probe(x.data_ptr(), img.data_ptr(),
                                         d.data_ptr(), _lib.stream_ptr(x))
    _lib.check(err, "tc_probe")
    return d


TF32_PROBE_MODES = {0: "A and B from shared memory",
                    1: "A from registers in the kernels' placement",
                    2: "A from registers in the hardware's placement",
                    3: "3xTF32, A from registers",
                    4: "shared memory, raw f32 bits"}


def tf32_probe(a: torch.Tensor, b: torch.Tensor, mode: int) -> torch.Tensor:
    """One 64 x 32 by 32 x 256 product through the tf32 wgmma pieces
    (``csrc/tf32_probe.cu``): a (64, 32), b (32, 256) f32 on the card ->
    (64, 256) f32, in ``mode`` (``TF32_PROBE_MODES``). Modes 0-2 read a
    and b as tf32 (the hardware drops their low 13 bits: mode 4), mode 3
    splits both (3xTF32). Pins the layouts on their own; no launch count
    (not a main-path kernel)."""
    _lib.check_cuda(a, "a", (64, 32))
    _lib.check_cuda(b, "b", (32, W), device=a.device)
    big, small = tf32_split(b) if mode == 3 else (b, torch.zeros_like(b))
    ordered = mode in (1, 3)
    aimg = tf32_chunk_image(a, ordered=False).contiguous()
    bimg = tf32_chunk_image(big.t(), ordered).contiguous()
    simg = tf32_chunk_image(small.t(), ordered).contiguous()
    d = torch.empty((64, W), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = _lib.lib().nerfsr_tf32_probe(
            a.data_ptr(), aimg.data_ptr(), bimg.data_ptr(), simg.data_ptr(),
            d.data_ptr(), mode, _lib.stream_ptr(a))
    _lib.check(err, "tf32_probe")
    return d


def fused_mlp_bwd_plain(params_flat, x0: torch.Tensor, dmb: torch.Tensor,
                        grgb: torch.Tensor, gsigma: torch.Tensor,
                        compute_dtype=torch.float32):
    """Plain PyTorch version of kernel E: recompute the forward by the
    ``compute_dtype`` rule and backpropagate grgb (P, 3) and gsigma (P,).
    Returns the flat (kernel (in, out), bias (1, out)) gradient tuple in
    PARAM_NAMES order, f32."""
    r = _rounder(compute_dtype)
    ws = [r(k) for k in params_flat[0::2]]
    bs = [b.float().reshape(-1) for b in params_flat[1::2]]
    x0 = r(x0)
    dmb = r(dmb)
    h = x0
    ins, acts = [], []
    for i in range(D):
        inp = torch.cat([x0, h], dim=-1) if i == SKIP else h
        ins.append(inp)
        h = r(torch.relu(inp @ ws[i] + bs[i]))
        acts.append(h)
    w_fin, w_sig, w_dir, w_rgb = ws[D:]
    feat = r(h @ w_fin + bs[D])
    din = torch.cat([feat, dmb], dim=-1)
    g = r(torch.relu(din @ w_dir + bs[D + 2]))
    rgb = torch.sigmoid(g @ w_rgb + bs[D + 3])

    grgb_pre = r(grgb * rgb * (1.0 - rgb))
    gg = r((grgb_pre @ w_rgb.t()) * (g > 0))
    gfeat = r(gg @ w_dir[:W].t())
    gsig = gsigma.reshape(-1, 1).to(x0.dtype)
    dws, dbs = [None] * (D + 4), [None] * (D + 4)
    dws[D + 3], dbs[D + 3] = g.t() @ grgb_pre, grgb_pre.sum(0)
    dws[D + 2], dbs[D + 2] = din.t() @ gg, gg.sum(0)
    dws[D], dbs[D] = h.t() @ gfeat, gfeat.sum(0)
    dws[D + 1], dbs[D + 1] = h.t() @ gsig, gsig.sum(0)
    gh = gfeat @ w_fin.t() + gsig * w_sig.t()
    for i in range(D - 1, -1, -1):
        gh = r(gh * (acts[i] > 0))
        dws[i], dbs[i] = ins[i].t() @ gh, gh.sum(0)
        if i > 0:
            w_h = ws[i][C_POS:] if i == SKIP else ws[i]
            gh = gh @ w_h.t()
    out = []
    for dw, db in zip(dws, dbs):
        out += [dw, db.reshape(1, -1)]
    return tuple(out)


def _unpack_grads(flat_grad):
    """Kernel E's packed output -> the flat (kernel, bias) tuple."""
    out, wo, bo = [], 0, N_WEIGHTS
    for i, o in zip(_IN_DIMS, _OUT_DIMS):
        out.append(flat_grad[wo:wo + i * o].view(i, o))
        out.append(flat_grad[bo:bo + o].view(1, o))
        wo += i * o
        bo += o
    return tuple(out)


def fused_mlp_bwd(params_flat, x0: torch.Tensor, dmb: torch.Tensor,
                  grgb: torch.Tensor, gsigma: torch.Tensor,
                  compute_dtype=torch.float32):
    """Kernel E (shapes as ``fused_mlp_bwd_plain``)."""
    if x0.device.type == "cpu":
        return fused_mlp_bwd_plain(params_flat, x0, dmb, grgb, gsigma,
                                   compute_dtype)
    _rounder(compute_dtype)
    p, dev = x0.shape[0], x0.device
    _lib.check_cuda(x0, "x0", (p, C_POS))
    _lib.check_cuda(dmb, "dmb", (p, C_DIR), device=dev)
    _lib.check_cuda(grgb, "grgb", (p, 3), device=dev)
    _lib.check_cuda(gsigma, "gsigma", (p,), device=dev)
    partial = torch.empty((E_SPLITS, N_WEIGHTS + N_BIASES),
                          dtype=torch.float32, device=dev)
    out = torch.empty((N_WEIGHTS + N_BIASES,), dtype=torch.float32,
                      device=dev)
    if compute_dtype == torch.bfloat16:
        img, b, heads = packed(params_flat, "tc")
        img_bwd = packed(params_flat, "tc_bwd")
        _lib.check_cuda(img, "weight image", (TC_FWD_IMAGE,),
                        torch.bfloat16, device=dev)
        _lib.check_cuda(img_bwd, "backward weight image", (TC_BWD_IMAGE,),
                        torch.bfloat16, device=dev)
        _lib.check_cuda(b, "packed biases", (N_BIASES,), device=dev)
        _lib.check_cuda(heads, "head weights", (TC_HEADS,), device=dev)
        _check_tc_layout()
        if gsigma.data_ptr() % 16:   # E2 reads it by TMA
            gsigma = gsigma.clone()
        acts = torch.empty((p, TC_ACT_WIDTH), dtype=torch.bfloat16,
                           device=dev)
        grads = torch.empty((p, TC_GRAD_WIDTH), dtype=torch.bfloat16,
                            device=dev)
        with torch.cuda.device(dev):
            err = _lib.lib().nerfsr_fused_mlp_bwd_tc(
                x0.data_ptr(), dmb.data_ptr(), grgb.data_ptr(),
                gsigma.data_ptr(), img.data_ptr(), img_bwd.data_ptr(),
                b.data_ptr(), heads.data_ptr(), acts.data_ptr(),
                grads.data_ptr(), partial.data_ptr(), out.data_ptr(), p,
                _lib.stream_ptr(x0))
    else:
        _, b, heads = packed(params_flat, "tf32")
        img_bwd, w = packed(params_flat, "tf32_bwd")
        _lib.check_cuda(img_bwd, "backward weight image",
                        (TF32_BWD_IMAGE,), device=dev)
        _lib.check_cuda(w, "packed weights", (N_WEIGHTS,), device=dev)
        _lib.check_cuda(b, "packed biases", (N_BIASES,), device=dev)
        _lib.check_cuda(heads, "head weights", (TC_HEADS,), device=dev)
        _check_tf32_layout()
        rows = -(-p // F32_BLOCK_POINTS) * F32_BLOCK_POINTS
        acts = torch.empty((rows, F32_ACT_WIDTH), dtype=torch.float32,
                           device=dev)
        grads = torch.empty((rows, F32_GRAD_WIDTH), dtype=torch.float32,
                            device=dev)
        with torch.cuda.device(dev):
            err = _lib.lib().nerfsr_fused_mlp_bwd_tf32(
                x0.data_ptr(), dmb.data_ptr(), grgb.data_ptr(),
                gsigma.data_ptr(), w.data_ptr(), img_bwd.data_ptr(),
                b.data_ptr(), heads.data_ptr(), acts.data_ptr(),
                grads.data_ptr(), partial.data_ptr(), out.data_ptr(), p,
                _lib.stream_ptr(x0))
    _lib.check(err, "fused_mlp_bwd")
    _lib.COUNTS["fused_mlp_bwd"] += 1
    return _unpack_grads(out)


class _FusedMLP(torch.autograd.Function):
    """Forward kernel C, backward kernel E; no input gradients."""

    @staticmethod
    def forward(ctx, compute_dtype, x0, dmb, *params_flat):
        ctx.compute_dtype = compute_dtype
        ctx.save_for_backward(x0, dmb, *params_flat)
        if x0.device.type == "cpu":
            return fused_mlp_plain(params_flat, x0, dmb, compute_dtype)
        return _kernel_c(params_flat, x0, dmb, compute_dtype)

    @staticmethod
    def backward(ctx, grgb, gsigma):
        x0, dmb, *params_flat = ctx.saved_tensors
        grads = fused_mlp_bwd(params_flat, x0, dmb, grgb.contiguous(),
                              gsigma.contiguous(), ctx.compute_dtype)
        return (None, None, None) + tuple(
            g.reshape(p.shape) for g, p in zip(grads, params_flat))


def fused_mlp_fwd(params_flat, x0: torch.Tensor, dmb: torch.Tensor,
                  compute_dtype=torch.float32):
    """Kernel C on pre-embedded inputs: x0 (P, 63), dmb (P, 27) f32 ->
    rgb (P, 3) f32, sigma (P,) f32; differentiable in ``params_flat``
    through kernel E."""
    _rounder(compute_dtype)
    return _FusedMLP.apply(compute_dtype, x0, dmb, *params_flat)


def embed(points: torch.Tensor, viewdirs: torch.Tensor, repeat: int = 1,
          plain: bool = False):
    """The positional encodings kernel C takes, computed outside it:
    points (P, 3) and viewdirs (P / repeat, 3), each direction that of
    ``repeat`` consecutive points. Kernel F, or with ``plain`` the chain
    of ``core/encoding.py``; the same bits either way."""
    if plain:
        if repeat > 1:
            viewdirs = kposenc.repeat_rows(viewdirs, repeat)
        return (positional_encoding(points, DEG_POS),
                positional_encoding(viewdirs, DEG_DIR))
    return (kposenc.positional_encoding(points, DEG_POS),
            kposenc.positional_encoding(viewdirs, DEG_DIR, repeat=repeat))


def fused_nerf_mlp(params_flat, points: torch.Tensor, viewdirs: torch.Tensor,
                   compute_dtype=torch.float32, plain: bool = False,
                   repeat: int = 1):
    """(rgb (P, 3), sigma (P,)) from raw points (P, 3) and viewdirs
    (P / repeat, 3): embed (``embed``), then kernel C (or, with
    ``plain``, the chain and C's plain version)."""
    x0, dmb = embed(points, viewdirs, repeat, plain)
    fn = fused_mlp_plain if plain else fused_mlp_fwd
    return fn(params_flat, x0, dmb, compute_dtype)
