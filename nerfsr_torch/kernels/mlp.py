"""Kernels C and E: fused NeRF MLP forward and backward
(``csrc/fused_mlp.cu``, ``csrc/fused_mlp_bwd.cu``).

Twin of ``nerfsr_tpu/ops/experimental/pallas_mlp.py``: ``fused_nerf_mlp``'s
forward (``_fwd`` / ``_fwd_pass``, kernel C) and its custom VJP's
backward with ``bwd_mode="pallas"`` (``_bwd`` / ``_bwd_kernel_v3``, kernel
E): the D8/W256 VanillaMLP with the skip at layer 4, on positional
encodings computed outside the kernels. Only the architecture that
``NeRFSystem._fused_mlp_ok`` accepts takes this path.

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
CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import ctypes

import torch

from nerfsr_torch.core.encoding import positional_encoding
from nerfsr_torch.kernels import _lib

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
# kernel E's scratch (csrc/fused_mlp_bwd.cu), f32: one row per point of
# every layer's input activation and of every layer's output gradient,
# and E_SPLITS partial sums of the packed gradients
ACT_WIDTH = 8 * W + C_POS + W + C_DIR + W_HALF                 # 2,522
E_SPLITS = 16


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
        return lambda t: t.to(torch.bfloat16).float()
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


def pack_params(params_flat, compute_dtype):
    """The kernel's two buffers: every kernel (in, out) row-major back to
    back in ``compute_dtype``, and every bias in f32, in PARAM_NAMES
    order."""
    kernels = torch.cat([k.reshape(-1) for k in params_flat[0::2]])
    biases = torch.cat([b.reshape(-1) for b in params_flat[1::2]])
    return (kernels.to(compute_dtype).contiguous(),
            biases.float().contiguous())


def _kernel_c(params_flat, x0: torch.Tensor, dmb: torch.Tensor,
              compute_dtype):
    """Launch kernel C: x0 (P, 63), dmb (P, 27) f32 -> rgb (P, 3) f32,
    sigma (P,) f32."""
    p = x0.shape[0]
    _lib.check_cuda(x0, "x0", (p, C_POS))
    _lib.check_cuda(dmb, "dmb", (p, C_DIR), device=x0.device)
    w, b = pack_params(params_flat, compute_dtype)
    _lib.check_cuda(w, "packed weights", (N_WEIGHTS,), compute_dtype,
                    device=x0.device)
    _lib.check_cuda(b, "packed biases", (N_BIASES,), device=x0.device)
    rgb = torch.empty((p, 3), dtype=torch.float32, device=x0.device)
    sigma = torch.empty((p,), dtype=torch.float32, device=x0.device)
    with torch.cuda.device(x0.device):
        err = _lib.lib().nerfsr_fused_mlp_fwd(
            x0.data_ptr(), dmb.data_ptr(), w.data_ptr(), b.data_ptr(),
            rgb.data_ptr(), sigma.data_ptr(), p,
            int(compute_dtype == torch.bfloat16), _lib.stream_ptr(x0))
    _lib.check(err, "fused_mlp_fwd")
    _lib.COUNTS["fused_mlp_fwd"] += 1
    return rgb, sigma


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
    gsig = gsigma.reshape(-1, 1).float()
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


def pack_bwd_params(params_flat, compute_dtype):
    """Kernel E's three buffers, all f32: the kernels rounded by the
    ``compute_dtype`` rule, row-major (in, out) back to back, the same
    transposed to (out, in) at the same offsets, and the biases."""
    r = _rounder(compute_dtype)
    kernels = [r(k) for k in params_flat[0::2]]
    w = torch.cat([k.reshape(-1) for k in kernels])
    wt = torch.cat([k.t().reshape(-1) for k in kernels])
    b = torch.cat([b.reshape(-1) for b in params_flat[1::2]]).float()
    return w.contiguous(), wt.contiguous(), b.contiguous()


def _unpack_grads(flat_grad):
    """Kernel E's packed output -> the flat (kernel, bias) tuple."""
    out, wo, bo = [], 0, N_WEIGHTS
    for i, o in zip(_IN_DIMS, _OUT_DIMS):
        out.append(flat_grad[wo:wo + i * o].view(i, o))
        out.append(flat_grad[bo:bo + o].view(1, o))
        wo += i * o
        bo += o
    return tuple(out)


def _layout_ok():
    """Kernel E's scratch layout as the library reports it."""
    vals = [ctypes.c_int() for _ in range(4)]
    _lib.lib().nerfsr_fused_mlp_bwd_layout(*map(ctypes.byref, vals))
    got = tuple(v.value for v in vals)
    want = (ACT_WIDTH, N_BIASES, E_SPLITS, N_WEIGHTS + N_BIASES)
    if got != want:
        raise RuntimeError(f"kernel E scratch layout {got}, expected {want}")


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
    w, wt, b = pack_bwd_params(params_flat, compute_dtype)
    for name, x in (("packed weights", w), ("transposed weights", wt)):
        _lib.check_cuda(x, name, (N_WEIGHTS,), device=dev)
    _lib.check_cuda(b, "packed biases", (N_BIASES,), device=dev)
    _layout_ok()
    acts = torch.empty((p, ACT_WIDTH), dtype=torch.float32, device=dev)
    grads = torch.empty((p, N_BIASES), dtype=torch.float32, device=dev)
    partial = torch.empty((E_SPLITS, N_WEIGHTS + N_BIASES),
                          dtype=torch.float32, device=dev)
    out = torch.empty((N_WEIGHTS + N_BIASES,), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        err = _lib.lib().nerfsr_fused_mlp_bwd(
            x0.data_ptr(), dmb.data_ptr(), grgb.data_ptr(),
            gsigma.data_ptr(), w.data_ptr(), wt.data_ptr(), b.data_ptr(),
            acts.data_ptr(), grads.data_ptr(), partial.data_ptr(),
            out.data_ptr(), p, int(compute_dtype == torch.bfloat16),
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


def embed(points: torch.Tensor, viewdirs: torch.Tensor):
    """The positional encodings kernel C takes (computed outside it)."""
    return (positional_encoding(points, DEG_POS),
            positional_encoding(viewdirs, DEG_DIR))


def fused_nerf_mlp(params_flat, points: torch.Tensor, viewdirs: torch.Tensor,
                   compute_dtype=torch.float32, plain: bool = False):
    """(rgb (P, 3), sigma (P,)) from raw points/viewdirs (P, 3): embed in
    PyTorch, then kernel C (or, with ``plain``, its plain version)."""
    x0, dmb = embed(points, viewdirs)
    fn = fused_mlp_plain if plain else fused_mlp_fwd
    return fn(params_flat, x0, dmb, compute_dtype)
