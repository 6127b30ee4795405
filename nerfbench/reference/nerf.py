"""The plain reference of NeRF-SR x2: rays, sampling, the MLPs,
compositing, the losses and Adam, in float32 PyTorch.

It follows NeRF (arXiv:2003.08934), NeRF-SR (arXiv:2112.01759) and the
proposal sampling of mip-NeRF 360 (arXiv:2111.12077) as the configuration
files under ``nerfbench/configs`` state them, with the conventions of
the system under test where the papers leave a choice open: the channel
order of the positional encoding, the 1e10 terminal interval, the 1e-10
in the transmittance, the 1e-5 added to the weights before the inverse
CDF, the stratified uniforms of the proposal rounds, the interlevel
loss's outer mass. It imports nothing of the system under test, no JAX
and no kernel, and takes nothing the system made: the benchmark hands it
the same poses, images and weights it hands the system, and it works out
the rays, the LR targets, the samples and everything after them itself.

The random draws of a training step (the batch rows, the stratified
jitter, the density noise) come from a ``torch.Generator`` seeded as the
system seeds its chunk, drawn in the order the system draws them, so
both sides sample the same rows and depths; that order is part of what
this file holds the system to.

``precision`` picks how every MLP product is computed: ``f32`` (TF32
off: ``strict_f32``), or a control, which rounds both operands of each
product (and of each backward product) and accumulates in f32: ``fp8``
to float8 e4m3 with a per-tensor scale, the step below a configuration's
bf16, or ``bf16``, the step below a configuration's float32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def strict_f32():
    """f32 products in f32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale (amax to 448),
    back in f32."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    s = amax / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (to nearest, ties to even), back in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


# each control's rounding of a product's operands
ROUNDING = {"fp8": _fp8, "bf16": bf16}


class _RoundedLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, rnd):
        xq, wq = rnd(x), rnd(w)
        ctx.save_for_backward(xq, wq)
        ctx.rnd = rnd
        return xq @ wq.T + b

    @staticmethod
    def backward(ctx, gy):
        xq, wq = ctx.saved_tensors
        gq = ctx.rnd(gy)
        return gq @ wq, gq.reshape(-1, gq.shape[-1]).T @ xq.reshape(
            -1, xq.shape[-1]), gy.reshape(-1, gy.shape[-1]).sum(0), None


def linear(x, w, b, precision: str):
    if precision == "f32":
        return F.linear(x, w, b)
    if precision in ROUNDING:
        shape = x.shape[:-1]
        return _RoundedLinear.apply(x.reshape(-1, x.shape[-1]), w, b,
                                    ROUNDING[precision]).reshape(
                                        shape + (w.shape[0],))
    raise ValueError(f"unknown precision {precision}")


# ---------------------------------------------------------------------
# rays
# ---------------------------------------------------------------------

def camera_dirs(h: int, w: int, focal: float, device) -> torch.Tensor:
    """(h, w, 3) camera-space directions through the pixel centres, -z
    forward, y up."""
    i = torch.arange(w, dtype=torch.float32, device=device) + 0.5
    j = torch.arange(h, dtype=torch.float32, device=device) + 0.5
    jj, ii = torch.meshgrid(j, i, indexing="ij")
    return torch.stack([(ii - w / 2) / focal, -(jj - h / 2) / focal,
                        -torch.ones_like(ii)], -1)


def world_rays(dirs: torch.Tensor, c2w: torch.Tensor):
    d = dirs @ c2w[:, :3].T
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return c2w[:, 3].expand(d.shape), d


def ndc(h: int, w: int, focal: float, o: torch.Tensor, d: torch.Tensor,
        near: float = 1.0):
    """Forward-facing rays into normalized device coordinates, the near
    plane at ``near`` (NeRF's appendix C)."""
    t = -(near + o[..., 2]) / d[..., 2]
    o = o + t[..., None] * d
    ax, ay = -2.0 * focal / w, -2.0 * focal / h
    o0, o1 = ax * o[..., 0] / o[..., 2], ay * o[..., 1] / o[..., 2]
    o2 = 1.0 + 2.0 * near / o[..., 2]
    d0 = ax * (d[..., 0] / d[..., 2] - o[..., 0] / o[..., 2])
    d1 = ay * (d[..., 1] / d[..., 2] - o[..., 1] / o[..., 2])
    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, -2.0 * near
                                                       / o[..., 2]], -1)


def view_rays(c2w: torch.Tensor, h: int, w: int, focal: float):
    """(h, w, 3) NDC origins and directions of one view."""
    o, d = world_rays(camera_dirs(h, w, focal, c2w.device), c2w)
    return ndc(h, w, focal, o, d)


# ---------------------------------------------------------------------
# the networks
# ---------------------------------------------------------------------

def posenc(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(n-1) x), cos(2^(n-1) x)],
    each term over the 3 channels."""
    out = [x]
    for k in range(n_freqs):
        out += [torch.sin(x * 2.0 ** k), torch.cos(x * 2.0 ** k)]
    return torch.cat(out, -1)


def nerf_mlp(wts: Dict[str, torch.Tensor], net: str, pts, viewdirs, arch,
             precision: str):
    """The D-layer NeRF MLP of ``net``: (rgb (..., 3) after the sigmoid,
    raw sigma (...))."""
    def lin(name, x):
        return linear(x, wts[f"{net}.{name}.weight"],
                      wts[f"{net}.{name}.bias"], precision)
    inp = posenc(pts, arch["deg_pos"])
    x = inp
    for i in range(arch["D"]):
        if i in arch["skips"] and i > 0:
            x = torch.cat([inp, x], -1)
        x = torch.relu(lin(f"xyz_encoding_{i + 1}", x))
    sigma = lin("sigma", x)[..., 0]
    vd = viewdirs[:, None, :].expand(pts.shape)
    feat = torch.cat([lin("xyz_encoding_final", x),
                      posenc(vd, arch["deg_dir"])], -1)
    rgb = torch.sigmoid(lin("rgb", torch.relu(lin("dir_encoding", feat))))
    return rgb, sigma


def proposal_mlp(wts, pts, arch, precision: str):
    """The density-only proposal MLP: raw sigma (...)."""
    x = posenc(pts, arch["deg_prop"])
    for i in range(arch["prop_D"]):
        x = torch.relu(linear(x, wts[f"prop.layer_{i}.weight"],
                              wts[f"prop.layer_{i}.bias"], precision))
    return linear(x, wts["prop.sigma.weight"], wts["prop.sigma.bias"],
                  precision)[..., 0]


# ---------------------------------------------------------------------
# sampling and compositing
# ---------------------------------------------------------------------

def stratified(o, d, near, far, n: int, u: Optional[torch.Tensor]):
    """n depths from near to far, each jittered inside its cell by ``u``
    (none: the cell edges' linspace)."""
    t = torch.linspace(0.0, 1.0, n, device=o.device)
    z = near * (1.0 - t) + far * t
    z = z.expand(o.shape[0], n)
    if u is not None:
        mids = 0.5 * (z[:, 1:] + z[:, :-1])
        upper = torch.cat([mids, z[:, -1:]], -1)
        lower = torch.cat([z[:, :1], mids], -1)
        z = lower + u * (upper - lower)
    return z


def points(o, d, z):
    return o[:, None, :] + z[..., None] * d[:, None, :]


def invert_cdf(bins, weights, u, eps: float = 1e-5):
    """Depths at the quantiles ``u`` of the piecewise-constant density
    ``weights`` (+ eps) over the edges ``bins``."""
    w = weights + eps
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)
    i = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    lo = torch.clamp(i - 1, min=0)
    hi = torch.clamp(i, max=bins.shape[-1] - 1)
    c_lo, c_hi = cdf.gather(-1, lo), cdf.gather(-1, hi)
    b_lo, b_hi = bins.gather(-1, lo), bins.gather(-1, hi)
    den = c_hi - c_lo
    den = torch.where(den < eps, torch.ones_like(den), den)
    return b_lo + (u - c_lo) / den * (b_hi - b_lo)


def weights_of(sigma, z):
    """Compositing weights: alpha from relu(sigma) over the intervals
    (the last 1e10 long), times the transmittance."""
    delta = torch.cat([z[:, 1:] - z[:, :-1],
                       torch.full_like(z[:, :1], 1e10)], -1)
    alpha = 1.0 - torch.exp(-delta * torch.relu(sigma))
    trans = torch.cumprod(1.0 - alpha[:, :-1] + 1e-10, -1)
    return alpha * torch.cat([torch.ones_like(alpha[:, :1]), trans], -1)


def composite(rgb, sigma, z):
    w = weights_of(sigma, z)
    return (w[..., None] * rgb).sum(-2), w


def outer_mass(t_q, t_env, w_env):
    cw = torch.cat([torch.zeros_like(w_env[:, :1]), torch.cumsum(w_env, -1)],
                   -1)
    n = cw.shape[-1]
    t_env, t_q = t_env.contiguous(), t_q.contiguous()
    lo = torch.clamp(torch.searchsorted(t_env, t_q, right=True)[:, :-1] - 1,
                     0, n - 1)
    hi = torch.clamp(torch.searchsorted(t_env, t_q, right=False)[:, 1:], 0,
                     n - 1)
    mass = cw.gather(-1, hi) - cw.gather(-1, lo)
    return torch.maximum(mass, torch.zeros_like(mass))


def interlevel(z_f, w_f, z_p, w_p, eps: float = 1e-6):
    """mip-NeRF 360's proposal loss: the fine histogram above the
    proposal's outer mass, squared, over the fine weight."""
    wf = w_f[:, :-1].detach()
    d = wf - outer_mass(z_f, z_p, w_p[:, :-1])
    return torch.mean(torch.clamp_min(d, 0.0) ** 2 / (wf + eps))


# ---------------------------------------------------------------------
# the render of a ray batch
# ---------------------------------------------------------------------

def render(wts, o, d, arch, precision: str, gen=None, pad: float = 0.0,
           noise_std: float = 0.0):
    """Render rays (N, 3) in NDC (near 0, far 1). ``gen`` draws the
    training step's jitter and noise in the system's order; without it
    the render is the deterministic eval render. Returns (rgb (N, 3), the
    parts the losses read)."""
    n = o.shape[0]

    def rand(k):
        return None if gen is None else torch.rand(
            (n, k), generator=gen, device=o.device)

    def noisy(sigma):
        if gen is None or noise_std <= 0:
            return sigma
        return sigma + torch.randn(sigma.shape, generator=gen,
                                   device=o.device) * noise_std

    def strat_u(k):
        j = rand(k)
        if j is None:
            j = torch.full((n, k), 0.5, device=o.device)
        return (torch.arange(k, device=o.device) + j) / k

    out = {}
    if arch["fast_sampling"]:
        z = stratified(o, d, 0.0, 1.0, arch["n_prop"], rand(arch["n_prop"]))
        hists = []
        for lvl in range(arch["n_prop_levels"]):
            if lvl > 0:
                zp, wp = hists[-1]
                z = invert_cdf(0.5 * (zp[:, :-1] + zp[:, 1:]),
                               wp[:, 1:-1].detach() + pad,
                               strat_u(arch["n_prop2"]))
            w = weights_of(proposal_mlp(wts, points(o, d, z), arch,
                                        precision), z)
            hists.append((z, w))
        zp, wp = hists[-1]
        z = invert_cdf(0.5 * (zp[:, :-1] + zp[:, 1:]),
                       wp[:, 1:-1].detach()
                       + (pad if arch["n_prop_levels"] > 1 else 0.0),
                       strat_u(arch["N_importance"]))
        rgb, sigma = nerf_mlp(wts, "fine", points(o, d, z), d, arch,
                              precision)
        out["rgb"], out["w"] = composite(rgb, noisy(sigma), z)
        out["z"], out["hists"] = z, hists
        return out["rgb"], out
    z = stratified(o, d, 0.0, 1.0, arch["N_coarse"], rand(arch["N_coarse"]))
    rgb, sigma = nerf_mlp(wts, "coarse", points(o, d, z), d, arch, precision)
    out["coarse_rgb"], w = composite(rgb, noisy(sigma), z)
    u = rand(arch["N_importance"])
    if u is None:
        u = torch.linspace(0.0, 1.0, arch["N_importance"],
                           device=o.device).expand(n, -1)
    z_new = invert_cdf(0.5 * (z[:, :-1] + z[:, 1:]), w[:, 1:-1].detach(), u)
    z, _ = torch.sort(torch.cat([z, z_new], -1), -1)
    rgb, sigma = nerf_mlp(wts, "fine", points(o, d, z), d, arch, precision)
    out["rgb"], out["w"] = composite(rgb, noisy(sigma), z)
    return out["rgb"], out


@torch.no_grad()
def render_view(wts, c2w, arch, hw, focal, precision: str,
                chunk: int = 4096) -> torch.Tensor:
    """One eval image (h, w, 3) uint8 in scan order: the render clipped to
    [0, 1], times 255, truncated."""
    h, w = hw
    o, d = view_rays(c2w, h, w, focal)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    rgb = torch.cat([render(wts, o[s:s + chunk], d[s:s + chunk], arch,
                            precision)[0] for s in range(0, len(o), chunk)])
    return (rgb.clamp(0.0, 1.0) * 255).to(torch.uint8).reshape(h, w, 3)


# ---------------------------------------------------------------------
# training
# ---------------------------------------------------------------------

def annealed_pad(arch, step: int, steps_per_epoch: int) -> float:
    """The resample padding at ``step``: prop_pad annealed linearly to
    prop_pad_final over prop_pad_anneal_frac of the whole schedule."""
    frac = arch.get("prop_pad_anneal_frac", 0.0)
    if not arch["fast_sampling"]:
        return 0.0
    if frac <= 0:
        return arch["prop_pad"]
    total = max(1, int(frac * (steps_per_epoch * max(1, arch["n_epochs"]))))
    f = min(max(step / total, 0.0), 1.0)
    return float(torch.tensor(arch["prop_pad"] + (arch["prop_pad_final"]
                                                  - arch["prop_pad"]) * f,
                              dtype=torch.float64).float())


class TrainData:
    """The training rows as the system's buffer orders them: view by view,
    LR pixels in scan order, each with its ds^2 HR sub-rays (row-major in
    the block); the LR target by PIL's Lanczos of the HR image."""

    def __init__(self, poses, images_u8, lr_u8, focal: float, ds: int,
                 device):
        self.poses = torch.as_tensor(poses, dtype=torch.float32,
                                     device=device)
        self.lr = torch.as_tensor(lr_u8, device=device).float() / 255.0
        self.n, self.h, self.w = images_u8.shape[:3]
        self.focal, self.ds = focal, ds
        self.hl, self.wl = self.h // ds, self.w // ds

    def rows(self, idx: torch.Tensor):
        """(origins, directions (B * ds^2, 3) NDC, LR targets (B, 3))."""
        ds = self.ds
        v = idx // (self.hl * self.wl)
        p = idx % (self.hl * self.wl)
        r, c = p // self.wl, p % self.wl
        s = torch.arange(ds * ds, device=idx.device)
        hr_r = (r[:, None] * ds + s // ds).reshape(-1)
        hr_c = (c[:, None] * ds + s % ds).reshape(-1)
        dirs = torch.stack([(hr_c + 0.5 - self.w / 2) / self.focal,
                            -(hr_r + 0.5 - self.h / 2) / self.focal,
                            -torch.ones_like(hr_r, dtype=torch.float32)], -1)
        c2w = self.poses[v.repeat_interleave(ds * ds)]
        dw = torch.einsum("nk,njk->nj", dirs, c2w[:, :, :3])
        dw = dw / torch.linalg.norm(dw, dim=-1, keepdim=True)
        o, d = ndc(self.h, self.w, self.focal, c2w[:, :, 3], dw)
        return o, d, self.lr[v, r, c]

    def __len__(self):
        return self.n * self.hl * self.wl


def step_loss(wts, data: TrainData, arch, gen, batch: int, pad: float,
              precision: str):
    """One step's batch (drawn from ``gen``) rendered; the total loss:
    the LR mse of the sub-pixel mean (coarse and fine on parity), plus
    the interlevel loss of every proposal round (fast)."""
    idx = torch.randint(0, len(data), (batch,), generator=gen,
                        device=data.poses.device)
    o, d, target = data.rows(idx)
    rgb, out = render(wts, o, d, arch, precision, gen, pad,
                      arch["noise_std"])
    ds2 = data.ds * data.ds

    def lr_mse(x):
        return torch.mean((x.reshape(-1, ds2, 3).mean(1) - target) ** 2)
    loss = lr_mse(rgb)
    if "coarse_rgb" in out:
        loss = loss + lr_mse(out["coarse_rgb"])
    for zp, wp in out.get("hists", ()):
        loss = loss + interlevel(out["z"], out["w"], zp, wp)
    return loss


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected) over a dict of
    f32 leaves."""

    def __init__(self, wts, lr: float, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in wts.items()}
        self.v = {k: torch.zeros_like(v) for k, v in wts.items()}
        self.t = 0
        self.grads = []

    @torch.no_grad()
    def step(self, wts, grads):
        self.grads.append({k: g.detach().clone() for k, g in grads.items()})
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = math.sqrt(1.0 - self.b2 ** self.t)
        for k, g in grads.items():
            self.m[k].lerp_(g, 1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            wts[k].sub_(self.lr / c1 * self.m[k]
                        / (self.v[k].sqrt() / c2 + self.eps))


def train_steps(wts, data: TrainData, arch, seeds, batch: int,
                steps_per_epoch: int, lr: float, precision: str = "f32"):
    """Follow the system's first steps: step i draws from a generator
    seeded with ``seeds[i]``. Returns (the losses, each step's gradient
    by leaf as the optimizer got it, the leaves after the last step)."""
    wts = {k: v.detach().clone() for k, v in wts.items()}
    opt = Adam(wts, lr)
    losses = []
    for step, seed in enumerate(seeds):
        gen = torch.Generator(device=data.poses.device).manual_seed(seed)
        leaves = {k: v.detach().requires_grad_(True) for k, v in wts.items()}
        loss = step_loss(leaves, data, arch, gen, batch,
                         annealed_pad(arch, step, steps_per_epoch), precision)
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        opt.step(wts, grads)
        losses.append(float(loss.detach()))
    return losses, opt.grads, wts
