"""Losses and metrics of the training path.

Port of ``nerfsr_tpu/models/criterions.py``: ``psnr``, ``_outer_mass`` and
``interlevel_loss`` (the proposal histogram bound of ``--fast_sampling``),
``ssim``, the refine stage's ``l1``, ``image_gradients`` and
``gradient_loss`` (NHWC images), and the auxiliary training paths'
losses: ``tv_loss`` (``--reg_patch``), ``laplacian_loss`` and
``bilateral_laplacian_loss`` (patch mode's depth smoothness), ``gan_loss``
in its three modes with ``wgan_gradient_penalty`` (``--with_netD``), and
``VGGPerceptualLoss`` (patch mode, ``--refine_with_vgg``) with
``write_synthetic_vgg_npz``.
The JAX package counts histogram edges by an all-pairs comparison; on
sorted edges that count is ``torch.searchsorted`` (``right=True`` for
``<=``, ``right=False`` for ``<``), which gives the same indices at ties.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from nerfsr_torch.parallel import mesh


def psnr(pred, target, valid_mask=None):
    """-10 log10(mse). Inside a step's split of the rows
    (``parallel/mesh.py``) it is this rank's share of the world's mse,
    which the step's ``reduce_losses`` sums and turns into the PSNR."""
    err = (pred - target) ** 2
    if valid_mask is not None:
        err = err[valid_mask]
    if mesh.share() is not None:
        return mesh.mse_share(torch.mean(err))
    return -10.0 * torch.log10(torch.mean(err))


def l1(pred, target):
    """Mean absolute error."""
    return torch.mean(torch.abs(pred - target))


def image_gradients(img):
    """Forward differences of (N, H, W, C) images, zero-padded at the far
    edge: (dy, dx), each of the image's shape."""
    dy = img[:, 1:] - img[:, :-1]
    dx = img[:, :, 1:] - img[:, :, :-1]
    dy = torch.cat([dy, torch.zeros_like(img[:, :1])], 1)
    dx = torch.cat([dx, torch.zeros_like(img[:, :, :1])], 2)
    return dy, dx


def gradient_loss(pred, target):
    """Mean L1 between the images' gradients, x and y terms summed and
    halved."""
    pdy, pdx = image_gradients(pred)
    tdy, tdx = image_gradients(target)
    return (torch.mean(torch.abs(pdx - tdx))
            + torch.mean(torch.abs(pdy - tdy))) / 2


def _outer_mass(t_q, t_env, w_env):
    """Upper bound on the env histogram's mass inside each query
    interval: env-CDF(smallest env edge >= hi) - env-CDF(largest env edge
    <= lo). Sorted edges t_q (N, S+1) / t_env (N, P+1), env bin weights
    w_env (N, P) -> (N, S)."""
    cw = torch.cat([torch.zeros_like(w_env[..., :1]),
                    torch.cumsum(w_env, -1)], -1)
    n_edges = cw.shape[-1]
    t_env, t_q = t_env.contiguous(), t_q.contiguous()
    # floor index #{j : t_env[j] <= x} - 1, ceil index #{j : t_env[j] < x}
    le = torch.searchsorted(t_env, t_q, right=True) - 1
    lt = torch.searchsorted(t_env, t_q, right=False)
    idx_lo = torch.clamp(le[..., :-1], 0, n_edges - 1)
    idx_hi = torch.clamp(lt[..., 1:], 0, n_edges - 1)
    mass = torch.gather(cw, -1, idx_hi) - torch.gather(cw, -1, idx_lo)
    # maximum, not clamp: both split the gradient at a tie, as JAX does
    return torch.maximum(mass, torch.zeros_like(mass))


def interlevel_loss(z_fine, w_fine, z_prop, w_prop, eps: float = 1e-6):
    """Penalize the proposal histogram wherever it fails to upper-bound
    the fine histogram (mip-NeRF 360's lossfun_outer). Sample depths are
    bin edges; each histogram's terminal (1e10-interval) weight is
    dropped. The fine weights are detached: only the proposal learns from
    this term."""
    w_f = w_fine[..., :-1].detach()
    w_outer = _outer_mass(z_fine, z_prop, w_prop[..., :-1])
    d = w_f - w_outer
    return mesh.row_mean(torch.maximum(d, torch.zeros_like(d)) ** 2
                         / (w_f + eps))


def _gaussian_kernel(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def _blur_valid(x: torch.Tensor, kernel: torch.Tensor, dim: int):
    """'VALID' correlation of ``x`` with ``kernel`` along ``dim``, as f32
    multiply-adds of shifted slices (no convolution library, so no
    reduced-precision math on any device)."""
    n = x.shape[dim] - kernel.shape[0] + 1
    out = x.narrow(dim, 0, n) * kernel[0]
    for k in range(1, kernel.shape[0]):
        out = out + x.narrow(dim, k, n) * kernel[k]
    return out


def ssim(img0, img1, max_val: float = 1.0, filter_size: int = 11,
         filter_sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03,
         return_map: bool = False):
    """Gaussian-window SSIM (Wang et al.) over (H, W, C) or (N, H, W, C)
    images: an 11-tap separable Gaussian of sigma 1.5, 'VALID' borders,
    in f32 on the images' device. A window wider than the image shrinks
    to it, as the JAX package's does."""
    img0 = torch.as_tensor(img0).float()
    img1 = torch.as_tensor(img1).float()
    if img0.ndim == 3:
        img0, img1 = img0[None], img1[None]
    filter_size = min(filter_size, img0.shape[1], img0.shape[2])
    kernel = _gaussian_kernel(filter_size, filter_sigma, img0.device)

    def blur(x):
        return _blur_valid(_blur_valid(x, kernel, 1), kernel, 2)

    mu0, mu1 = blur(img0), blur(img1)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    s00 = blur(img0 * img0) - mu00
    s11 = blur(img1 * img1) - mu11
    s01 = blur(img0 * img1) - mu01
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu01 + c1) * (2 * s01 + c2)
    denom = (mu00 + mu11 + c1) * (s00 + s11 + c2)
    ssim_map = numer / denom
    return ssim_map if return_map else torch.mean(ssim_map)


# ---------------------------------------------------------------------------
# spatial regularizers (NHWC / NHW inputs)
# ---------------------------------------------------------------------------

def tv_loss(x, weight: float = 1.0):
    """Total variation of (N, H, W, C): the mean squared forward
    differences along h and along w, summed, doubled and divided by N."""
    n, h, w, c = x.shape
    count_h = (h - 1) * w * c
    count_w = h * (w - 1) * c
    h_tv = torch.sum((x[:, 1:] - x[:, :-1]) ** 2)
    w_tv = torch.sum((x[:, :, 1:] - x[:, :, :-1]) ** 2)
    return weight * 2 * (h_tv / count_h + w_tv / count_w) / n


def _second_differences(d):
    """Second differences of (N, H, W[, C]) on the interior: horizontal,
    vertical and the two diagonals."""
    l1_ = d[:, :, :-2] + d[:, :, 2:] - 2.0 * d[:, :, 1:-1]
    l2_ = d[:, :-2, :] + d[:, 2:, :] - 2.0 * d[:, 1:-1, :]
    l3_ = d[:, :-2, :-2] + d[:, 2:, 2:] - 2.0 * d[:, 1:-1, 1:-1]
    l4_ = d[:, 2:, :-2] + d[:, :-2, 2:] - 2.0 * d[:, 1:-1, 1:-1]
    return l1_, l2_, l3_, l4_


def laplacian_loss(depth):
    """Mean absolute second difference of (N, H, W) depths, the four
    directions averaged."""
    return sum(torch.mean(torch.abs(t))
               for t in _second_differences(depth)) / 4.0


def bilateral_laplacian_loss(depth, rgb, gamma: float = 0.1):
    """Edge-aware depth smoothness: each direction's depth second
    difference weighted by ``exp(-|second difference of rgb|`` summed over
    the channels ``/ gamma)`` on the same stencil. depth (N, H, W), rgb
    (N, H, W, 3)."""
    loss = 0.0
    for lap_d, lap_c in zip(_second_differences(depth),
                            _second_differences(rgb)):
        w = torch.exp(-torch.abs(lap_c).sum(-1) / gamma)
        loss = loss + torch.mean(torch.abs(w * lap_d))
    return loss / 4.0


# ---------------------------------------------------------------------------
# GAN objectives
# ---------------------------------------------------------------------------

def sigmoid_bce(logits, labels):
    """Binary cross-entropy of sigmoid(logits) against labels, from
    ``log_sigmoid`` (optax's ``sigmoid_binary_cross_entropy``)."""
    return -(labels * F.logsigmoid(logits)
             + (1.0 - labels) * F.logsigmoid(-logits))


def gan_loss(logits, target_is_real: bool, mode: str = "vanilla"):
    """The GAN objective on discriminator logits: ``vanilla`` (sigmoid
    cross-entropy against the real/fake label), ``lsgan`` (squared error
    against 1/0) or ``wgangp`` (-mean for real, +mean for fake)."""
    if mode == "vanilla":
        label = torch.ones_like(logits) if target_is_real \
            else torch.zeros_like(logits)
        return torch.mean(sigmoid_bce(logits, label))
    if mode == "lsgan":
        target = 1.0 if target_is_real else 0.0
        return torch.mean((logits - target) ** 2)
    if mode == "wgangp":
        return -torch.mean(logits) if target_is_real else torch.mean(logits)
    raise ValueError(f"unknown gan mode {mode}")


def wgan_gradient_penalty(d_apply, real, fake, eps, lam: float = 10.0):
    """The WGAN-GP penalty: ``lam`` times the mean of (|grad D| - 1)^2 on
    the interpolates ``eps * real + (1 - eps) * fake``, ``eps`` a uniform
    draw per sample (shape (N, 1, 1, 1)). The gradient is taken with
    ``create_graph=True``, so the penalty's own gradient reaches D's
    parameters (a double backward)."""
    inter = eps * real + (1 - eps) * fake
    if not inter.requires_grad:
        inter = inter.detach().requires_grad_(True)
    grads, = torch.autograd.grad(d_apply(inter).sum(), inter,
                                 create_graph=True)
    norms = torch.sqrt(torch.sum(grads ** 2, dim=tuple(range(1, real.ndim)))
                       + 1e-12)
    return lam * torch.mean((norms - 1.0) ** 2)


# ---------------------------------------------------------------------------
# VGG perceptual loss
# ---------------------------------------------------------------------------

# relu outputs at torchvision VGG19 feature indices {3, 8, 13, 22, 31}
# weighted {1, .75, .5, .5, 1}
VGG_TAP_WEIGHTS = (1.0, 0.75, 0.5, 0.5, 1.0)
# the VGG19 plan up to the last tap: convs' output channels, "M" pools
_VGG19_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512)
# the convolutions consumed at each tap (relu1_2 ... relu5_2)
_TAP_LAYER_COUNTS = (2, 4, 6, 10, 14)
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def write_synthetic_vgg_npz(path, seed: int = 0):
    """Write a VGG19-shaped archive of random weights (the keys and shapes
    of a converted torchvision VGG19: ``w{i}`` HWIO and ``b{i}`` for the
    first 14 convolutions), He-scaled, from a numpy seed; the same bytes
    as the JAX package's writer. For running the perceptual loss where no
    trained weights are at hand: random convolution features still give
    a multi-scale distance that is zero only where the patches match, not
    a perceptually calibrated one."""
    rng = np.random.RandomState(seed)
    arrays = {}
    cin = 3
    for i, cout in enumerate(c for c in _VGG19_CFG if c != "M"):
        fan_in = 3 * 3 * cin
        arrays[f"w{i}"] = (rng.randn(3, 3, cin, cout)
                           * np.sqrt(2.0 / fan_in)).astype(np.float32)
        arrays[f"b{i}"] = np.zeros((cout,), np.float32)
        cin = cout
    np.savez(path, **arrays)
    return path


class VGGPerceptualLoss:
    """VGG19-feature L1 perceptual loss of NHWC images in (-1, 1): the
    mean absolute difference of five relu taps, weighted by
    ``VGG_TAP_WEIGHTS``; the target's features carry no gradient.

    The weights load at first use from ``weights_path``, an ``.npz`` of
    ``w{i}`` (HWIO) and ``b{i}`` (a converted VGG19, or
    ``write_synthetic_vgg_npz``'s); without one the loss raises, as the
    reference needs its pretrained weights. They go to the images' device
    as OIHW convolution weights (cuDNN on the card)."""

    def __init__(self, weights_path=None):
        self.weights_path = weights_path
        self._params = None
        self._norm = None

    def _load(self, device):
        """The convolutions' (weight, bias) and the ImageNet mean and
        deviation on ``device``, moved there once (no host copy inside a
        captured step)."""
        if self._params is None or self._params[0][0].device != device:
            if not self.weights_path:
                raise FileNotFoundError(
                    "VGG weights archive required (--vgg_weights): a "
                    "converted VGG19 .npz, or write_synthetic_vgg_npz's")
            z = np.load(self.weights_path)
            self._params = [
                (torch.from_numpy(np.ascontiguousarray(
                    z[f"w{i}"].transpose(3, 2, 0, 1))).float().to(device),
                 torch.from_numpy(np.asarray(z[f"b{i}"])).float().to(device))
                for i in range(len(z.files) // 2)]
            self._norm = tuple(torch.tensor(v, device=device)
                               for v in (_IMAGENET_MEAN, _IMAGENET_STD))
        return self._params

    def features(self, x):
        """(N, H, W, 3) in (-1, 1) -> the five tap features (NCHW)."""
        params = self._load(x.device)
        mean, std = self._norm
        x = ((x + 1.0) / 2.0 - mean) / std
        x = x.permute(0, 3, 1, 2)
        taps, conv_i = [], 0
        for spec in _VGG19_CFG:
            if spec == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            w, b = params[conv_i]
            x = F.relu(F.conv2d(x, w, b, padding=1))
            conv_i += 1
            if conv_i in _TAP_LAYER_COUNTS:
                taps.append(x)
                if len(taps) == len(_TAP_LAYER_COUNTS):
                    break
        return taps

    def __call__(self, pred, target):
        f_pred = self.features(pred)
        f_tgt = self.features(target.detach())
        loss = 0.0
        for w, a, b in zip(VGG_TAP_WEIGHTS, f_pred, f_tgt):
            loss = loss + w * torch.mean(torch.abs(a - b))
        return loss
