"""The refine stage's networks.

Port of ``nerfsr_tpu/models/networks.py``: ``UnetGenerator`` (the 6-down
U-Net with 4x4 stride-2 convolutions down and transposed convolutions
up, ``--learn_residual`` adding the input rgb) and ``MaxPoolingModel``
(the shared multi-scale ``VNPCATEncoder`` for the SR patch and each
reference patch, a max over the candidates at each scale, and the
``VNPCATDecoder``; ``use_ref=False`` decodes from the SR features
alone), and the GAN's ``NLayerDiscriminator`` with ``create_discriminator``
(``--dis_network``, ``--ndf_dis``, ``--patch_len``) and its spectral
normalization (``SpectralConv``, flax's ``nn.SpectralNorm``). The
modules take and return NHWC tensors, as the JAX modules do, and run
NCHW inside (an NHWC tensor permuted to NCHW is
channels-last in memory, which cuDNN takes as it is).

Normalization follows flax's rules, not torch's: ``BatchNorm`` (momentum
0.9 on the running values, which take the **biased** batch variance;
variance as E[x²] − E[x]², floored at 0) and ``instance_norm`` (flax's
``GroupNorm`` with a group per channel: no affine, eps 1e-6). Module and
parameter names are the flax paths (``down_norm_1/BatchNorm_0/scale``,
``E/conv1/kernel``), which ``nerfsr_torch/weights.py`` maps both ways.
Weights are drawn as flax's ``xavier_normal`` draws them (a normal
truncated at two deviations, scaled to variance 2 / (fan_in + fan_out)),
from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

# the deviation of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def xavier_normal_(w: torch.Tensor, fan_in: int, fan_out: int,
                   generator: torch.Generator):
    std = math.sqrt(2.0 / (fan_in + fan_out)) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
    return w


def conv(cin, cout, k, stride, padding, bias, gen):
    """A Conv2d with flax's initialization (xavier normal, zero bias)."""
    m = nn.Conv2d(cin, cout, k, stride, padding, bias=bias)
    xavier_normal_(m.weight, cin * k * k, cout * k * k, gen)
    if bias:
        nn.init.zeros_(m.bias)
    return m


def conv_transpose(cin, cout, gen, bias):
    """flax's ``ConvTranspose((4, 4), strides=(2, 2), padding="SAME")``:
    the output is twice the input's size."""
    m = nn.ConvTranspose2d(cin, cout, 4, 2, 1, bias=bias)
    xavier_normal_(m.weight, cin * 16, cout * 16, gen)
    if bias:
        nn.init.zeros_(m.bias)
    return m


class BatchNorm(nn.Module):
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW: in
    training the batch's mean and biased variance normalize, and each
    call moves the running values 0.1 of the way to them; in eval the
    running values normalize."""

    def __init__(self, channels: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x):
        if self.training:
            mean = x.mean((0, 2, 3))
            var = torch.clamp_min((x * x).mean((0, 2, 3)) - mean * mean, 0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]


def instance_norm(x, eps: float = 1e-6):
    """flax ``GroupNorm(num_groups=C, use_bias=False, use_scale=False)``
    over NCHW: each sample's channel normalized by its own statistics."""
    mean = x.mean((2, 3), keepdim=True)
    var = torch.clamp_min((x * x).mean((2, 3), keepdim=True) - mean * mean,
                          0)
    return (x - mean) * torch.rsqrt(var + eps)


class _Norm(nn.Module):
    """``--norm``: batch (flax's BatchNorm, named ``BatchNorm_0`` as flax
    names it), instance, or anything else for none."""

    def __init__(self, kind: str, channels: int):
        super().__init__()
        self.kind = kind
        if kind == "batch":
            self.BatchNorm_0 = BatchNorm(channels)

    def forward(self, x):
        if self.kind == "batch":
            return self.BatchNorm_0(x)
        if self.kind == "instance":
            return instance_norm(x)
        return x


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class UnetGenerator(nn.Module):
    """The recursive U-Net, unrolled: ``num_downs`` stride-2 convolutions
    (no norm on the outermost and innermost), transposed convolutions
    back up with the skip concatenated before each, tanh out. Biases only
    where the norm is not batch, and on the last up convolution."""

    def __init__(self, input_nc: int = 27, output_nc: int = 3,
                 ngf: int = 64, num_downs: int = 6, norm: str = "batch",
                 learn_residual: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator()
        self.num_downs, self.learn_residual = num_downs, learn_residual
        bias = norm != "batch"
        downs = [ngf, ngf * 2, ngf * 4] + [ngf * 8] * (num_downs - 3)
        cin = input_nc
        for i, feats in enumerate(downs):
            self.add_module(f"down_{i}", conv(cin, feats, 4, 2, 1, bias, gen))
            if 0 < i < len(downs) - 1:
                self.add_module(f"down_norm_{i}", _Norm(norm, feats))
            cin = feats
        ups = list(reversed(downs[:-1])) + [output_nc]
        for i, feats in enumerate(ups):
            last = i == len(ups) - 1
            self.add_module(f"up_{i}", conv_transpose(
                cin, feats, gen, bias or last))
            if not last:
                self.add_module(f"up_norm_{i}", _Norm(norm, feats))
            cin = 2 * feats
        self.n_ups = len(ups)

    def forward(self, x_nhwc):
        n = self.num_downs
        if min(x_nhwc.shape[1], x_nhwc.shape[2]) < 2 ** n:
            raise ValueError(
                f"UnetGenerator with num_downs={n} needs >= {2 ** n}px "
                f"patches, got {x_nhwc.shape[1]}x{x_nhwc.shape[2]}; lower "
                "--num_downs or raise --patch_len")
        x = _nchw(x_nhwc)
        skips = []
        h = x
        for i in range(n):
            if i > 0:
                h = F.leaky_relu(h, 0.2)
            h = getattr(self, f"down_{i}")(h)
            if 0 < i < n - 1:
                h = getattr(self, f"down_norm_{i}")(h)
            skips.append(h)
        for i in range(self.n_ups):
            h = getattr(self, f"up_{i}")(F.relu(h))
            if i < self.n_ups - 1:
                h = getattr(self, f"up_norm_{i}")(h)
                h = torch.cat([skips[n - 2 - i], h], 1)
        out = torch.tanh(h)
        if self.learn_residual:
            out = x[:, :3] + out
        return _nhwc(out)


class VNPCATEncoder(nn.Module):
    """Seven 3x3 convolutions; features at four scales: full (128
    channels), /2 (256), /4 (512) and /8 (512)."""

    _PLAN = [("conv1", 3, 128, 1), ("conv2", 128, 128, 1),
             ("conv3", 128, 256, 2), ("conv4", 256, 256, 1),
             ("conv5", 256, 512, 2), ("conv6", 512, 512, 1),
             ("conv7", 512, 512, 2)]

    def __init__(self, gen: torch.Generator):
        super().__init__()
        for name, cin, cout, stride in self._PLAN:
            self.add_module(name, conv(cin, cout, 3, stride, 1, True, gen))
            if name != "conv1":
                self.add_module("bn" + name[4:], BatchNorm(cout))

    def forward(self, x) -> List[torch.Tensor]:
        feats = []
        h = F.relu(self.conv1(x))
        for i in range(2, 8):
            h = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(h)))
            if i in (2, 4, 6, 7):
                feats.append(h)
        return feats


def upsample2x(x):
    """Nearest 2x upsampling of NCHW (each value repeated in a 2x2
    block); its backward is a plain sum, the same on every run."""
    n, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(n, c, h, 2, w, 2).reshape(
        n, c, 2 * h, 2 * w)


class VNPCATDecoder(nn.Module):
    """Fuses the SR features (and, with ``use_ref``, the max-pooled
    reference features) at four scales, coarsest first, into an rgb
    patch (tanh)."""

    def __init__(self, gen: torch.Generator, use_ref: bool = True):
        super().__init__()
        self.use_ref = use_ref
        m = 2 if use_ref else 1
        # (name, in, out): two convs a block, then the upsampling conv
        plan = [("1a", 512 * m, 512), ("1b", 512, 512), ("2up", 512, 512),
                ("3a", 512 + 512 * m, 512), ("3b", 512, 512),
                ("4up", 512, 256),
                ("5a", 256 + 256 * m, 256), ("5b", 256, 256),
                ("6up", 256, 128),
                ("7a", 128 + 128 * m, 128), ("7b", 128, 128)]
        for name, cin, cout in plan:
            self.add_module(f"conv{name}", conv(cin, cout, 3, 1, 1, True, gen))
            self.add_module(f"bn{name}", BatchNorm(cout))
        self.conv9 = conv(128, 3, 3, 1, 1, True, gen)

    def _cbr(self, name, x):
        return F.relu(getattr(self, f"bn{name}")(getattr(self, f"conv{name}")(
            x)))

    def forward(self, f_synth, f_max=None):
        def fuse(*xs, scale):
            extra = [f_max[scale]] if self.use_ref else []
            return torch.cat(list(xs) + [f_synth[scale]] + extra, 1)

        x = fuse(scale=3)
        x = self._cbr("1b", self._cbr("1a", x))
        x = self._cbr("2up", upsample2x(x))
        x = self._cbr("3b", self._cbr("3a", fuse(x, scale=2)))
        x = self._cbr("4up", upsample2x(x))
        x = self._cbr("5b", self._cbr("5a", fuse(x, scale=1)))
        x = self._cbr("6up", upsample2x(x))
        x = self._cbr("7b", self._cbr("7a", fuse(x, scale=0)))
        return torch.tanh(self.conv9(x))


class MaxPoolingModel(nn.Module):
    """SR patch (N, H, W, 3) and N·K candidate patches (N, K, H, W, 3) ->
    refined patch (N, H, W, 3). One encoder serves both: in training it
    runs on the SR patch first and on the candidates second, and each
    call moves the running statistics, in that order."""

    def __init__(self, use_ref: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator()
        self.use_ref = use_ref
        self.E = VNPCATEncoder(gen)
        self.D = VNPCATDecoder(gen, use_ref)

    def forward(self, x_synth, x_candidates=None):
        f_synth = self.E(_nchw(x_synth))
        if not self.use_ref:
            return _nhwc(self.D(f_synth))
        n, k = x_candidates.shape[:2]
        flat = x_candidates.reshape((n * k,) + x_candidates.shape[2:])
        f_max = [f.reshape((n, k) + f.shape[1:]).amax(1)
                 for f in self.E(_nchw(flat))]
        return _nhwc(self.D(f_synth, f_max))


# ---------------------------------------------------------------------------
# the GAN discriminator
# ---------------------------------------------------------------------------

def _l2_normalize(x, eps: float):
    """flax's ``_l2_normalize``: ``x * rsqrt(sum(x^2) + eps)``."""
    return x * torch.rsqrt((x * x).sum() + eps)


class SpectralConv(nn.Module):
    """A bias-free convolution whose kernel is divided by its largest
    singular value, estimated as flax's ``nn.SpectralNorm`` estimates it
    (one power-iteration step, eps 1e-12): the kernel, HWIO reshaped to
    (kh*kw*cin, cout), and the stored ``u`` (1, cout) give
    ``v = normalize(u W^T)``, ``u' = normalize(v W)`` (both without
    gradient) and ``sigma = v W u'^T``, which keeps its gradient with
    respect to W; the kernel is divided by sigma where sigma != 0. Every
    call starts from the stored ``u``; ``refresh_stats`` writes the
    refined ``u'`` and its sigma back, as flax does on a call with
    ``update_stats=True``. ``torch.nn.utils.parametrizations.spectral_norm``
    iterates and stores on every training call and normalizes by
    ``max(|x|, eps)``, so it is not used."""

    def __init__(self, cin, cout, stride, padding, gen, eps: float = 1e-12):
        super().__init__()
        self.stride, self.padding, self.eps = stride, padding, eps
        self.weight = conv(cin, cout, 4, stride, padding, False, gen).weight
        self.register_buffer("u", torch.randn((1, cout), generator=gen))
        self.register_buffer("sigma", torch.ones(()))

    def _power_iteration(self):
        """(u', sigma) from the stored u and the current kernel."""
        w = self.weight.permute(2, 3, 1, 0).reshape(-1, self.weight.shape[0])
        with torch.no_grad():
            v = _l2_normalize(self.u @ w.T, self.eps)
            u = _l2_normalize(v @ w, self.eps)
        sigma = ((v @ w) @ u.T)[0, 0]
        return u, sigma

    @torch.no_grad()
    def refresh_stats(self):
        u, sigma = self._power_iteration()
        self.u.copy_(u)
        self.sigma.copy_(sigma)

    def forward(self, x):
        _, sigma = self._power_iteration()
        w = self.weight / torch.where(sigma != 0, sigma,
                                      torch.ones_like(sigma))
        return F.conv2d(x, w, stride=self.stride, padding=self.padding)


class NLayerDiscriminator(nn.Module):
    """The spectral-norm patch discriminator for 32 or 64 px NHWC
    patches: 4x4 stride-2 convolutions (``c0`` only at 64) widening
    ``ndf`` -> 2, 4, 8 ndf, instance norm (flax's, eps 1e-6) after ``c1``
    to ``c3``, leaky relu 0.2, and a 4x4 valid convolution ``c4`` to one
    logit: (N, P, P, 3) -> (N, 1, 1, 1). The parameter and statistics
    names are flax's (``c1/kernel``, ``SpectralNorm_0/c1/kernel/u``), which
    ``nerfsr_torch/weights.py`` maps both ways."""

    def __init__(self, ndf: int = 64, patch_len: int = 64,
                 input_nc: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if patch_len not in (32, 64):
            raise ValueError(f"--patch_len {patch_len}: the discriminator "
                             "takes 32 or 64")
        gen = generator or torch.Generator().manual_seed(0)
        self.patch_len = patch_len
        cin = input_nc
        if patch_len == 64:
            self.c0 = SpectralConv(cin, ndf, 2, 1, gen)
            cin = ndf
        self.c1 = SpectralConv(cin, ndf * 2, 2, 1, gen)
        self.c2 = SpectralConv(ndf * 2, ndf * 4, 2, 1, gen)
        self.c3 = SpectralConv(ndf * 4, ndf * 8, 2, 1, gen)
        self.c4 = SpectralConv(ndf * 8, 1, 1, 0, gen)

    def spectral_convs(self):
        """(name, SpectralConv) in the order flax numbers them."""
        return [(n, m) for n, m in self.named_children()
                if isinstance(m, SpectralConv)]

    def refresh_stats(self):
        """Refine every layer's stored ``u`` and sigma by one power
        iteration (flax's ``update_stats=True``; the call's output is not
        needed for it)."""
        for _, m in self.spectral_convs():
            m.refresh_stats()

    def forward(self, x_nhwc):
        h = _nchw(x_nhwc)
        if self.patch_len == 64:
            h = F.leaky_relu(self.c0(h), 0.2)
        for c in (self.c1, self.c2, self.c3):
            h = F.leaky_relu(instance_norm(c(h)), 0.2)
        return _nhwc(self.c4(h))


@dataclasses.dataclass
class GanState:
    """A discriminator (its parameters and spectral-norm statistics) and
    its Adam (``--gan_lr``, b1 ``--beta1``, b2 0.999, no clip, a constant
    learning rate: optax's ``adam``). It is not checkpointed, as in the
    JAX package: a resumed run starts D afresh."""

    net: nn.Module
    optimizer: torch.optim.Optimizer


def create_discriminator(opt, generator=None) -> NLayerDiscriminator:
    """``--dis_network`` (only ``nlayerdiscriminator``) at ``--ndf_dis``
    for ``--patch_len`` patches."""
    if opt.dis_network != "nlayerdiscriminator":
        raise KeyError(f"unknown dis_network '{opt.dis_network}' "
                       "(available: nlayerdiscriminator)")
    return NLayerDiscriminator(ndf=opt.ndf_dis, patch_len=opt.patch_len,
                               generator=generator)
