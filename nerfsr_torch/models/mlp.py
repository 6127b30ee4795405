"""The NeRF MLPs as ``nn.Module``s.

Port of ``nerfsr_tpu/models/mlp.py`` (``VanillaMLP``, ``ProposalMLP``,
``NeuTexMLP`` and the ``_kernel_init`` choices). Layer names are the flax
ones (``xyz_encoding_{i}``, ``xyz_encoding_final``, ``sigma``,
``dir_encoding``, ``rgb``; ``dir_encoding_1``/``_2`` in NeuTex's
direction branch; ``layer_{i}`` in the proposal net), so
``nerfsr_torch/weights.py`` maps a JAX param tree onto them one to one.

``compute_dtype`` bfloat16 follows flax ``Dense(dtype=bf16)``: inputs,
weights and bias in bf16, output in bf16; sigma and rgb come out in f32.
Parameters are f32. Initialisation matches flax's distributions (not its
bits): he_normal and lecun_normal are truncated normals, biases start at
zero. Draws come from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

# std of a unit normal truncated to [-2, 2]; flax's variance_scaling
# divides by it so the truncated draw keeps the requested variance
_TRUNC_STD = 0.87962566103423978


def _truncated_normal(shape, std, generator):
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, \
        (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    u = lo + (hi - lo) * u
    x = torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)
    return (x.clamp(-2.0, 2.0) * std).float()


def _orthogonal(shape, scale, generator):
    n_rows, n_cols = shape
    a = torch.randn((max(n_rows, n_cols), min(n_rows, n_cols)),
                    generator=generator, dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if n_rows < n_cols:
        q = q.T
    return (scale * q).float()


def kernel_init(name: str, shape, gain: float = 0.02,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """A flax-layout (in, out) kernel drawn as ``_kernel_init(name, gain)``
    of the JAX package draws it: kaiming = he_normal (truncated), xavier =
    normal with std gain*sqrt(2/(fan_in+fan_out)), normal = N(0, gain),
    orthogonal(scale=gain), anything else = lecun_normal (truncated)."""
    fan_in, fan_out = shape
    if name == "kaiming":
        return _truncated_normal(shape, math.sqrt(2.0 / fan_in)
                                 / _TRUNC_STD, generator)
    if name == "xavier":
        std = gain * math.sqrt(2.0 / (fan_in + fan_out))
        return torch.randn(shape, generator=generator) * std
    if name == "normal":
        return torch.randn(shape, generator=generator) * gain
    if name == "orthogonal":
        return _orthogonal(shape, gain, generator)
    return _truncated_normal(shape, math.sqrt(1.0 / fan_in) / _TRUNC_STD,
                             generator)


class _DenseStack(nn.Module):
    """Shared flax-Dense semantics of the MLPs."""

    compute_dtype: torch.dtype

    def _dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        lin = getattr(self, name)
        cd = self.compute_dtype
        return F.linear(x, lin.weight.to(cd), lin.bias.to(cd))

    @torch.no_grad()
    def reset_parameters(self, init_type: str = "kaiming",
                         init_gain: float = 0.02,
                         generator: Optional[torch.Generator] = None):
        """Redraw every kernel (flax layout, transposed into the Linear)
        and zero every bias."""
        for lin in self.modules():
            if isinstance(lin, nn.Linear):
                k = kernel_init(init_type, (lin.in_features,
                                            lin.out_features),
                                init_gain, generator)
                lin.weight.copy_(k.T)
                lin.bias.zero_()
        return self


class _NeRFMLP(_DenseStack):
    """The trunk that both NeRF MLPs share: ``depth`` layers of ``width``
    with the encoded input concatenated back before each skip layer, the
    sigma head off it, ``xyz_encoding_final`` and the rgb head's
    activation."""

    def __init__(self, depth: int, width: int, skips: Sequence[int],
                 color_activation: str, c_pos: int,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.depth, self.width = depth, width
        self.skips = tuple(skips)
        self.color_activation = color_activation
        self.compute_dtype = compute_dtype
        in_dim = c_pos
        for i in range(depth):
            if i in self.skips and i > 0:
                in_dim = c_pos + width
            setattr(self, f"xyz_encoding_{i + 1}", nn.Linear(in_dim, width))
            in_dim = width
        self.sigma = nn.Linear(width, 1)
        self.xyz_encoding_final = nn.Linear(width, width)

    def _trunk(self, xyz_emb: torch.Tensor):
        """(the trunk's features in the compute dtype, raw sigma in f32)."""
        x = xyz_emb.to(self.compute_dtype)
        inp = x
        for i in range(self.depth):
            if i in self.skips and i > 0:
                x = torch.cat([inp, x], dim=-1)
            x = torch.relu(self._dense(f"xyz_encoding_{i + 1}", x))
        return x, self._dense("sigma", x).float()[..., 0]

    def _rgb(self, h: torch.Tensor) -> torch.Tensor:
        rgb = self._dense("rgb", h).float()
        if self.color_activation == "sigmoid":
            rgb = torch.sigmoid(rgb)
        return rgb


class VanillaMLP(_NeRFMLP):
    """8-layer NeRF MLP: D-layer trunk of width W with a skip concat, a
    sigma head off the trunk, and an rgb branch of width W/2 conditioned
    on the view direction. ``stop_grad`` detaches the feature/direction
    concat, so the rgb loss reaches neither the trunk nor
    ``xyz_encoding_final``."""

    def __init__(self, depth: int = 8, width: int = 256,
                 skips: Sequence[int] = (4,), use_dir: bool = True,
                 stop_grad: bool = False,
                 dim_rgb: int = 3, color_activation: str = "sigmoid",
                 c_pos: int = 63, c_dir: int = 27,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(depth, width, skips, color_activation, c_pos,
                         compute_dtype)
        self.use_dir = use_dir
        self.stop_grad = stop_grad
        self.dir_encoding = nn.Linear(width + (c_dir if use_dir else 0),
                                      width // 2)
        self.rgb = nn.Linear(width // 2, dim_rgb)

    def forward(self, xyz_emb: torch.Tensor,
                dir_emb: Optional[torch.Tensor] = None,
                sigma_only: bool = False):
        """xyz_emb (..., C_pos), dir_emb (..., C_dir) -> rgb (..., dim_rgb)
        and raw sigma (...), both f32."""
        x, sigma = self._trunk(xyz_emb)
        if sigma_only:
            return None, sigma
        feat = self._dense("xyz_encoding_final", x)
        if self.use_dir:
            if dir_emb is None:
                raise ValueError("use_dir=True but dir_emb is None")
            feat = torch.cat([feat, dir_emb.to(self.compute_dtype)], dim=-1)
        if self.stop_grad:      # --stop_grad: rgb trains the colour head
            feat = feat.detach()
        return self._rgb(torch.relu(self._dense("dir_encoding", feat))), \
            sigma


class ProposalMLP(_DenseStack):
    """Small sigma-only MLP that shapes the sampling distribution of the
    fast-sampling path."""

    def __init__(self, depth: int = 4, width: int = 64, c_in: int = 39,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth = depth
        self.compute_dtype = compute_dtype
        in_dim = c_in
        for i in range(depth):
            setattr(self, f"layer_{i}", nn.Linear(in_dim, width))
            in_dim = width
        self.sigma = nn.Linear(width, 1)

    def forward(self, xyz_emb: torch.Tensor) -> torch.Tensor:
        """xyz_emb (..., C) -> raw sigma (...) in f32."""
        x = xyz_emb.to(self.compute_dtype)
        for i in range(self.depth):
            x = torch.relu(self._dense(f"layer_{i}", x))
        return self._dense("sigma", x).float()[..., 0]


class NeuTexMLP(_NeRFMLP):
    """VanillaMLP's trunk and sigma head with a deeper direction branch:
    two full-width layers (W + C_dir -> W -> W) before the rgb head, where
    VanillaMLP has one half-width layer. The branch always takes the view
    direction (no ``use_dir``), and there is no ``stop_grad``."""

    def __init__(self, depth: int = 8, width: int = 256,
                 skips: Sequence[int] = (4,), dim_rgb: int = 3,
                 color_activation: str = "sigmoid",
                 c_pos: int = 63, c_dir: int = 27,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(depth, width, skips, color_activation, c_pos,
                         compute_dtype)
        self.dir_encoding_1 = nn.Linear(width + c_dir, width)
        self.dir_encoding_2 = nn.Linear(width, width)
        self.rgb = nn.Linear(width, dim_rgb)

    def forward(self, xyz_emb: torch.Tensor, dir_emb: torch.Tensor,
                sigma_only: bool = False):
        """xyz_emb (..., C_pos), dir_emb (..., C_dir) -> rgb (..., dim_rgb)
        and raw sigma (...), both f32."""
        x, sigma = self._trunk(xyz_emb)
        if sigma_only:
            return None, sigma
        h = torch.cat([self._dense("xyz_encoding_final", x),
                       dir_emb.to(self.compute_dtype)], dim=-1)
        h = torch.relu(self._dense("dir_encoding_1", h))
        h = torch.relu(self._dense("dir_encoding_2", h))
        return self._rgb(h), sigma
