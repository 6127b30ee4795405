"""Sinusoidal positional encoding.

Port of ``nerfsr_tpu/core/encoding.py``: the same output channel order
``[x, sin(f0*x), cos(f0*x), sin(f1*x), ...]`` (each term spans all input
channels), the ``include_identity`` drop and the log/linear frequency
bands.
"""

from __future__ import annotations

import torch


def posenc_channels(in_channels: int, num_freqs: int,
                    include_identity: bool = True) -> int:
    """Output channel count of ``positional_encoding``."""
    out = in_channels * 2 * num_freqs
    if include_identity:
        out += in_channels
    return out


def frequencies(num_freqs: int, log_scale: bool = True,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """The encoding's frequencies: 2^k (log scale) or evenly spaced from
    1 to 2^(num_freqs - 1), computed on ``device``."""
    if log_scale:
        return 2.0 ** torch.arange(num_freqs, dtype=dtype, device=device)
    return torch.linspace(1.0, 2.0 ** (num_freqs - 1), num_freqs,
                          dtype=dtype, device=device)


def positional_encoding(x: torch.Tensor, num_freqs: int,
                        include_identity: bool = True,
                        log_scale: bool = True) -> torch.Tensor:
    """Embed ``x -> (x, sin(f x), cos(f x), ...)``.

    x: (..., C) -> (..., posenc_channels(C, num_freqs, include_identity)).
    """
    if num_freqs == 0:
        return x if include_identity else x[..., :0]
    freqs = frequencies(num_freqs, log_scale, x.dtype, x.device)
    angles = x[..., None, :] * freqs[:, None]             # (..., F, C)
    enc = torch.stack([torch.sin(angles), torch.cos(angles)], dim=-2)
    enc = enc.reshape(x.shape[:-1] + (2 * num_freqs * x.shape[-1],))
    if include_identity:
        enc = torch.cat([x, enc], dim=-1)
    return enc
