"""Kernel F: the sinusoidal positional encoding in one launch
(``csrc/posenc.cu``).

No TPU kernel stands behind it: the JAX package leaves the encoding to
XLA, which fuses it into its consumer. On the card the plain version,
``core/encoding.py:positional_encoding``, runs as a chain of kernels (a
multiply, sin, cos, a stack and a cat) that writes and rereads every
intermediate; F writes the same bits once.

``positional_encoding`` takes the plain version's arguments and
``repeat``. A CPU tensor takes the chain; a CUDA tensor launches F, or
raises if it is not f32 or needs a gradient (F gives none). A caller
that wants the chain on the card asks for it by name
(``RenderConfig.plain``, ``kernels/mlp.py:embed(plain=True)``).
``_lib.COUNTS`` counts F's launches under ``"posenc"``.
"""

from __future__ import annotations

import torch

from nerfsr_torch.core import encoding
from nerfsr_torch.kernels import _lib

# (num_freqs, log_scale, device) -> the frequencies on that device, as the
# chain computes them there
_FREQS = {}


def check_input(x: torch.Tensor):
    """Raise unless F takes the CUDA tensor ``x``: f32, and no gradient
    wanted through the encoding."""
    if x.dtype != torch.float32:
        raise TypeError(f"posenc: dtype {x.dtype}, kernel F takes float32")
    if x.requires_grad:
        raise ValueError("posenc: kernel F gives no gradient; an input "
                         "that needs one takes the chain "
                         "(core/encoding.py)")


def _frequencies(num_freqs: int, log_scale: bool, device) -> torch.Tensor:
    key = (num_freqs, log_scale, device)
    freqs = _FREQS.get(key)
    if freqs is None:
        freqs = encoding.frequencies(num_freqs, log_scale, torch.float32,
                                     device)
        # one computed inside a capture lives in the graph's memory pool
        if not torch.cuda.is_current_stream_capturing():
            _FREQS[key] = freqs
    return freqs


def repeat_rows(x: torch.Tensor, repeat: int) -> torch.Tensor:
    """x (N, C) -> (N * repeat, C), row r a copy of row r // repeat."""
    n, c = x.shape
    return x[:, None, :].expand(n, repeat, c).reshape(n * repeat, c)


def positional_encoding(x: torch.Tensor, num_freqs: int,
                        include_identity: bool = True,
                        log_scale: bool = True,
                        repeat: int = 1) -> torch.Tensor:
    """``core/encoding.py:positional_encoding`` of x (..., C) ->
    (..., C_out); with ``repeat`` S > 1, x (N, C) -> (N * S, C_out), the
    encoding of ``repeat_rows(x, S)``. Kernel F on the card, the chain
    on the CPU, the same bits either way."""
    if repeat > 1 and x.dim() != 2:
        raise ValueError(f"posenc: repeat takes (N, C) rows, got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        if repeat > 1:
            x = repeat_rows(x, repeat)
        return encoding.positional_encoding(x, num_freqs, include_identity,
                                            log_scale)
    check_input(x)
    c = x.shape[-1]
    rows = x.reshape(-1, c)
    if rows.stride(-1) != 1:
        rows = rows.contiguous()
    c_out = encoding.posenc_channels(c, num_freqs, include_identity)
    out_rows = rows.shape[0] * repeat
    out = torch.empty((out_rows, c_out), dtype=torch.float32,
                      device=x.device)
    freqs = _frequencies(num_freqs, log_scale, x.device)
    with torch.cuda.device(x.device):
        err = _lib.lib().nerfsr_posenc(
            rows.data_ptr(), rows.stride(0), freqs.data_ptr(),
            out.data_ptr(), out_rows, c, num_freqs, int(include_identity),
            repeat, _lib.stream_ptr(x))
    _lib.check(err, "posenc")
    _lib.COUNTS["posenc"] += 1
    if repeat > 1:
        return out
    return out.reshape(x.shape[:-1] + (c_out,))
