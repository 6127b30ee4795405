"""Hand-written Hopper kernels of the port and their wrappers.

- ``sampling``: kernel A, the fused inverse-CDF resample (forward only).
- ``composite``: kernels B and D, the fused alpha composite and its
  backward.
- ``mlp``: kernels C and E, the fused D8/W256 NeRF MLP forward and its
  weight-gradient backward.
- ``posenc``: kernel F, the sinusoidal positional encoding in one launch
  (forward only, for inputs that need no gradient).

Each wrapper takes its kernel's plain PyTorch version for a CPU tensor
and launches the kernel (or raises) for a CUDA tensor. ``_lib`` builds
and loads the shared library and holds the launch counts.
"""

from nerfsr_torch.kernels._lib import COUNTS, LAUNCHES_PER_CALL, reset_counts

__all__ = ["COUNTS", "LAUNCHES_PER_CALL", "reset_counts"]
