"""Kernel A's least time in a training step, frozen here beside
``arith.py`` (which it leaves as it is) so that a change to the system
cannot move it.

A step of the proposal schedule inverts a CDF once for each round after
the first and once for the fine samples: with rounds of ``n_prop`` and
``n_prop2`` samples, (B, Q) = (n_prop - 1, n_prop2) and (n_prop2 - 1,
N_importance) bins and queries a ray. A call reads each ray's B - 1
weights and Q uniforms once, writes its Q depths once, and reads the
bins its queries land in: the two edges of each query's bin, at most
min(B, 2 Q) of them, all of them where the queries are spread over the
CDF, as on these cells' weights (at their shapes, B <= 2 Q: every bin).
4 bytes each, at 3.35 TB/s. That is the system's own count
(``nerfsr_torch/timing.py``: ``invert_cdf_bytes``) with min(B, 2 Q)
bins read a ray, at most its count of every bin.
"""

from __future__ import annotations

from typing import List, Tuple

from nerfbench.arith import HBM_BYTES_PER_S


def invert_cdf_calls(arch: dict) -> List[Tuple[int, int]]:
    """(bins, queries) a ray of each kernel A call in a training step of
    the proposal schedule; none on the parity schedule."""
    if not arch["fast_sampling"]:
        return []
    rounds = [arch["n_prop"]] + [arch["n_prop2"]] * (
        arch["n_prop_levels"] - 1)
    queries = rounds[1:] + [arch["N_importance"]]
    return [(s - 1, q) for s, q in zip(rounds, queries)]


def invert_cdf_least_bytes(n: int, b: int, q: int) -> int:
    """Bytes a call moves for n rays of b bins and q queries: the
    weights, u and z once each, and min(b, 2 q) bins a ray."""
    return 4 * n * ((b - 1) + q + q + min(b, 2 * q))


def invert_cdf_least_s(arch: dict, n: int) -> float:
    """The least seconds of a step's kernel A calls over n rays."""
    return sum(invert_cdf_least_bytes(n, b, q)
               for b, q in invert_cdf_calls(arch)) / HBM_BYTES_PER_S
