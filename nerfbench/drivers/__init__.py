"""The drivers of the three kinds of cell (``train``, ``render``,
``test``), one file each, and what they share: the system's options from
a configuration file, the sizes the reference reads, the chunk seed, the
comparisons that decide ``correct``, and the result a driver returns.

A driver's ``run(cell, seed, seconds, trace, device)`` makes its inputs
from the seed, sets up the system, measures for ``seconds`` (everything
before that is set-up), traces a further stretch under the profiler
when ``trace`` is set, frees the system, and checks what the timed path
produced against the plain reference.
"""

from __future__ import annotations

import dataclasses
import statistics
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

# the sizes the reference and the arithmetic read, each also an option of
# the system, which must hold the value the configuration states
ARCH_KEYS = ("img_wh", "downscale", "batch_size", "D", "W", "skips",
             "deg_pos", "deg_dir", "fast_sampling", "N_coarse",
             "N_importance", "n_prop", "n_prop_levels", "n_prop2", "prop_D",
             "prop_W", "deg_prop", "prop_pad", "prop_pad_final",
             "prop_pad_anneal_frac", "noise_std", "lr", "n_epochs")


def arch_of(config: dict, keys=ARCH_KEYS) -> dict:
    return {k: config[k] for k in keys}


def program_options(config: dict, phase: str, device, keys=ARCH_KEYS,
                    **extra):
    """The system's options for the configuration (``options`` and every
    size in ``keys``), checked key by key after the system's own preset
    expansion."""
    from nerfsr_torch.config import default_options

    over = dict(config["options"])
    over.update({k: config[k] for k in keys})
    over.update(extra)
    over["device"] = str(device)
    opt = default_options(phase, **over)
    for k in keys:
        got = getattr(opt, k)
        want = config[k]
        if (list(got) if isinstance(got, (list, tuple)) else got) != want:
            raise ValueError(f"the system runs {k}={got!r} where the "
                             f"configuration states {want!r}")
    return opt


def chunk_seed(seed: int, step: int) -> int:
    """The seed of the chunk that starts at ``step``, as the engine seeds
    its card generator: (seed, step) packed into 64 bits."""
    return ((int(seed) & 0x7FFFFFFF) << 32) | (int(step) & 0xFFFFFFFF)


def now() -> float:
    return time.perf_counter()


class Phases:
    """Seconds of each phase of a run, printed to standard error as they
    end (the set-up's parts, the window, the trace, the check)."""

    def __init__(self):
        self.t = now()
        self.seconds = {}

    def done(self, name: str):
        t = now()
        self.seconds[name] = t - self.t
        self.t = t
        print(f"[nerfbench] {name}: {self.seconds[name]:.3f} s",
              file=sys.stderr, flush=True)


def by_thirds(t0: float, ends) -> List[float]:
    """The mean seconds a unit in each third of the window's units, where
    ``ends`` are the units' arrival times and the first starts at
    ``t0``: whether a run's pace drifts within it, or only from run to
    run (printed to standard error; no metric reads it)."""
    t = [t0] + list(ends)
    k = len(ends) // 3
    if k == 0:
        return []
    cuts = [0, k, 2 * k, len(ends)]
    return [(t[b] - t[a]) / (b - a) for a, b in zip(cuts, cuts[1:])]


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def free(device):
    import gc
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


@dataclasses.dataclass
class Result:
    """What a driver hands back: the end-to-end metrics it measured, the
    context the per-layer readers read, the numbers checked with their
    limits (None: a reading, compared with nothing), the units attempted
    and failed, the memory peak, and when (``perf_counter``) the window
    started."""

    end_to_end: Dict[str, float]
    ctx: dict
    checks: List[tuple]
    attempted: int
    failed: int
    memory_peak_bytes: int
    window_start: float

    @property
    def correct(self) -> bool:
        return all(v is not None and np.isfinite(v) and v <= lim
                   for _, v, lim in self.checks if lim is not None)


# ---------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------

def leaf_norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tree.items()}


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   keep: Optional[set] = None) -> float:
    """The largest gap between the system's norm of a leaf and the
    reference's, over the larger of that leaf's reference norm and the
    median leaf's; a leaf the system does not report reads 0."""
    keys = sorted(ref if keep is None else keep)
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30)
               for k in keys)


def image_mae(a: np.ndarray, b: np.ndarray) -> float:
    """Mean absolute difference of two uint8 images, in levels. (A
    sample that rounding moves can change a pixel by many levels where
    the density jumps; the mean weighs those few pixels as what they are,
    where a root mean square would let them decide.)"""
    d = a.astype(np.float64) - b.astype(np.float64)
    return float(np.mean(np.abs(d)))


def pick(seed: int, n: int, k: int, salt: int) -> List[int]:
    """``k`` distinct positions of ``n`` drawn from the seed, in order."""
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), salt])
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())
