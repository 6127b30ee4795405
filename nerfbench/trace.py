"""The device trace of a traced run, reduced to what the per-layer
metrics and the result line read: the union of the device's busy
intervals, each kernel's time by name, and the idle gaps labelled by the
host operation that was running.

The union counts overlapping kernels once (the system's own
``profile_slice.py`` sums their times, which counts an overlap twice).
The reduction works on plain (name, start, end) intervals in
microseconds; ``record`` takes them from a ``torch.profiler`` run.
"""

from __future__ import annotations

import bisect
import contextlib
from typing import Dict, List, Optional, Tuple

WINDOW = "nerfbench.traced_window"

Interval = Tuple[str, float, float]


def union_us(intervals: List[Interval], lo: float, hi: float) -> float:
    """Length of the union of the intervals, clipped to [lo, hi]."""
    spans = sorted((max(s, lo), min(e, hi)) for _, s, e in intervals
                   if e > lo and s < hi)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: List[Interval], lo: float, hi: float):
    """The idle stretches of [lo, hi] outside every interval."""
    out, t = [], lo
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def label_gaps(gap_list, host: List[Interval], limit: int = 4000):
    """Each gap's label: the innermost host operation running at its
    middle (the latest-starting one that contains it), or ``python`` where
    no operation runs. Returns {label: idle us}."""
    host = sorted(host, key=lambda x: x[1])
    starts = [s for _, s, _ in host]
    totals: Dict[str, float] = {}
    for s, e in gap_list:
        mid = 0.5 * (s + e)
        label = "python"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(-1, i - limit), -1):
            if host[j][2] >= mid:
                label = host[j][0]
                break
        totals[label] = totals.get(label, 0.0) + (e - s)
    return totals


def by_name(intervals: List[Interval]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for name, s, e in intervals:
        out[name] = out.get(name, 0.0) + (e - s)
    return out


def short(name: str, most: int = 120) -> str:
    """A kernel's name without its argument list, at most ``most``
    characters."""
    if name.endswith(")") and "(" in name:
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:most]


def top(d: Dict[str, float], n: int = 10) -> list:
    """The ``n`` largest entries as [short name, seconds] (from us)."""
    return [[short(k), v * 1e-6] for k, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:n]]


class Trace:
    """The reduced trace of one traced window."""

    def __init__(self, device: List[Interval], host: List[Interval],
                 window: Tuple[float, float], units: int):
        self.units = units
        self.lo, self.hi = window
        inside = [iv for iv in device if iv[2] > self.lo and iv[1] < self.hi]
        self.kernels = by_name(inside)
        self.busy_s = union_us(device, self.lo, self.hi) * 1e-6
        self.window_s = (self.hi - self.lo) * 1e-6
        self.idle = label_gaps(gaps(inside, self.lo, self.hi), host)

    def device_s(self, patterns) -> Optional[float]:
        """Device seconds of the kernels whose names hold any of
        ``patterns``; None where none matches."""
        hit = [v for k, v in self.kernels.items()
               if any(p in k for p in patterns)]
        return sum(hit) * 1e-6 if hit else None

    def idle_pct(self) -> Optional[float]:
        """The share of the window in which no operation ran on the card:
        one minus the union of its intervals over the window's length."""
        if self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self) -> dict:
        return {"device_ops": top(self.kernels), "idle_gaps": top(self.idle)}


@contextlib.contextmanager
def record(units_box: list):
    """Profile the block (which must end by synchronizing the card) under
    ``torch.profiler``; ``units_box[0]`` is set by the caller to the units
    (steps, images, calls) the block ran. Yields a list that receives the
    ``Trace``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    out: list = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield out
    device, host, window = [], [], None
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == cuda:
            if not getattr(e, "is_user_annotation", False):
                device.append(span)
        elif e.name == WINDOW:
            window = span[1:]
        else:
            host.append(span)
    if window is None:
        raise RuntimeError("the traced window's annotation is missing")
    out.append(Trace(device, host, window, units_box[0]))
