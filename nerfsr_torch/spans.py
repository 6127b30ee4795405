"""Spans: named stretches of the port's host work, on the profiler's clock.

``span(name)`` marks a stretch of host code (``with span("nerfsr.x"):``).
It does something only while something records:

- off (the default): ``span`` returns one shared no-op context. It reads
  no clock, enters no ``record_function`` and allocates nothing; the
  whole check is the list of open recordings and the profiler's flag.
- while a ``torch.profiler`` records: the span is a ``record_function``,
  so it lands in the profiler's event list, on the kernels' clock, and
  an idle gap of the card inside it can be put down to it. Its count,
  seconds and self seconds add to the process's record (``totals``,
  ``reset``).
- inside ``recording()``: the same count and seconds add to that
  recording's ``Totals``, with or without a profiler. ``engine.test`` and
  ``engine.test_refine`` fill their ``timings`` this way.

``timed(name)`` is a span that always reads the clock, for the few
stretches whose length the program itself reports (an epoch in the
training log, a graph's capture): its ``seconds`` are set when it ends.

A span's self seconds are its seconds less those of the spans opened
inside it; ``parent`` is the name of the span open around it (None at
the top) the first time it was recorded. Spans nest per thread, and
spans of several threads add to one recording (under a lock: the writer
threads' encodes add to the ``test`` call's). A span ends before the
code that opened it yields: a generator's caller runs on the same stack,
and its time is not the generator's.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import Optional

from torch.autograd import profiler as _prof

_NULL = contextlib.nullcontext()
_recordings: list = []      # the recordings open, in the order opened
_local = threading.local()
_add = threading.Lock()     # held while a closing span adds to its totals


class Totals(dict):
    """{span name: {"count", "seconds", "self_s", "parent"}}."""

    def seconds(self, name: str) -> float:
        """The seconds of every span ``name`` recorded; 0 if none."""
        t = self.get(name)
        return t["seconds"] if t else 0.0


_totals = Totals()          # the process's record, under a profiler


class _Span:
    __slots__ = ("name", "seconds", "_into", "_rf", "_parent", "_child",
                 "_t0")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0

    def __enter__(self):
        into = list(_recordings)
        self._rf = None
        if _prof._is_profiler_enabled:
            into.append(_totals)
            self._rf = _prof.record_function(self.name)
            self._rf.__enter__()
        self._into = into
        stack = _stack()
        self._parent: Optional[_Span] = stack[-1] if stack else None
        stack.append(self)
        self._child = 0.0
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        _stack().pop()
        parent = self._parent
        if parent is not None:
            parent._child += self.seconds
        with _add:
            for rec in self._into:
                t = rec.get(self.name)
                if t is None:
                    t = rec[self.name] = {
                        "count": 0, "seconds": 0.0, "self_s": 0.0,
                        "parent": None if parent is None else parent.name}
                t["count"] += 1
                t["seconds"] += self.seconds
                t["self_s"] += self.seconds - self._child
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str):
    """A context that marks ``name``'s stretch while a profiler or a
    recording is on, and the shared no-op context otherwise."""
    if _recordings or _prof._is_profiler_enabled:
        return _Span(name)
    return _NULL


def spanned(name: str):
    """A decorator: each call of the function is a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def timed(name: str) -> _Span:
    """A span that reads the clock whatever records; ``.seconds`` after
    it ends."""
    return _Span(name)


@contextlib.contextmanager
def recording(on: bool = True):
    """Record every span of the block into the ``Totals`` it yields
    (left empty where ``on`` is false, and nothing turned on)."""
    rec = Totals()
    if not on:
        yield rec
        return
    _recordings.append(rec)
    try:
        yield rec
    finally:
        _recordings.remove(rec)


def totals() -> Totals:
    """A copy of the process's record: every span that ran while a
    ``torch.profiler`` recorded, since the last ``reset``."""
    with _add:
        return Totals({k: dict(v) for k, v in _totals.items()})


def reset():
    """Clear the process's record."""
    with _add:
        _totals.clear()
