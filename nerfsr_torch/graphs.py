"""Single-dispatch execution on the card: CUDA graphs.

The JAX package runs a chunk of training steps as one compiled
``lax.scan`` (``nerfsr_tpu/models/nerf_system.py:train_steps_scan``,
``nerfsr_tpu/models/refine_system.py:train_steps_scan``) and an eval
image as one ``lax.map`` over its ray chunks (``_render_dirs_chunks``).
The port's counterpart is a CUDA graph: ``GraphCache.run`` captures a
body once per key and replays it, so a training step or a whole eval
image costs the host one launch.

What a body keeps to (``tests/test_torch_scan.py`` holds each system's
chunk body to it on the CPU): it reads no tensor back to the host and
derives no launch argument from a tensor's value; every value that
changes between replays lives in a tensor that the graph reads (the
learning rate, the device step, the parameters, moments and batch
statistics, all updated in place); and its random draws come from a
generator registered with the graph, so reseeding the generator between
replays moves the replays' Philox seed and offset as it moves eager
draws (a body may draw from several, each registered). The caller writes what changes between replays (a learning rate
at an epoch's end, injected indices) with ``before``, which runs before
each call.

The first call of a key runs the body eagerly on the capture stream. It
is the warm-up of PyTorch's whole-network capture recipe (cuBLAS and
cuDNN handles and workspaces, the kernel library, Adam's lazily built
moments) and a real call, whose result is returned. The capture follows;
it launches nothing, and every later call of the key replays. Under a
process group (``parallel/mesh.py``) a step's collectives are captured
with the rest of it; the eager first call brings the communicator up
before the capture. A key's graph is captured again when a tensor it
was captured with has been replaced by another (``inputs``: a resume
that loads new Adam state, a new buffer). Capture and replay failures
raise; nothing falls back to eager execution.

Spans (``nerfsr_torch/spans.py``): ``nerfsr.graph.capture`` times a
key's eager first call and its capture (``Captured.capture_s``), and
``nerfsr.graph.replay`` each later call, ``before(i)`` and the replay.

Kernel launch counts (``kernels/_lib.py``): a capture's wrapper calls
are taken back out of ``COUNTS`` and added once per replay. The fused
MLP's packing cache is emptied around each capture, so the graph
records its own packing of the weights, and after each run of replays,
which move parameters without bumping their versions.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from nerfsr_torch import spans
from nerfsr_torch.kernels import _lib
from nerfsr_torch.kernels import mlp as kmlp


def _generators(generator) -> tuple:
    """A generator, a sequence of them, or None as a tuple."""
    if generator is None:
        return ()
    if isinstance(generator, torch.Generator):
        return (generator,)
    return tuple(generator)


def signature(tensors, generator=None):
    """What a captured graph holds on to: the address, shape and dtype of
    each tensor it reads or writes in place, and the generators it
    draws from."""
    return tuple(id(g) for g in _generators(generator)) + tuple(
        (t.data_ptr(), tuple(t.shape), t.dtype) for t in tensors)


def run_steps(cache: Optional["GraphCache"], key, inputs, body, n: int,
              generator=None,
              before: Optional[Callable[[int], None]] = None):
    """``n`` calls of ``body``, each after ``before(i)``: through
    ``cache.run`` (replays of its graph) or, with no cache (the CPU, or a
    system run eagerly on the card), one after another. Returns the last
    call's outputs."""
    if cache is not None:
        return cache.run(key, inputs, body, n, generator, before)
    out = None
    for i in range(n):
        if before is not None:
            before(i)
        out = body()
    return out


@dataclasses.dataclass
class Captured:
    """One captured body: its graph, the static outputs that each replay
    rewrites, the kernel launches of one replay, the signature of its
    inputs, what capturing it cost (the seconds of the key's eager first
    call and the capture, and the bytes its memory pool reserved), and
    how often it was replayed."""

    graph: "torch.cuda.CUDAGraph"
    outputs: object
    launches: dict
    sig: tuple
    pool_bytes: int
    holds: tuple
    capture_s: float = 0.0
    replays: int = 0


class GraphCache:
    """The captured bodies of one system on one card, by key."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._stream = None
        self._entries = {}

    def entries(self):
        """{key: Captured} of the graphs held."""
        return dict(self._entries)

    def run(self, key, inputs: Callable[[], list], body: Callable[[], object],
            n: int = 1, generator=None,
            before: Optional[Callable[[int], None]] = None):
        """Call ``body`` ``n`` times (``before(i)`` ahead of call i) and
        return the last call's outputs: the first call of ``key`` eagerly,
        then the capture, then replays; once captured, replays only.
        ``inputs()`` lists the tensors the body reads or updates in place
        (evaluated after the warm-up, once lazily built state exists);
        ``generator`` is the generator the body draws from, or a sequence
        of them, each registered with the graph."""
        entry = self._entries.get(key)
        if entry is not None and entry.sig != signature(inputs(),
                                                         generator):
            del self._entries[key]
            entry = None
        out, done = None, 0
        if entry is None and n > 0:
            with spans.timed("nerfsr.graph.capture") as cap:
                stream = self._capture_stream()
                main = torch.cuda.current_stream(self.device)
                stream.wait_stream(main)
                with torch.cuda.stream(stream):
                    if before is not None:
                        before(0)
                    out = body()
                    entry = self._capture(body, inputs(), generator, stream)
                main.wait_stream(stream)
            entry.capture_s = cap.seconds
            self._entries[key] = entry
            done = 1
        for i in range(done, n):
            with spans.span("nerfsr.graph.replay"):
                if before is not None:
                    before(i)
                entry.graph.replay()
            out = entry.outputs
        if n > done:
            entry.replays += n - done
            _lib.add_replays(entry.launches, n - done)
            kmlp.forget_packed()
        return out

    def _capture_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _capture(self, body, tensors, generator, stream) -> Captured:
        graph = torch.cuda.CUDAGraph()
        for gen in _generators(generator):
            register = getattr(graph, "register_generator_state", None)
            if register is None:
                raise RuntimeError(
                    f"torch {torch.__version__} cannot register a "
                    "generator with a CUDA graph "
                    "(CUDAGraph.register_generator_state)")
            register(gen)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        before = dict(_lib.COUNTS)
        kmlp.forget_packed()
        try:
            with torch.cuda.graph(graph, stream=stream):
                outputs = body()
        except RuntimeError as e:
            raise RuntimeError(f"CUDA-graph capture failed: {e}") from e
        finally:
            launches = _lib.captured_launches(before)
            kmlp.forget_packed()
        return Captured(
            graph=graph, outputs=outputs, launches=launches,
            sig=signature(tensors, generator),
            pool_bytes=torch.cuda.memory_reserved(self.device) - reserved,
            holds=(tuple(tensors), generator))
