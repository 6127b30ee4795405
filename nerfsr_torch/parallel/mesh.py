"""Data parallelism over the ray batch with ``torch.distributed``.

Port of ``nerfsr_tpu/parallel/mesh.py`` in PyTorch's idiom. The JAX
package shards the batch over a device mesh and lets XLA insert the
gradient's all-reduce; here each card is a rank of a process group (NCCL
on ``cuda``, gloo on ``cpu``), every rank holds the whole ray buffer and
the whole state, and:

- every rank draws the same global batch from the same (seed, step)
  generator, as every JAX process does, and keeps its contiguous share
  of the rows (``rank_rows``; a NeRF-SR row is one LR pixel with its
  ds^2 sub-rays, kept whole). Inside a step (``split_rows``) the render's
  random draws are the world's rows drawn alike on every rank, each rank
  keeping its own (``draw``), so a rank's numbers are those a one-rank
  run gives its rows;
- a mean over rows is this rank's share of the world's mean
  (``row_mean``: its mean divided by the world size), so the all-reduced
  sum of the gradients (``all_reduce_grads``, before the clip and Adam)
  is the global mean's, and every rank takes the same update and stays
  equal to the others bit for bit; the step's reported losses are summed
  the same way (``reduce_losses``, a PSNR from its summed mse share);
- an eval chunk's rays are split by rank and gathered back
  (``all_gather_rows``), so every rank holds the image;
- the master (rank 0) alone writes checkpoints, metrics and artifacts
  (``is_master``); a resumed state is read by every rank and rank 0's is
  sent to all (``broadcast_state``, JAX's ``replicate``).

Without a process group every helper is the identity and a step is the
one-process step exactly (JAX's ``mesh=None``). With one (``--num_processes``,
even at world size 1) the collectives run, inside the step's CUDA graph
on the card. ``--mesh_devices N`` > 1 without ``--num_processes`` spawns
N ranks here, one card each (``spawn``, the PyTorch reference's
``mp.spawn``).
"""

from __future__ import annotations

import contextlib
import copy
import datetime
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

# (rank, world size) while a step works on this rank's share of the rows
_share: Optional[tuple] = None
# how long a rank waits for the others at the rendezvous and a collective
TIMEOUT_S = 600


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def is_master() -> bool:
    """Rank 0, or the only process: the one that writes."""
    return rank() == 0


def init_distributed(coordinator: Optional[str], num_processes: int,
                     process_id: int, device="cuda") -> torch.device:
    """Join the process group of ``num_processes`` ranks at
    ``tcp://{coordinator}`` (``env://`` without one) as ``process_id``
    (-1: the ``RANK`` variable): NCCL on ``cuda``, where the rank takes
    card ``rank % device_count``, gloo on ``cpu``. A group already joined
    with the same rank and size is kept. Returns the rank's device; a
    failed rendezvous raises."""
    if process_id < 0:
        if "RANK" not in os.environ:
            raise ValueError("--num_processes needs --process_id (or RANK)")
        process_id = int(os.environ["RANK"])
    dev = torch.device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("no CUDA card is visible; pass --device cpu "
                               "for gloo ranks on the CPU")
        dev = torch.device("cuda", process_id % count)
        torch.cuda.set_device(dev)
    elif dev.type == "cpu" and "OMP_NUM_THREADS" not in os.environ:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // num_processes))
    if active():
        if (rank(), world_size()) != (process_id, num_processes):
            raise RuntimeError(
                f"a process group of rank {rank()}/{world_size()} exists; "
                f"asked for {process_id}/{num_processes}")
        return dev
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator}" if coordinator else "env://",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return dev


def shutdown():
    """Leave the process group, if there is one."""
    if active():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the world the options ask for, and the spawned ranks
# ---------------------------------------------------------------------------

def requested_ranks(opt) -> int:
    """``--mesh_devices``, 0 meaning every visible card (one on the CPU)."""
    if opt.mesh_devices:
        return opt.mesh_devices
    if torch.device(opt.device).type == "cuda":
        return max(1, torch.cuda.device_count())
    return 1


def spawns(opt) -> bool:
    """Whether the options ask this process to spawn the ranks: more than
    one without ``--num_processes``."""
    return not opt.num_processes and requested_ranks(opt) > 1


def check_world(opt):
    """Refuse a world the cards cannot hold, naming the count, and a
    ``--mesh_devices`` that contradicts ``--num_processes``."""
    n = requested_ranks(opt)
    if opt.num_processes:
        if opt.mesh_devices not in (0, opt.num_processes):
            raise ValueError(f"--mesh_devices {opt.mesh_devices} with "
                             f"--num_processes {opt.num_processes}: one "
                             "card a rank")
        return
    if n > 1 and torch.device(opt.device).type == "cuda":
        count = torch.cuda.device_count()
        if n > count:
            raise RuntimeError(
                f"--mesh_devices {n} asks for {n} ranks, one card each; "
                f"{count} card{'s' if count != 1 else ''} visible")


def free_port() -> int:
    """A free TCP port on this host (for a local coordinator)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_rank(rank_id, fn, opt, coordinator, n, args):
    opt = copy.copy(opt)
    opt.coordinator, opt.num_processes, opt.process_id = \
        coordinator, n, rank_id
    try:
        fn(opt, *args)
    finally:
        shutdown()


def spawn(fn, opt, *args):
    """Run ``fn(opt, *args)`` on ``requested_ranks(opt)`` spawned ranks,
    one card each, joined at a free local port; returns when all are
    done (a rank's failure raises here)."""
    check_world(opt)
    n = requested_ranks(opt)
    coordinator = f"127.0.0.1:{free_port()}"
    print(f"[mesh] spawning {n} ranks at {coordinator}")
    torch.multiprocessing.spawn(_run_rank,
                                args=(fn, opt, coordinator, n, args),
                                nprocs=n, join=True)


# ---------------------------------------------------------------------------
# inside a step: this rank's rows
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def split_rows():
    """Inside: the step works on this rank's share of the batch rows
    (``rank_rows``, ``draw``, ``row_mean``, the collectives). Without a
    process group nothing changes."""
    global _share
    prev = _share
    _share = (rank(), world_size()) if active() else None
    try:
        yield
    finally:
        _share = prev


def share() -> Optional[tuple]:
    """(rank, world size) inside ``split_rows`` with a group, else None."""
    return _share


def rank_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous share of ``x``'s leading axis (the
    counterpart of ``shard_batch``); the rows must split evenly."""
    if _share is None:
        return x
    r, w = _share
    n = x.shape[0]
    if n % w:
        raise ValueError(f"{n} rows do not split over {w} ranks")
    k = n // w
    return x[r * k:(r + 1) * k]


def rank_rows_tree(tree: dict) -> dict:
    return {k: rank_rows(v) for k, v in tree.items()}


def draw(fn, shape, **kw) -> torch.Tensor:
    """``fn(shape, **kw)`` (``torch.rand``, ``torch.randn``) whose leading
    axis is this rank's rows: the world's rows are drawn on every rank
    from the same generator state and this rank keeps its own, so the
    numbers and the generator's advance are a one-rank run's."""
    if _share is None or not len(shape):
        return fn(shape, **kw)
    r, w = _share
    n = shape[0]
    return fn((n * w,) + tuple(shape[1:]), **kw)[r * n:(r + 1) * n]


def row_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of a per-row quantity: inside a split, this rank's share of
    the world's mean (its mean over the world size)."""
    m = torch.mean(x)
    if _share is None or _share[1] == 1:
        return m
    return m / _share[1]


def all_reduce_grads(params):
    """Sum the gradients of ``params`` over the ranks (one collective over
    a flat buffer a dtype) inside a split; else nothing."""
    if _share is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    for dtype in sorted({g.dtype for g in grads}, key=str):
        part = [g for g in grads if g.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for g in part])
        dist.all_reduce(flat)
        off = 0
        for g in part:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def reduce_losses(losses: dict) -> dict:
    """The step's reported losses summed over the ranks in one collective
    inside a split (each is this rank's share; a ``*psnr*`` entry is its
    mse share, whose sum gives the PSNR); else ``losses``."""
    if _share is None:
        return losses
    vals = torch.stack([v.detach().float() for v in losses.values()])
    dist.all_reduce(vals)
    # a PSNR placeholder of zero (no such level) stays zero
    return {k: torch.where(v > 0, -10.0 * torch.log10(v), v)
            if "psnr" in k else v for k, v in zip(losses, vals.unbind())}


def mse_share(mse: torch.Tensor) -> torch.Tensor:
    """A PSNR's stand-in inside a split: this rank's share of the world's
    mse, which ``reduce_losses`` sums and takes the log of."""
    return mse / _share[1]


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's share of the rows, in rank order, inside a split; else
    ``x``."""
    if _share is None:
        return x
    parts = [torch.empty_like(x) for _ in range(_share[1])]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


@torch.no_grad()
def broadcast_state(tensors):
    """Rank 0's values of ``tensors`` on every rank (after a resume, JAX's
    ``replicate``); without a group nothing."""
    if not active():
        return
    for t in tensors:
        dist.broadcast(t, 0)
