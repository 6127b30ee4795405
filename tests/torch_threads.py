"""torch's CPU thread pool in a pytest-xdist worker: the worker's share of
the cores.

torch starts a thread a core for its CPU kernels in every process. Under
``pytest -n 6`` on eight cores that is 48 threads busy-waiting on eight
cores, and the port's tests run several times slower than alone (six of
the port's test files: 1,918 s summed by the junit with torch's default,
287 s with this, on one eight-core host). Each port test file imports
this module, so a worker sets its pool when it collects the files, before
any test runs; ``OMP_NUM_THREADS`` carries the same count to the
processes a test starts. A run without workers keeps torch's default.
"""

import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))

if WORKERS > 1:
    THREADS = max(1, len(os.sched_getaffinity(0)) // WORKERS)
    torch.set_num_threads(THREADS)
    os.environ["OMP_NUM_THREADS"] = str(THREADS)
