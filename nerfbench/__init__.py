"""The benchmark of ``nerfsr_torch``, the PyTorch and CUDA port of NeRF-SR,
on an NVIDIA H100: ``python3 -m nerfbench.run --workload <cell> --seed
<n> --seconds <s> --trace <0|1>``. See ``BENCHMARK.json`` and
``nerfbench/spec.py``."""
