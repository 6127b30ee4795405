"""PyTorch/CUDA port of the NeRF-SR system (``nerfsr_tpu`` is the JAX
reference it is held against).

The supersampling model serves and trains: ``render_eval_many`` of
``models/nerf_downx_system.py`` renders novel views, and ``train_steps``
of ``models/nerf_system.py`` takes Adam steps, through five CUDA kernels
written for Hopper (``kernels/``, sources in ``csrc/``). The package
imports torch and numpy only.
"""
