"""The analytic FLOP count behind the training log's ``tflops`` scalar.

Port of ``nerfsr_tpu/utils/devbench.py``'s ``train_matmul_flops_per_ray``,
on the port's parameter trees (an ``nn.ModuleDict`` of networks). The
module's two other helpers have no use here: ``enable_compile_cache``
points JAX's persistent XLA cache at a directory, and the port compiles
no XLA programs (its kernels are built once into ``nerfsr_torch/_build``);
``grouped_buffer`` makes a synthetic JAX buffer for ``bench.py`` and the
TPU profiler, which the port does not run.
"""

from __future__ import annotations


def train_matmul_flops_per_ray(render_cfg, params) -> float:
    """Matmul FLOPs per ray of one training step (forward and backward, 3x
    the forward). Every 2-D parameter of a network counts ``2 * m * n``
    FLOPs a point (a ``Linear.weight`` (out, in) has the elements of
    flax's kernel (in, out)), times the points a ray gives that network:
    the fast preset's proposal levels and fine samples, or parity's
    coarse samples and the fine level's merged coarse + importance
    depths. Positional encodings, compositing and resampling are left
    out, as the JAX package leaves them out."""

    def per_point(net):
        if net not in params:
            return 0
        return sum(2 * p.numel() for p in params[net].parameters()
                   if p.ndim == 2)

    if render_cfg.fast_sampling:
        prop_pts = render_cfg.n_prop + (
            render_cfg.n_prop2 if render_cfg.n_prop_levels >= 2 else 0)
        fwd = prop_pts * per_point("prop") \
            + render_cfg.n_importance * per_point("fine")
    else:
        fwd = render_cfg.n_coarse * per_point("coarse") + (
            render_cfg.n_coarse + render_cfg.n_importance) \
            * per_point("fine")
    return 3.0 * fwd
