"""The frozen yardstick equals the system's own counts at both
configurations: the matmul FLOPs a ray (``utils/devbench.py``) and the
least times of kernels C and E with E's multiply-adds (``chip_smoke.py``,
``kernels/mlp.py``)."""

import sys

import pytest
import torch

from nerfbench import arith, spec
from nerfbench.drivers import arch_of, program_options

CONFIGS = ["x2_llff_fast.train", "x2_llff.train"]


@pytest.mark.parametrize("name", CONFIGS)
def test_flops_per_ray_equal_the_ports(name):
    from nerfsr_torch.models import create_model
    from nerfsr_torch.utils.devbench import train_matmul_flops_per_ray

    cell = spec.Cell(name)
    opt = program_options(cell.config, "train", "cpu")
    system = create_model(opt, device="cpu")
    params = system.init_params(seed=0)
    arch = arch_of(cell.config)
    assert arith.train_flops_per_ray(arch) == train_matmul_flops_per_ray(
        system.render_cfg, params)
    main = sum(p.numel() for p in params["fine"].parameters() if p.ndim == 2)
    assert arith.main_macs_per_point(arch) == main


@pytest.mark.parametrize("p", [32768, 131072, 262144])
def test_kernel_bounds_equal_chip_smokes(p):
    sys.path.insert(0, str(spec.ROOT))
    import chip_smoke
    from nerfsr_torch.kernels import mlp as kmlp

    arch = arch_of(spec.Cell("x2_llff.train").config)
    assert arith.main_macs_per_point(arch) == kmlp.N_WEIGHTS
    assert arith.e_macs_per_point(arch) == chip_smoke.E_MACS_PER_POINT
    assert arith.mlp_fwd_least_s(arch, p) * 1e3 == pytest.approx(
        chip_smoke.mlp_fwd_bound(p, "bf16")[1], rel=1e-12)
    assert arith.mlp_bwd_least_s(arch, p) * 1e3 == pytest.approx(
        chip_smoke.mlp_bwd_bound(p, "bf16")[1], rel=1e-12)


def test_forward_flops_of_an_image():
    arch = arch_of(spec.Cell("x2_llff_fast.render").config)
    assert arith.forward_flops_per_ray(arch) * 3 == \
        arith.train_flops_per_ray(arch)
    assert arith.main_points_per_ray(arch) == [16]
    parity = arch_of(spec.Cell("x2_llff.test").config)
    assert arith.main_points_per_ray(parity) == [64, 128]
    assert torch.tensor(arith.forward_flops_per_ray(parity)).item() == \
        2.0 * 593408 * 192
