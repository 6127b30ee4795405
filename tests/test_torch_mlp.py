"""The port's MLP modules and the JAX -> port weight bridge against flax.

Weights are drawn by flax, handed over as numpy arrays through
``nerfsr_torch.weights``, and the same numpy inputs go through both
networks. f32 bar: f32 rounding through the matmul chain (rtol 1e-4,
atol 1e-5, the bar of tests/test_pallas.py). Mixed bar: both sides follow
flax ``Dense(dtype=bf16)``, but PyTorch adds the bias inside the bf16
linear while XLA rounds the product and then the sum, so one bf16 ulp
(2^-8) may differ per layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in a test worker)

from nerfsr_tpu.models.mlp import ProposalMLP as JProp
from nerfsr_tpu.models.mlp import VanillaMLP as JMLP
from nerfsr_tpu.models.mlp import _kernel_init

from nerfsr_torch.models.mlp import ProposalMLP, VanillaMLP, kernel_init
from nerfsr_torch.weights import load_jax_params, load_module

F32_TOL = dict(rtol=1e-4, atol=1e-5)


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def emb(n, c, seed):
    return np.random.RandomState(seed).randn(n, c).astype(np.float32)


@pytest.mark.parametrize("precision", ["f32", "mixed"])
def test_vanilla_mlp_matches_flax(precision):
    jdt = jnp.float32 if precision == "f32" else jnp.bfloat16
    tdt = torch.float32 if precision == "f32" else torch.bfloat16
    x, d = emb(40, 63, 0), emb(40, 27, 1)
    jmlp = JMLP(compute_dtype=jdt)
    params = jmlp.init(jax.random.PRNGKey(0), jnp.zeros((1, 63)),
                       jnp.zeros((1, 27)))
    net = load_module(VanillaMLP(compute_dtype=tdt), to_numpy_tree(params))
    j_rgb, j_sigma = jmlp.apply(params, jnp.asarray(x), jnp.asarray(d))
    with torch.no_grad():
        rgb, sigma = net(torch.from_numpy(x), torch.from_numpy(d))
    assert rgb.dtype == sigma.dtype == torch.float32
    if precision == "f32":
        np.testing.assert_allclose(rgb.numpy(), np.asarray(j_rgb), **F32_TOL)
        np.testing.assert_allclose(sigma.numpy(), np.asarray(j_sigma),
                                   **F32_TOL)
    else:
        np.testing.assert_allclose(rgb.numpy(), np.asarray(j_rgb,
                                                           np.float32),
                                   atol=2e-2)
        scale = float(np.abs(np.asarray(j_sigma, np.float32)).max())
        np.testing.assert_allclose(sigma.numpy(), np.asarray(j_sigma,
                                                             np.float32),
                                   atol=5e-2 * scale)


@pytest.mark.parametrize("precision", ["f32", "mixed"])
def test_proposal_mlp_matches_flax(precision):
    """The slice's proposal net: W48/D3 on a deg-6 encoding (39 ch)."""
    jdt = jnp.float32 if precision == "f32" else jnp.bfloat16
    tdt = torch.float32 if precision == "f32" else torch.bfloat16
    x = emb(50, 39, 2)
    jprop = JProp(depth=3, width=48, compute_dtype=jdt)
    params = jprop.init(jax.random.PRNGKey(1), jnp.zeros((1, 39)))
    net = load_module(ProposalMLP(depth=3, width=48, c_in=39,
                                  compute_dtype=tdt), to_numpy_tree(params))
    ref = np.asarray(jprop.apply(params, jnp.asarray(x)), np.float32)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    if precision == "f32":
        np.testing.assert_allclose(got, ref, **F32_TOL)
    else:
        np.testing.assert_allclose(got, ref,
                                   atol=2e-2 * float(np.abs(ref).max()))


def test_bridge_layout_and_errors():
    jmlp = JMLP(depth=2, width=32, skips=(), compute_dtype=jnp.float32)
    params = to_numpy_tree(jmlp.init(jax.random.PRNGKey(2),
                                     jnp.zeros((1, 63)), jnp.zeros((1, 27))))
    net = load_module(VanillaMLP(depth=2, width=32, skips=()), params)
    # flax kernel (in, out) is the transpose of Linear.weight (out, in)
    k = params["params"]["dir_encoding"]["kernel"]
    assert k.shape == (32 + 27, 16)
    np.testing.assert_array_equal(net.dir_encoding.weight.detach().numpy(),
                                  k.T)
    with pytest.raises(KeyError, match="layer names differ"):
        load_module(VanillaMLP(depth=3, width=32, skips=()), params)
    with pytest.raises(ValueError, match="kernel"):
        load_module(VanillaMLP(depth=2, width=64, skips=()), params)
    tree = {"prop": to_numpy_tree(JProp(depth=1, width=8).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 39)))), "fine": params}
    mods = torch.nn.ModuleDict({"prop": ProposalMLP(depth=1, width=8),
                                "fine": VanillaMLP(depth=2, width=32,
                                                   skips=())})
    load_jax_params(mods, tree)
    with pytest.raises(KeyError, match="networks differ"):
        load_jax_params(mods, {"fine": params})


@pytest.mark.parametrize("init", ["kaiming", "xavier", "normal",
                                  "orthogonal", "lecun"])
def test_init_matches_flax_distribution(init):
    """Distribution, not bits: the draws' std and range match flax's for
    the same (in, out) shape, and biases start at zero."""
    shape = (256, 128)
    ref = np.asarray(_kernel_init(init, 0.5)(jax.random.PRNGKey(0), shape,
                                             jnp.float32))
    got = kernel_init(init, shape, 0.5,
                      torch.Generator().manual_seed(0)).numpy()
    assert got.shape == shape
    np.testing.assert_allclose(got.std(), ref.std(), rtol=0.03)
    assert abs(got.mean()) < 0.05 * ref.std()
    if init in ("kaiming", "lecun"):   # truncated at 2 std (pre-scaling)
        bound = np.abs(ref).max()
        assert np.abs(got).max() <= bound * 1.02
    if init == "orthogonal":           # columns orthonormal, times gain
        np.testing.assert_allclose(got.T @ got, 0.25 * np.eye(128),
                                   atol=1e-5)
    net = VanillaMLP(depth=2, width=16, skips=()).reset_parameters(
        init, 0.5, torch.Generator().manual_seed(1))
    assert all(float(m.bias.detach().abs().max()) == 0.0 for m in net.modules()
               if isinstance(m, torch.nn.Linear))


def test_flatten_params_matches_jax_flatten():
    from nerfsr_tpu.ops.experimental.pallas_mlp import flatten_params as jf

    from nerfsr_torch.kernels.mlp import flatten_params
    jmlp = JMLP(compute_dtype=jnp.float32)
    params = jmlp.init(jax.random.PRNGKey(4), jnp.zeros((1, 63)),
                       jnp.zeros((1, 27)))
    net = load_module(VanillaMLP(), to_numpy_tree(params))
    for a, b in zip(flatten_params(net), jf(params)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
