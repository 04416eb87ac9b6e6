"""The port's transform net (styletransfer_tpu_torch/models/transformer.py)
against the JAX forward, on the same parameters carried across with
``params_from_jax``. On CPU tensors the kernels' wrappers compute their
plain versions, so this holds the port's algorithm against JAX."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletransfer_tpu.models import transformer as jt
from styletransfer_tpu_torch.models import transformer as tt
from styletransfer_tpu_torch.ops.cuda import conv3x3, instance_norm

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden.npz")

# f32: the port's instance norms take the exact two-pass variance (or the
# conv's one-pass sums), JAX's the one-pass form: about 1e-6 apart
# (styletransfer_tpu/ops/layers.py:141-146), compounded over 15 norms.
F32_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16: both keep activations in bf16 (8-bit mantissa, 2**-8 relative per
# rounding) but round at different places (the port adds conv biases and
# takes IN statistics in f32 before rounding); each is about 0.03 from the
# f32 output at these sizes, so they may be up to about twice that apart.
BF16_ATOL = 0.06


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(jt.init_params(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def port_params(jax_params):
    return tt.params_from_jax(jax_params, device="cpu")


@pytest.fixture(scope="module")
def jax_apply():
    return jax.jit(jt.apply, static_argnames=("compute_dtype",))


@pytest.mark.parametrize("size", [32, 34])
def test_forward_matches_jax_f32(jax_params, port_params, jax_apply, size):
    x = np.random.default_rng(size).standard_normal((2, size, size, 3)).astype(np.float32)
    want = np.asarray(jax_apply(jax_params, jnp.asarray(x)))
    got = tt.apply(port_params, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_forward_matches_jax_bf16(jax_params, port_params, jax_apply):
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax_apply(jax_params, jnp.asarray(x), compute_dtype=jnp.bfloat16))
    got = tt.apply(port_params, torch.from_numpy(x), compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32  # the output keeps the input's dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BF16_ATOL)


def test_golden_transformer_out(port_params):
    """tests/golden/golden.npz: the JAX init_params(PRNGKey(0)) forward of
    `input` (1x16x16x3), at the JAX golden test's tolerance."""
    d = np.load(GOLDEN)
    got = tt.apply(port_params, torch.from_numpy(d["input"]))
    np.testing.assert_allclose(got.numpy(), d["transformer_out"], rtol=1e-4, atol=1e-5)


def test_forward_on_cpu_launches_no_kernel(port_params):
    before = conv3x3.launches, instance_norm.launches
    tt.apply(port_params, torch.zeros(1, 16, 16, 3))
    assert (conv3x3.launches, instance_norm.launches) == before


@pytest.mark.parametrize("in_channels", [3, 6])
def test_init_params_shapes_match_jax(in_channels):
    want = jax.device_get(jt.init_params(jax.random.PRNGKey(0), in_channels=in_channels))
    got = tt.params_to_tree(tt.init_params(seed=0, in_channels=in_channels, device="cpu"))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
    assert tt.num_params(tt.init_params(in_channels=in_channels, device="cpu")) == \
        jt.num_params(want)


def test_init_params_is_seeded():
    a = tt.params_to_tree(tt.init_params(seed=3, device="cpu"))
    b = tt.params_to_tree(tt.init_params(seed=3, device="cpu"))
    c = tt.params_to_tree(tt.init_params(seed=4, device="cpu"))
    np.testing.assert_array_equal(a["res2"]["conv1"]["kernel"], b["res2"]["conv1"]["kernel"])
    assert not np.array_equal(a["res2"]["conv1"]["kernel"], c["res2"]["conv1"]["kernel"])


def test_params_from_jax_round_trips(jax_params, port_params):
    """Module names follow the JAX keys, so the tree comes back unchanged."""
    assert "res3.in2.scale" in dict(port_params.named_parameters())
    back = tt.params_to_tree(port_params)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jax_params)
    for g, w in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jax_params)):
        np.testing.assert_array_equal(g, w)


def test_module_forward_is_apply(port_params):
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 16, 16, 3))
                         .astype(np.float32))
    assert torch.equal(port_params(x), tt.apply(port_params, x))


def test_zeros_pad_mode_waits_for_a_later_slice(jax_params, port_params):
    """pad_mode="zeros" runs the stacked forward, without autograd, against
    the JAX apply(pad_mode="zeros"). (The name predates the stacked form.)"""
    x = np.random.default_rng(3).standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jt.apply(jax_params, jnp.asarray(x), pad_mode="zeros"))
    before = conv3x3.launches, instance_norm.launches
    got = tt.apply(port_params, torch.from_numpy(x), pad_mode="zeros")
    assert (conv3x3.launches, instance_norm.launches) == before
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    with pytest.raises(ValueError, match="pad_mode"):
        tt.apply(port_params, torch.zeros(1, 16, 16, 3), pad_mode="circular")
