"""The port's layers (styletransfer_tpu_torch/ops/layers.py) against the JAX
functions they copy, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletransfer_tpu.ops import layers as jl
from styletransfer_tpu_torch.ops import layers as tl


def _x(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("pad", [1, 2, 4])
@pytest.mark.parametrize("mode", ["reflect", "edge"])
def test_pads_equal_exactly(rng, mode, pad):
    x = _x(rng, (2, 9, 7, 5))
    jfn = jl.reflect_pad if mode == "reflect" else jl.edge_pad
    tfn = tl.reflect_pad if mode == "reflect" else tl.edge_pad
    np.testing.assert_array_equal(tfn(torch.from_numpy(x), pad).numpy(),
                                  np.asarray(jfn(jnp.asarray(x), pad)))


def test_reflect_pad_wider_than_input_raises():
    with pytest.raises(ValueError, match="reflect padding"):
        tl.reflect_pad(torch.zeros(1, 3, 3, 1), 3)


@pytest.mark.parametrize("block", [2, 4])
def test_space_to_depth_and_back_equal_exactly(rng, block):
    x = _x(rng, (2, 8, 12, 3))
    s = tl.space_to_depth(torch.from_numpy(x), block)
    np.testing.assert_array_equal(s.numpy(), np.asarray(jl.space_to_depth(jnp.asarray(x), block)))
    y = _x(rng, (2, 3, 5, block * block * 6))
    np.testing.assert_array_equal(
        tl.depth_to_space(torch.from_numpy(y), block).numpy(),
        np.asarray(jl.depth_to_space(jnp.asarray(y), block)),
    )
    np.testing.assert_array_equal(tl.depth_to_space(s, block).numpy(), x)


@pytest.mark.parametrize("k,block", [(9, 4), (9, 2), (5, 2)])
def test_phase_conv_kernel_matches_jax(rng, k, block):
    w = _x(rng, (k, k, 3, 4))
    np.testing.assert_allclose(
        tl.phase_conv_kernel(torch.from_numpy(w), block).numpy(),
        np.asarray(jl.phase_conv_kernel(jnp.asarray(w), block)), atol=1e-6,
    )


def test_phase_conv_kernel_rejects_bad_block():
    with pytest.raises(ValueError, match="divide"):
        tl.phase_conv_kernel(torch.zeros(5, 5, 1, 1), 4)


def test_upsample_phase_kernel_matches_jax(rng):
    w = _x(rng, (3, 3, 6, 5))
    np.testing.assert_allclose(
        tl.upsample_phase_kernel(torch.from_numpy(w)).numpy(),
        np.asarray(jl.upsample_phase_kernel(jnp.asarray(w))), atol=1e-6,
    )


@pytest.mark.parametrize("one_pass", [True, False])
def test_instance_norm_stats_match_jax(rng, one_pass):
    x = _x(rng, (3, 6, 5, 8)) * 2 + 1
    tm, ti = tl.instance_norm_stats(torch.from_numpy(x), one_pass=one_pass)
    jm, ji = jl.instance_norm_stats(jnp.asarray(x), one_pass=one_pass)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-6, rtol=1e-6)


def test_instance_norm_stats_phased_match_jax(rng):
    x = _x(rng, (2, 4, 3, 4 * 6))
    tm, ti = tl.instance_norm_stats_phased(torch.from_numpy(x))
    jm, ji = jl.instance_norm_stats_phased(jnp.asarray(x))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("relu", [False, True])
def test_instance_norm_affine_matches_jax(rng, relu):
    x = _x(rng, (2, 5, 5, 4))
    scale, bias = _x(rng, (4,)), _x(rng, (4,))
    tm, ti = tl.instance_norm_stats(torch.from_numpy(x))
    got = tl.instance_norm_affine(tl.reflect_pad(torch.from_numpy(x), 1), tm, ti,
                                  torch.from_numpy(scale), torch.from_numpy(bias), relu)
    jm, ji = jl.instance_norm_stats(jnp.asarray(x))
    want = jl.instance_norm_affine(jl.reflect_pad(jnp.asarray(x), 1), jm, ji,
                                   jnp.asarray(scale), jnp.asarray(bias), relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_valid_matches_jax(rng, stride):
    x = _x(rng, (2, 11, 10, 5))
    w = _x(rng, (3, 3, 5, 7)) * 0.3
    b = _x(rng, (7,))
    got = tl.conv2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), stride)
    want = jl.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride, valid=True)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_conv2d_bf16_compute_gives_bf16(rng):
    x = _x(rng, (1, 6, 6, 4))
    w = _x(rng, (3, 3, 4, 2)) * 0.3
    got = tl.conv2d(torch.from_numpy(x), torch.from_numpy(w), torch.zeros(2), 1,
                    compute_dtype=torch.bfloat16)
    want = jl.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.zeros(2), 1,
                     compute_dtype=jnp.bfloat16, valid=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2 ** -7, atol=1e-2)


def test_init_conv_and_instance_norm():
    gen = torch.Generator().manual_seed(0)
    k, b = tl.init_conv(gen, 3, 3, 8, 4)
    bound = 1.0 / np.sqrt(3 * 3 * 8)
    assert k.shape == (3, 3, 8, 4) and b.shape == (4,)
    assert float(k.abs().max()) <= bound and float(b.abs().max()) <= bound
    k2, _ = tl.init_conv(torch.Generator().manual_seed(0), 3, 3, 8, 4)
    assert torch.equal(k, k2)  # seeded
    s, z = tl.init_instance_norm(4)
    assert torch.equal(s, torch.ones(4)) and torch.equal(z, torch.zeros(4))
