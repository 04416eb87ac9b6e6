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


def test_upsample_nearest_and_max_pool_equal_exactly(rng):
    x = _x(rng, (2, 6, 4, 5))
    np.testing.assert_array_equal(tl.upsample_nearest(torch.from_numpy(x), 2).numpy(),
                                  np.asarray(jl.upsample_nearest(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(tl.max_pool(torch.from_numpy(x), 2, 2).numpy(),
                                  np.asarray(jl.max_pool(jnp.asarray(x), 2, 2)))


@pytest.mark.parametrize("padding,stride,k", [("reflect", 1, 3), ("reflect", 2, 3),
                                              ("zeros", 1, 3), ("reflect", 1, 9)])
def test_padded_conv2d_and_its_gradients_match_jax(rng, padding, stride, k):
    """The convs of the stacked forward and VGG: value, and the gradients of
    input, kernel and bias (f32; summation order only)."""
    import jax

    x, w, b = _x(rng, (2, 10, 10, 4)), _x(rng, (k, k, 4, 6)) * 0.2, _x(rng, (6,))
    cot = _x(rng, (2, 10 // stride, 10 // stride, 6))

    def jfn(x_, w_, b_):
        out = jl.conv2d(x_, w_, b_, stride, reflect=padding == "reflect")
        return jnp.sum(out * cot), out

    (_, want), jg = jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    got = tl.conv2d(*leaves, stride, padding=padding)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for t, g in zip(leaves, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-4)


def test_conv2d_bf16_adds_the_bias_in_bf16(rng):
    x, w, b = _x(rng, (1, 6, 6, 4)), _x(rng, (3, 3, 4, 8)), _x(rng, (8,))
    got = tl.conv2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                    compute_dtype=torch.bfloat16, padding="zeros")
    plain = tl.conv2d(torch.from_numpy(x), torch.from_numpy(w), None,
                      compute_dtype=torch.bfloat16, padding="zeros")
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, plain + torch.from_numpy(b).bfloat16())


def test_conv2d_rejects_unknown_padding():
    with pytest.raises(ValueError, match="padding"):
        tl.conv2d(torch.zeros(1, 4, 4, 1), torch.zeros(3, 3, 1, 1), padding="same")


def test_instance_norm_matches_jax(rng):
    x = _x(rng, (2, 5, 6, 8)) * 3 + 1
    scale, bias = _x(rng, (2, 8)), _x(rng, (2, 8))  # conditional [B, C] affine
    np.testing.assert_allclose(
        tl.instance_norm(torch.from_numpy(x), torch.from_numpy(scale),
                         torch.from_numpy(bias)).numpy(),
        np.asarray(jl.instance_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))),
        rtol=1e-5, atol=1e-5)
