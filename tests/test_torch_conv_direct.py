"""The fixed-order conv (ops/cuda/conv_direct.py) on the CPU: its plain
version against the JAX forward's own conv (``layers.conv2d`` with
``valid=True``, ``jax.lax.conv_general_dilated``) at each of the video
stylizer's six library convs and the stacked forward's, cut to 32 px; its
plan; its checks."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletransfer_tpu.ops import layers as jlayers
from styletransfer_tpu_torch.ops.cuda import conv_direct as cd

# f32: the same products summed in another order (as
# tests/test_torch_transformer.py holds the forward). bf16: the port rounds
# the f32 sum (bias included) once to bf16, so it may land one step of its
# 8-bit mantissa from the f32 reference's rounding.
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2 ** -7, atol=1e-3)

# (name, input [H, W, C] (pre-padded), K, stride, O) at a 32 px frame: the
# pad-early forward's conv1 (3 and 6 channels), conv2, conv3, the two
# phase-form upsample convs and the space-to-depth conv_out; the stacked
# forward's 9x9 conv_out and its two upsampled 3x3 convs; and odd shapes (a
# 2x2 kernel at stride 2, channel counts no tile divides).
_SHAPES = [
    ("conv1", (40, 40, 3), 9, 1, 32), ("conv1_video", (40, 40, 6), 9, 1, 32),
    ("conv2", (34, 34, 32), 3, 2, 64), ("conv3", (18, 18, 64), 3, 2, 128),
    ("up1_phase", (10, 10, 128), 3, 1, 256), ("up2_phase", (18, 18, 64), 3, 1, 128),
    ("conv_out_s2d", (10, 10, 512), 3, 1, 48),
    ("conv_out_9x9", (40, 40, 32), 9, 1, 3), ("up1_conv", (18, 18, 128), 3, 1, 64),
    ("up2_conv", (34, 34, 64), 3, 1, 32),
    ("k2_s2", (9, 11, 5), 2, 2, 7), ("o130", (7, 6, 12), 3, 1, 130),
]


def _inputs(shape, K, O, seed=0, batch=2):
    rng = np.random.default_rng(seed)
    H, W, C = shape
    x = rng.standard_normal((batch, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((K, K, C, O)) / np.sqrt(K * K * C)).astype(np.float32)
    b = (rng.standard_normal(O) * 0.1).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("name,shape,K,stride,O", _SHAPES)
def test_plain_matches_the_jax_conv_f32(name, shape, K, stride, O):
    x, w, b = _inputs(shape, K, O)
    want = np.asarray(jlayers.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride,
                                     valid=True))
    got = cd.conv_direct(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), stride)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("name,shape,K,stride,O", _SHAPES)
def test_plain_matches_the_jax_conv_bf16(name, shape, K, stride, O):
    x, w, b = _inputs(shape, K, O, seed=1)
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    # The JAX conv in f32 of the same bf16 values, bias in f32, one rounding.
    want = jlayers.conv2d(jnp.asarray(xb.float().numpy()), jnp.asarray(wb.float().numpy()),
                          jnp.asarray(b), stride, valid=True)
    want = np.asarray(want.astype(jnp.bfloat16).astype(jnp.float32))
    got = cd.conv_direct(xb, wb, torch.from_numpy(b), stride)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


def test_without_a_bias_and_on_the_cpu_it_is_the_plain_version():
    x, w, _ = _inputs((10, 10, 512), 3, 48, seed=2)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    before = cd.launches
    got = cd.conv_direct(xt, wt)
    assert cd.launches == before  # the CPU runs no kernel
    assert torch.equal(got, cd.conv_direct_plain(xt, wt))
    want = np.asarray(jlayers.conv2d(jnp.asarray(x), jnp.asarray(w), None, 1, valid=True))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_an_image_in_a_batch_is_the_image_alone(dtype):
    x, w, b = _inputs((18, 18, 64), 3, 128, seed=3, batch=4)
    xt, wt, bt = torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype), torch.from_numpy(b)
    many = cd.conv_direct(xt, wt, bt, 2)
    for i in range(4):
        assert torch.equal(many[i:i + 1], cd.conv_direct(xt[i:i + 1], wt, bt, 2))


@pytest.mark.parametrize("O,want", [(256, 64), (128, 64), (64, 64), (48, 16), (32, 32),
                                    (3, 4), (6, 8), (7, 8), (130, 64), (1, 4), (12, 4)])
def test_the_tile_is_a_function_of_o_alone(O, want):
    plans = [cd.direct_plan(B, 64, 64, O) for B in range(1, 129)]
    assert {(p.to, p.tp) for p in plans} == {(want, cd.direct_plan(1, 64, 64, O).tp)}
    for B, p in enumerate(plans, start=1):
        assert p.blocks == B * -(-64 * 64 // p.tp) * -(-O // p.to)
    assert plans[0].tp == cd.THREADS // (want // 4) * dict(cd.TILES)[want]


def test_the_tiles_match_the_kernel_source():
    src = open(os.path.join(os.path.dirname(cd.__file__), "..", "..", "csrc",
                            "conv_direct.cu")).read()
    built = {(int(a), int(b)) for a, b in
             re.findall(r"case (\d+): return run<T, \d+, (\d+)>", src)}
    assert built == set(cd.TILES)


def test_the_wrapper_refuses_what_it_cannot_take():
    x = torch.randn(1, 10, 10, 8)
    with pytest.raises(ValueError, match="w must be"):
        cd.conv_direct(x, torch.randn(3, 3, 4, 8))
    with pytest.raises(ValueError, match="w must be"):
        cd.conv_direct(x, torch.randn(3, 2, 8, 8))
    with pytest.raises(TypeError, match="dtype"):
        cd.conv_direct(x, torch.randn(3, 3, 8, 8).bfloat16())
    with pytest.raises(ValueError, match="b must be"):
        cd.conv_direct(x, torch.randn(3, 3, 8, 8), torch.randn(4))
    with pytest.raises(ValueError, match="empty"):
        cd.conv_direct(x, torch.randn(11, 11, 8, 8))
    with pytest.raises(NotImplementedError, match="no backward"):
        cd.conv_direct(x.requires_grad_(), torch.randn(3, 3, 8, 8))
