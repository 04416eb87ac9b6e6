"""The decoder's phase-form upsample conv (ops/cuda/upconv_phase.py) on the
CPU: its plain version against the forward's former three steps and against
the conv it stands for, ``conv3x3(reflect_pad(upsample2(s), 1)) + b``; the
wrapper's checks; the kernel source's constants."""

import os
import re

import pytest
import torch
import torch.nn.functional as F

from styletransfer_tpu_torch.ops import layers
from styletransfer_tpu_torch.ops.cuda import upconv_phase as up

# The transform net's two (C, O) pairs: up1_conv and up2_conv.
PAIRS = [(128, 64), (64, 32)]


def _inputs(B, h, w, C, O, seed=0):
    g = torch.Generator().manual_seed(seed)
    s = torch.randn(B, h, w, C, generator=g)
    k = torch.randn(3, 3, C, O, generator=g) / (9 * C) ** 0.5
    b = torch.randn(O, generator=g) * 0.1
    return s, k, b


@pytest.mark.parametrize("C,O", PAIRS)
def test_plain_is_the_phase_conv_bias_and_depth_to_space(C, O):
    s, k, b = _inputs(2, 5, 7, C, O)
    y = layers.edge_pad(s, 1)
    want = layers.depth_to_space(
        layers.conv2d(y, layers.upsample_phase_kernel(k), b.repeat(4)), 2)
    got = up.upconv_phase(y, layers.upsample_phase_taps(k), b)
    assert torch.equal(got, want)


@pytest.mark.parametrize("C,O", PAIRS)
@pytest.mark.parametrize("B,h,w", [(1, 7, 5), (3, 9, 11)])
def test_plain_is_the_upsampled_conv(C, O, B, h, w):
    s, k, b = _inputs(B, h, w, C, O, seed=B)
    u = layers.reflect_pad(layers.upsample_nearest(s, 2), 1)
    want = F.conv2d(u.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1)).permute(0, 2, 3, 1) + b
    got = up.upconv_phase(layers.edge_pad(s, 1), layers.upsample_phase_taps(k), b)
    assert got.shape == (B, 2 * h, 2 * w, O)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("y,taps,bias,error,match", [
    ((1, 6, 6, 96), (2, 2, 2, 2, 96, 32), (32,), ValueError, "C in"),
    ((1, 6, 6, 64), (2, 2, 2, 2, 64, 48), (48,), ValueError, "taps must be"),
    ((1, 6, 6, 64), (2, 2, 2, 2, 128, 32), (32,), ValueError, "taps must be"),
    ((1, 6, 6, 64), (3, 3, 64, 128), (32,), ValueError, "taps must be"),
    ((1, 6, 6, 64), (2, 2, 2, 2, 64, 32), (64,), ValueError, "bias must be"),
    ((1, 2, 6, 64), (2, 2, 2, 2, 64, 32), (32,), ValueError, "h, w >= 1"),
    ((6, 6, 64), (2, 2, 2, 2, 64, 32), (32,), ValueError, "y must be"),
])
def test_the_wrapper_refuses_shapes_it_cannot_take(y, taps, bias, error, match):
    with pytest.raises(error, match=match):
        up.upconv_phase(torch.zeros(y), torch.zeros(taps), torch.zeros(bias))


@pytest.mark.parametrize("which", ["y", "taps", "bias"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_the_wrapper_refuses_other_dtypes(which, dtype):
    args = {"y": torch.zeros(1, 6, 6, 64), "taps": torch.zeros(2, 2, 2, 2, 64, 32),
            "bias": torch.zeros(32)}
    args[which] = args[which].to(dtype)
    with pytest.raises(TypeError, match=f"{which} must be float32"):
        up.upconv_phase(**args)


def test_the_wrapper_has_no_backward():
    s, k, b = _inputs(1, 4, 4, 64, 32)
    with pytest.raises(NotImplementedError, match="no backward"):
        up.upconv_phase(layers.edge_pad(s, 1), layers.upsample_phase_taps(k.requires_grad_()), b)


def test_the_tiles_match_the_kernel_source():
    src = open(os.path.join(os.path.dirname(up.__file__), "..", "..", "csrc",
                            "upconv_phase.cu")).read()
    cases = re.findall(r"case (\d+): return run<(\d+)>", src)
    assert {(int(a), int(b)) for a, b in cases} == {(o, o) for o in up.OUT_CHANNELS}
    assert int(re.search(r"constexpr int CK = (\d+);", src).group(1)) == up.CHUNK
    assert all(c % up.CHUNK == 0 for c in up.IN_CHANNELS)
    # The kernel's name stays out of the benchmark's conv3x3_valid group.
    names = re.findall(r"__global__ void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(", src)
    assert names == ["upconv_phase_f32_kernel"]
    assert names and not any(n.startswith("conv3x3_") or "tile_sums_kernel" in n for n in names)
