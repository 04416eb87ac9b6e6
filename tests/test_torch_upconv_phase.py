"""The decoders' phase-form upsample conv (ops/cuda/upconv_phase.py) on the
CPU: its plain version against the forward's former three steps and against
the conv it stands for, ``conv3x3(reflect_pad(upsample2(s), 1)) + b`` (and
its ReLU); the wrapper's checks; the kernel source's constants. On the card
(the ``cuda`` marker; they skip here) the kernel at AdaIN's shapes against
the plain version."""

import os
import re

import pytest
import torch
import torch.nn.functional as F

from styletransfer_tpu_torch.ops import layers
from styletransfer_tpu_torch.ops.cuda import upconv_phase as up

# The transform net's two (C, O) pairs, up1_conv and up2_conv, and AdaIN's
# decoder's three, up1 .. up3.
PAIRS = [(128, 64), (64, 32)]
ADAIN_PAIRS = [(256, 256), (128, 128), (64, 64)]


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


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("C,O", ADAIN_PAIRS)
def test_plain_is_the_upsampled_conv_at_adain_s_pairs(C, O, relu):
    s, k, b = _inputs(2, 5, 6, C, O, seed=C)
    u = layers.reflect_pad(layers.upsample_nearest(s, 2), 1)
    pre = F.conv2d(u.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1)).permute(0, 2, 3, 1) + b
    want = torch.relu(pre) if relu else pre
    got = up.upconv_phase(layers.edge_pad(s, 1), layers.upsample_phase_taps(k), b, relu=relu)
    assert got.shape == (2, 10, 12, O)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert float((pre < 0).float().mean()) > 0.2  # the ReLU has work to do
    assert (float(got.min()) == 0.0) == relu


@pytest.mark.parametrize("y,taps,bias,error,match", [
    ((1, 6, 6, 96), (2, 2, 2, 2, 96, 32), (32,), ValueError, "C in"),
    ((1, 6, 6, 512), (2, 2, 2, 2, 512, 256), (256,), ValueError, "C in"),
    ((1, 6, 6, 256), (2, 2, 2, 2, 256, 512), (512,), ValueError, "taps must be"),
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
    # OB = min(O, 64) channels a block: wider O is split over blocks.
    assert "static constexpr int OB = O < 64 ? O : 64;" in src
    assert int(re.search(r"constexpr int CK = (\d+);", src).group(1)) == up.CHUNK
    assert all(c % up.CHUNK == 0 for c in up.IN_CHANNELS)
    # The kernel's name stays out of the benchmark's conv3x3_valid group.
    names = re.findall(r"__global__ void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(", src)
    assert names == ["upconv_phase_f32_kernel"]
    assert names and not any(n.startswith("conv3x3_") or "tile_sums_kernel" in n for n in names)


# AdaIN's three shapes at batch 16 and 512 px: (B, h, w, C, O) of the small
# grid; a ragged grid at batch 1 for the widest.
_ADAIN_SHAPES = [(16, 64, 64, 256, 256), (16, 128, 128, 128, 128), (16, 256, 256, 64, 64),
                 (1, 37, 45, 256, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", _ADAIN_SHAPES)
def test_the_kernel_matches_plain_at_adain_s_shapes(shape, relu):
    """On the card: the kernel against the plain version (cuDNN's phase
    conv, TF32 off), the largest gap at most 1e-5 of the largest output;
    a repeat bit for bit; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the kernel has no CPU form")
    layers.disable_tf32()
    B, h, w, C, O = shape
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(h + C)
    y = layers.edge_pad(torch.randn(B, h, w, C, device=dev, generator=g), 1)
    k = torch.randn(3, 3, C, O, device=dev, generator=g) / (9 * C) ** 0.5
    b = torch.randn(O, device=dev, generator=g) * 0.1
    taps = layers.upsample_phase_taps(k)
    before = up.launches
    out = up.upconv_phase(y, taps, b, relu=relu)
    again = up.upconv_phase(y, taps, b, relu=relu)
    torch.cuda.synchronize()
    assert up.launches == before + 2
    want = up.upconv_phase_plain(y, taps, b, relu=relu)
    assert out.shape == want.shape == (B, 2 * h, 2 * w, O)
    assert float((out - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert torch.equal(out, again)
