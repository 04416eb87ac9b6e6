"""The port's CUDA kernels on the GPU, against their plain versions, and the
forward on the kernels against the forward on the CPU.

Needs an NVIDIA GPU and nvcc (the kernels are built at first use); every
test here skips without them. Run on the GPU machine with
``python -m pytest tests/test_torch_cuda.py -m cuda``.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from styletransfer_tpu_torch.models import transformer
from styletransfer_tpu_torch.ops import layers
from styletransfer_tpu_torch.ops.cuda import (conv3x3, conv3x3_flat, fused_instance_norm,
                                             instance_norm)

pytestmark = pytest.mark.cuda

# (rtol, atol): f32 is the same arithmetic in another summation order; in
# bf16 both sides round the same f32 value, so the last of 8 bits can flip.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2 ** -7, 1e-3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    if shutil.which("nvcc") is None and not os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("needs nvcc to build the kernels")
    layers.disable_tf32()
    return torch.device("cuda")


def _close(a, b, dtype):
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=atol)


# (B, H, W, C, O, bf16 route): conv3x3_valid's shapes on the card and the
# route each reaches in bf16 (valid_plan; every shape takes f32_fma in f32,
# see tests/test_torch_conv3x3_valid.py). wgmma: whole rows per tile (16, 32
# and 64 wide), at batch 9 the large tile; C = 64 and O = 136 (a second,
# mostly empty channel tile); C = 96 (a last chunk of 32 channels) with a
# last tile of 3 of its 4 rows below the image and O = 72. mma.sync: widths
# whose rows do not tile a block (7, and 75 as at 300 px).
_VALID_SHAPES = [
    (2, 16, 16, 128, 128, "bf16_wgmma"), (3, 9, 7, 64, 136, "bf16_mma"),
    (2, 64, 64, 128, 128, "bf16_wgmma"), (1, 32, 32, 128, 128, "bf16_wgmma"),
    (2, 16, 16, 64, 136, "bf16_wgmma"), (3, 7, 32, 96, 72, "bf16_wgmma"),
    (9, 64, 64, 128, 128, "bf16_wgmma"), (1, 8, 75, 128, 128, "bf16_mma"),
]
_ROUTE_COUNTERS = {"f32_fma": "fma_launches", "bf16_mma": "mma_launches",
                   "bf16_wgmma": "wgmma_launches"}


def _valid_inputs(cuda, dtype, shape, seed):
    B, H, W, C, O = shape[:5]
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(B, H + 2, W + 2, C, device=cuda, generator=g).to(dtype)
    w = (torch.randn(3, 3, C, O, device=cuda, generator=g) * 0.05).to(dtype)
    b = torch.randn(O, device=cuda, generator=g)
    return x, w, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [s[:5] for s in _VALID_SHAPES])
@pytest.mark.parametrize("relu", [False, True])
def test_conv3x3_kernel_matches_plain(cuda, dtype, shape, relu):
    x, w, b = _valid_inputs(cuda, dtype, shape, 0)
    route = conv3x3.valid_plan(*shape, dtype).route
    before = conv3x3.launches, getattr(conv3x3, _ROUTE_COUNTERS[route])
    out, s, ss = conv3x3.conv3x3_valid(x, w, b, relu)
    torch.cuda.synchronize()
    assert (conv3x3.launches, getattr(conv3x3, _ROUTE_COUNTERS[route])) == (
        before[0] + 1, before[1] + 1)
    pout, ps, pss = conv3x3.conv3x3_valid_plain(x, w, b, relu)
    _close(out, pout, dtype)
    torch.testing.assert_close(s, ps, rtol=1e-4, atol=1e-2)
    torch.testing.assert_close(ss, pss, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("shape", _VALID_SHAPES)
def test_conv3x3_valid_repeats_bit_for_bit(cuda, shape):
    # The per-tile partial sums are added in a fixed order with no atomics:
    # two calls on the same inputs give the same bits, sums included.
    x, w, b = _valid_inputs(cuda, torch.bfloat16, shape, 10)
    first = conv3x3.conv3x3_valid(x, w, b, True)
    second = conv3x3.conv3x3_valid(x, w, b, True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(first, second))


def test_the_two_bf16_routes_agree_on_the_residual_stage(cuda):
    shape = (2, 64, 64, 128, 128)
    x, w, b = _valid_inputs(cuda, torch.bfloat16, shape, 11)
    plan = conv3x3.valid_plan(*shape, torch.bfloat16)
    assert plan.route == "bf16_wgmma"
    mma = conv3x3.valid_plan(*shape, torch.bfloat16, route="bf16_mma")
    before = conv3x3.mma_launches
    got, want = conv3x3.launch(x, w, b, True, plan), conv3x3.launch(x, w, b, True, mma)
    torch.cuda.synchronize()
    assert conv3x3.mma_launches == before + 1
    _close(got[0], want[0], torch.bfloat16)
    for a, c in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-2)


def test_kernels_needing_an_smem_opt_in_run_on_a_second_gpu(cuda):
    # The shared-memory opt-in is per device: a call on cuda:1 after cuda:0
    # must opt in again there.
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs")
    for dev in (torch.device("cuda:0"), torch.device("cuda:1")):
        x, w, b = _valid_inputs(dev, torch.bfloat16, (2, 64, 64, 128, 128), 12)
        out, s, ss = conv3x3.conv3x3_valid(x, w, b, True)
        pout, ps, pss = conv3x3.conv3x3_valid_plain(x, w, b, True)
        _close(out, pout, torch.bfloat16)
        torch.testing.assert_close(s, ps, rtol=1e-4, atol=1e-2)
        for dtype in (torch.float32, torch.bfloat16):
            x, w, b = _valid_inputs(dev, dtype, (1, 64, 64, 128, 256), 13)
            _close(conv3x3_flat.conv3x3_flat(x, w, b, True),
                   conv3x3_flat.conv3x3_flat_plain(x, w, b, True), dtype)
        torch.cuda.synchronize(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    ((2, 16, 16, 32), 1, True, None, "reflect", False),
    ((2, 16, 16, 32), 4, True, None, "reflect", False),
    ((2, 16, 16, 128), 1, False, 1, "reflect", False),
    ((2, 9, 7, 128), 1, False, 1, "edge", False),
    ((2, 16, 16, 64), 0, False, 0, "reflect", False),
    ((2, 12, 12, 128), 1, True, None, "reflect", True),
    ((1, 300, 5, 4), 2, True, None, "edge", False),
])
def test_instance_norm_kernel_matches_plain(cuda, dtype, case):
    (N, H, W, C), pad, relu, rp, mode, with_stats = case
    g = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.randn(N, H, W, C, device=cuda, generator=g) * 3 + 1).to(dtype)
    scale = torch.rand(C, device=cuda, generator=g) + 0.5
    bias = torch.randn(C, device=cuda, generator=g)
    res = None
    if rp is not None:
        res = torch.randn(N, H + 2 * rp, W + 2 * rp, C, device=cuda, generator=g).to(dtype)
    stats = None
    if with_stats:
        stats = (x.float().sum(dim=(1, 2)), (x.float() ** 2).sum(dim=(1, 2)))
    args = (x, scale, bias, res, rp or 0, relu, pad, mode, stats)
    before = instance_norm.launches
    out = instance_norm.instance_norm_pad(*args)
    torch.cuda.synchronize()
    assert instance_norm.launches == before + 1
    _close(out, instance_norm.instance_norm_pad_plain(*args), dtype)


# (shape, residual, relu): every combination the training forward uses, plus
# ragged shapes (a chunk that does not divide H*W, four channels).
_FUSED_CASES = [
    ((2, 16, 16, 32), False, True),
    ((2, 9, 7, 128), True, False),
    ((2, 12, 12, 64), True, True),
    ((1, 300, 5, 4), False, False),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _FUSED_CASES)
def test_fused_instance_norm_kernels_match_plain(cuda, dtype, case):
    (N, H, W, C), with_res, relu = case
    g = torch.Generator(device=cuda).manual_seed(3)
    x = (torch.randn(N, H, W, C, device=cuda, generator=g) * 3 + 1).to(dtype)
    res = torch.randn(N, H, W, C, device=cuda, generator=g).to(dtype) if with_res else None
    scale = torch.rand(C, device=cuda, generator=g) + 0.5
    bias = torch.randn(C, device=cuda, generator=g)
    gy = torch.randn(N, H, W, C, device=cuda, generator=g).to(dtype)
    before = fused_instance_norm.fwd_launches, fused_instance_norm.bwd_launches
    out, mean, inv = fused_instance_norm.forward(x, scale, bias, res, relu)
    dx, dscale, dbias = fused_instance_norm.backward(gy, x, res, mean, inv, scale, bias, relu)
    torch.cuda.synchronize()
    assert (fused_instance_norm.fwd_launches, fused_instance_norm.bwd_launches) == \
        (before[0] + 1, before[1] + 1)
    pout, pmean, pinv = fused_instance_norm.forward_plain(x, scale, bias, res, relu)
    torch.testing.assert_close(mean, pmean, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(inv, pinv, rtol=1e-5, atol=1e-5)
    _close(out, pout, dtype)
    # The backward from the same statistics: the mask is bit-equal, the sums
    # over H*W (up to 1,500 pixels here) differ in order only.
    pdx, pdscale, pdbias = fused_instance_norm.backward_plain(gy, x, res, mean, inv, scale, bias,
                                                              relu)
    _close(dx, pdx, dtype)
    torch.testing.assert_close(dscale, pdscale, rtol=1e-4, atol=1e-2)
    torch.testing.assert_close(dbias, pdbias, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_instance_norm_gradients_on_the_card_match_the_cpu(cuda, dtype):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 16)).astype(np.float32)).to(dtype)
    res = torch.from_numpy(rng.standard_normal((2, 8, 8, 16)).astype(np.float32)).to(dtype)
    scale = torch.from_numpy((rng.random(16) + 0.5).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2, 8, 8, 16)).astype(np.float32))

    def grads(device):
        leaves = [t.to(device).requires_grad_() for t in (x, res, scale, bias)]
        out = fused_instance_norm.fused_instance_norm(leaves[0], leaves[2], leaves[3],
                                                      residual=leaves[1], relu=True)
        (out.float() * w.to(device)).sum().backward()
        return [t.grad.cpu() for t in leaves]

    before = fused_instance_norm.bwd_launches
    got = grads(cuda)
    assert fused_instance_norm.bwd_launches == before + 1
    for a, b in zip(got, grads("cpu")):
        _close(a, b, dtype)


def test_wrappers_raise_on_cuda_tensors_they_cannot_take(cuda):
    x = torch.zeros(1, 6, 6, 32, device=cuda)
    w = torch.zeros(3, 3, 32, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3.conv3x3_valid(x.transpose(1, 2), w, torch.zeros(8, device=cuda))
    with pytest.raises(ValueError, match="on"):
        conv3x3.conv3x3_valid(x, w, torch.zeros(8))
    with pytest.raises(ValueError, match="on"):
        instance_norm.instance_norm_pad(x, torch.ones(32), torch.zeros(32, device=cuda))


@pytest.mark.parametrize("fn", [conv3x3_flat.conv3x3_flat, conv3x3_flat.conv3x3_im2col])
def test_stat_free_conv_wrappers_raise_on_what_the_kernels_cannot_take(cuda, fn):
    x = torch.zeros(1, 6, 6, 3, device=cuda)
    w = torch.zeros(3, 3, 3, 8, device=cuda)
    b = torch.zeros(8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fn(x.transpose(1, 2), w, b)
    with pytest.raises(ValueError, match="on"):
        fn(x, w, torch.zeros(8))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fn(x.half(), w.half(), b)
    with pytest.raises(TypeError, match="dtype"):
        fn(x, w.bfloat16(), b)


# (B, H, W, C, O): the Gatys tower's channel pairs at small sizes, ragged
# channel counts on both sides, and a row width that is not a multiple of 4;
# then shapes that give conv3x3_flat's every plan in both dtypes (each tile
# of conv3x3_flat.FLAT_ROUTES, split and unsplit: see
# tests/test_torch_conv3x3_flat.py), among them O = 3, a 64 px conv of
# C = 256, and C = 44 and 37 (not a multiple of the chunk; not of 8, and not
# of 4: the element-wise loaders) with O = 130 (the element-wise weight
# loads and stores).
_STAT_FREE_SHAPES = [
    (1, 18, 18, 3, 64), (2, 16, 16, 64, 64), (1, 16, 16, 64, 3), (1, 8, 8, 128, 256),
    (2, 9, 7, 5, 13), (1, 11, 6, 40, 72),
    (4, 64, 64, 128, 256), (1, 64, 64, 256, 128), (1, 64, 64, 128, 256), (3, 128, 128, 64, 64),
    (16, 64, 64, 64, 3), (1, 40, 40, 44, 64), (1, 30, 30, 37, 130),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["flat", "im2col"])
@pytest.mark.parametrize("shape", _STAT_FREE_SHAPES)
@pytest.mark.parametrize("relu", [False, True])
def test_stat_free_conv_kernels_match_plain(cuda, dtype, kernel, shape, relu):
    B, H, W, C, O = shape
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(B, H + 2, W + 2, C, device=cuda, generator=g).to(dtype)
    w = (torch.randn(3, 3, C, O, device=cuda, generator=g) * (9 * C) ** -0.5).to(dtype)
    b = torch.randn(O, device=cuda, generator=g)
    fn = getattr(conv3x3_flat, f"conv3x3_{kernel}")
    before = getattr(conv3x3_flat, f"{kernel}_launches")
    out = fn(x, w, b, relu)
    torch.cuda.synchronize()
    assert getattr(conv3x3_flat, f"{kernel}_launches") == before + 1
    assert out.shape == (B, H, W, O) and out.dtype == dtype
    _close(out, conv3x3_flat.conv3x3_flat_plain(x, w, b, relu), dtype)
    _close(out, conv3x3_flat.conv3x3_im2col_plain(x, w, b, relu), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _STAT_FREE_SHAPES)
def test_conv3x3_flat_repeats_bit_for_bit(cuda, dtype, shape):
    # A split plan adds its partial sums in split order, whichever block
    # finishes last: two calls on the same inputs give the same bits.
    B, H, W, C, O = shape
    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(B, H + 2, W + 2, C, device=cuda, generator=g).to(dtype)
    w = (torch.randn(3, 3, C, O, device=cuda, generator=g) * (9 * C) ** -0.5).to(dtype)
    b = torch.randn(O, device=cuda, generator=g)
    first = conv3x3_flat.conv3x3_flat(x, w, b, True)
    second = conv3x3_flat.conv3x3_flat(x, w, b, True)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,O", [(3, 64), (64, 128), (64, 3)])
def test_conv3x3_same_and_its_input_gradient_match_the_cpu(cuda, dtype, C, O):
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 12, 10, C)).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.standard_normal((3, 3, C, O)) / np.sqrt(9 * C)).astype(
        np.float32)).to(dtype)
    b = torch.from_numpy(rng.standard_normal(O).astype(np.float32))
    gy = torch.from_numpy(rng.standard_normal((2, 12, 10, O)).astype(np.float32)).to(dtype)

    def run(device):
        xd = x.to(device).requires_grad_()
        y = conv3x3_flat.conv3x3_same(xd, w.to(device), b.to(device))
        y.backward(gy.to(device))
        return y.detach().cpu(), xd.grad.cpu()

    before = conv3x3_flat.flat_launches, conv3x3_flat.im2col_launches
    y, dx = run(cuda)
    forward_im2col = conv3x3_flat.uses_im2col(C)
    backward_im2col = conv3x3_flat.uses_im2col(O)
    assert (conv3x3_flat.flat_launches - before[0], conv3x3_flat.im2col_launches - before[1]) == (
        (not forward_im2col) + (not backward_im2col), forward_im2col + backward_im2col)
    y_cpu, dx_cpu = run("cpu")
    _close(y, y_cpu, dtype)
    _close(dx, dx_cpu, dtype)


def test_gatys_closure_on_the_kernels_matches_the_cpu(cuda):
    from styletransfer_tpu_torch.engines import gatys
    from styletransfer_tpu_torch.models import vgg

    rng = np.random.default_rng(7)
    content = torch.from_numpy(rng.standard_normal((1, 32, 32, 3)).astype(np.float32))
    style = torch.from_numpy(rng.standard_normal((1, 32, 32, 3)).astype(np.float32))
    pixels = torch.from_numpy(rng.standard_normal((1, 32, 32, 3)).astype(np.float32))
    params = vgg.init_params(seed=0, device="cpu")

    def closure(device):
        p = {k: {leaf: v.to(device) for leaf, v in d.items()} for k, d in params.items()}
        grams = vgg.style_gram_targets(p, style.to(device))
        loss_fn = gatys.make_loss_fn(p, content.to(device), grams)
        x = pixels.to(device).requires_grad_()
        before = conv3x3_flat.flat_launches, conv3x3_flat.im2col_launches
        loss = loss_fn(x)
        loss.sum().backward()
        launched = (conv3x3_flat.flat_launches - before[0],
                    conv3x3_flat.im2col_launches - before[1])
        return float(loss.detach()[0]), x.grad.cpu(), launched

    loss, grad, launched = closure(cuda)
    assert launched == (9, 1)
    loss_cpu, grad_cpu, _ = closure("cpu")
    assert abs(loss - loss_cpu) <= 1e-5 * abs(loss_cpu)
    assert float((grad - grad_cpu).norm() / grad_cpu.norm()) <= 1e-3


@pytest.mark.parametrize("precision,steps", [("f32", 1), ("bf16", 16)])
def test_serve_on_the_kernels_matches_the_cpu(cuda, precision, steps):
    from styletransfer_tpu_torch.engines import fast

    params = transformer.init_params(seed=0, device="cpu")
    params_gpu = transformer.params_from_jax(transformer.params_to_tree(params), device=cuda)
    batch = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, size=(2, 64, 64, 3), dtype=np.uint8))
    serve = fast.make_serve_fn(precision)
    route = "wgmma_launches" if precision == "bf16" else "fma_launches"
    before = conv3x3.launches, getattr(conv3x3, route), instance_norm.launches
    got = serve(params_gpu, batch.to(cuda)).cpu()
    assert (conv3x3.launches - before[0], getattr(conv3x3, route) - before[1],
            instance_norm.launches - before[2]) == (10, 10, 15)
    want = serve(params, batch)
    assert int((got.int() - want.int()).abs().max()) <= steps
