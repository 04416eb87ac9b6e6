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
from styletransfer_tpu_torch.ops.cuda import (conv3x3, conv3x3_flat, conv_direct,
                                             fused_instance_norm, instance_norm)

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


# (B, H, W, C, O, bf16 route, forced): conv3x3_valid's shapes on the card
# and the route each runs in bf16 (every shape takes f32_fma in f32, see
# tests/test_torch_conv3x3_valid.py). wgmma, on the route valid_plan names:
# whole rows per tile (16, 32 and 64 wide); C = 64 and O = 136 (a second,
# mostly empty channel tile); C = 96 (a last chunk of 32 channels) with a
# last tile of 3 of its 4 rows below the image and O = 72. Partial tiles,
# whose rows x W positions leave the last A rows stale: 7 wide (36 rows of
# 252 positions, one tile holding the whole 9-row image), 75 wide (one row
# of 128 positions on 8 rows; three rows of 256 at the 300 px shape), 75
# wide on 10 rows (one row a tile), and 75 wide on 64 rows in tiles of 3,
# the last of one row. (The plan scores its tile at a batch of 4 whatever
# the batch: tests/test_torch_plan_invariance.py.)
# Rows wider than a TMA box, cut into segments: 260 wide as at 1040 px (and
# non-square, 7 rows), 1,008 wide as in a 4032 px photo, and 300 wide with a
# last segment past the image (C = 64, O = 72). mma.sync, forced: no plan
# reaches it, a caller asks for it with route="bf16_mma".
_VALID_SHAPES = [
    (2, 16, 16, 128, 128, "bf16_wgmma", False), (3, 9, 7, 64, 136, "bf16_wgmma", False),
    (2, 64, 64, 128, 128, "bf16_wgmma", False), (1, 32, 32, 128, 128, "bf16_wgmma", False),
    (2, 16, 16, 64, 136, "bf16_wgmma", False), (3, 7, 32, 96, 72, "bf16_wgmma", False),
    (9, 64, 64, 128, 128, "bf16_wgmma", False), (1, 8, 75, 128, 128, "bf16_wgmma", False),
    (4, 75, 75, 128, 128, "bf16_wgmma", False), (32, 10, 75, 64, 64, "bf16_wgmma", False),
    (2, 64, 75, 64, 64, "bf16_wgmma", False),
    (2, 7, 260, 128, 128, "bf16_wgmma", False), (1, 5, 1008, 128, 128, "bf16_wgmma", False),
    (1, 3, 300, 64, 72, "bf16_wgmma", False), (1, 3, 300, 64, 72, "bf16_mma", True),
]
_ROUTE_COUNTERS = {"f32_fma": "fma_launches", "bf16_mma": "mma_launches",
                   "bf16_wgmma": "wgmma_launches"}


def _valid_plan(shape, dtype):
    """The plan a shape of _VALID_SHAPES runs: the forced route in bf16."""
    B, H, W, C, O, route, forced = shape
    return conv3x3.valid_plan(B, H, W, C, O, dtype,
                              route=route if forced and dtype == torch.bfloat16 else None)


def _valid_inputs(cuda, dtype, shape, seed):
    B, H, W, C, O = shape[:5]
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(B, H + 2, W + 2, C, device=cuda, generator=g).to(dtype)
    w = (torch.randn(3, 3, C, O, device=cuda, generator=g) * 0.05).to(dtype)
    b = torch.randn(O, device=cuda, generator=g)
    return x, w, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _VALID_SHAPES)
@pytest.mark.parametrize("relu", [False, True])
def test_conv3x3_kernel_matches_plain(cuda, dtype, shape, relu):
    x, w, b = _valid_inputs(cuda, dtype, shape, 0)
    plan = _valid_plan(shape, dtype)
    route = plan.route
    before = conv3x3.launches, getattr(conv3x3, _ROUTE_COUNTERS[route])
    out, s, ss = (conv3x3.launch(x, w, b, relu, plan) if shape[6] else
                  conv3x3.conv3x3_valid(x, w, b, relu))
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
    plan = _valid_plan(shape, torch.bfloat16)
    first = conv3x3.launch(x, w, b, True, plan)
    second = conv3x3.conv3x3_valid(x, w, b, True) if not shape[6] else \
        conv3x3.launch(x, w, b, True, plan)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(first, second))


@pytest.mark.parametrize("W", [260, 1008])
def test_every_segment_width_of_a_wide_row_matches_plain(cuda, W):
    # Every segment count valid_plan weighs at this width, on both wgmma
    # configurations: a last segment past the image, rows of one to 51
    # segments' tiles; each repeats bit for bit.
    shape = (1, 5, W, 128, 128)
    x, w, b = _valid_inputs(cuda, torch.bfloat16, shape, 14)
    pout, ps, pss = conv3x3.conv3x3_valid_plain(x, w, b, True)
    for k in range(-(-W // conv3x3.MAX_SEGMENT), conv3x3.MAX_SEGMENTS + 1, 3):
        for bm, stages in conv3x3.WGMMA_CONFIGS:
            seg = -(-W // k)
            if seg > bm:
                continue
            plan = conv3x3.wgmma_plan(1, 5, W, 128, bm, stages, seg)
            out, s, ss = conv3x3.launch(x, w, b, True, plan)
            again = conv3x3.launch(x, w, b, True, plan)
            torch.cuda.synchronize()
            _close(out, pout, torch.bfloat16)
            torch.testing.assert_close(s, ps, rtol=1e-4, atol=1e-2)
            torch.testing.assert_close(ss, pss, rtol=1e-4, atol=1e-2)
            assert all(torch.equal(u, v) for u, v in zip((out, s, ss), again)), plan


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


# Each branch of instance_norm.in_plan: (route in both dtypes, shape, pad,
# mode, residual pad or None, statistics given, residual added in f32 as the
# training forward does). l2: bands of 2 rows; bands of 1 row under a pad of
# 4, whose border rows come from other blocks' bands; a residual rounded to
# x's dtype; a residual added in f32; images of 16-row bands, without and
# with a residual (rounded, then added in f32). sums: statistics given.
# Tiny images: 3 x 5 with four channels (a cluster of 2; in bf16 8-byte
# accesses) and one pixel under edge padding.
_IN_PLAN_CASES = [
    ("l2", (2, 32, 32, 64), 1, "reflect", None, False, False),
    ("l2", (2, 16, 16, 32), 4, "reflect", None, False, False),
    ("l2", (2, 32, 32, 128), 1, "reflect", 1, False, False),
    ("l2", (2, 32, 32, 128), 0, "reflect", 0, False, True),
    ("l2", (1, 256, 256, 32), 1, "reflect", None, False, False),
    ("l2", (1, 256, 256, 32), 4, "edge", 1, False, False),
    ("l2", (1, 128, 128, 64), 0, "reflect", 0, False, True),
    ("sums", (2, 16, 16, 128), 1, "reflect", None, True, False),
    ("l2", (1, 3, 5, 4), 1, "edge", None, False, False),
    ("l2", (1, 1, 1, 4), 2, "edge", None, False, False),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _IN_PLAN_CASES)
def test_instance_norm_plan_branches_match_plain_and_repeat(cuda, dtype, case):
    route, (N, H, W, C), pad, mode, rp, with_stats, res_f32 = case
    g = torch.Generator(device=cuda).manual_seed(4)
    x = (torch.randn(N, H, W, C, device=cuda, generator=g) * 3 + 1).to(dtype)
    scale = torch.rand(C, device=cuda, generator=g) + 0.5
    bias = torch.randn(C, device=cuda, generator=g)
    res = None
    if rp is not None:
        res = torch.randn(N, H + 2 * rp, W + 2 * rp, C, device=cuda, generator=g).to(dtype)
    stats = None
    if with_stats:
        stats = (x.float().sum(dim=(1, 2)), (x.float() ** 2).sum(dim=(1, 2)))
    plan = instance_norm.in_plan(N, H, W, C, dtype, with_stats)
    assert plan.route == route
    if res_f32:  # the training forward: pad 0, the residual added in f32
        before = fused_instance_norm.fwd_launches
        first = fused_instance_norm.forward(x, scale, bias, res, True)
        again = fused_instance_norm.forward(x, scale, bias, res, True)
        torch.cuda.synchronize()
        assert fused_instance_norm.fwd_launches == before + 2
        pout, pmean, pinv = fused_instance_norm.forward_plain(x, scale, bias, res, True)
        torch.testing.assert_close(first[1], pmean, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(first[2], pinv, rtol=1e-5, atol=1e-5)
        _close(first[0], pout, dtype)
    else:
        args = (x, scale, bias, res, rp or 0, True, pad, mode, stats)
        before = instance_norm.launches
        first = (instance_norm.instance_norm_pad(*args),)
        again = (instance_norm.instance_norm_pad(*args),)
        torch.cuda.synchronize()
        assert instance_norm.launches == before + 2
        _close(first[0], instance_norm.instance_norm_pad_plain(*args), dtype)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_instance_norm_clusters_fit_the_device(cuda):
    # The 16-block clusters of the serving shapes: the device places at
    # least one of each plan at once, so no launch of theirs is refused.
    for dtype in (torch.float32, torch.bfloat16):
        for H, C in ((256, 32), (128, 64), (64, 128)):
            x = torch.zeros(1, H, H, C, device=cuda, dtype=dtype)
            plan = instance_norm.in_plan(64, H, H, C, dtype, False)
            assert instance_norm.max_active_clusters(x, plan) >= 1


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


# The training forward's call shapes at batch 4, 256 px (in1 and up2_in,
# in2 and up1_in, in3 and the residual blocks' norms).
_TRAIN_SHAPES = [(4, 256, 256, 32), (4, 128, 128, 64), (4, 64, 64, 128)]


def _rel_to_max(a, b):
    """max |a - b| over max |b|: a sum's error against the sums' scale."""
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _TRAIN_SHAPES)
@pytest.mark.parametrize("with_res,relu", [(False, False), (False, True), (True, False),
                                           (True, True)])
def test_fused_instance_norm_backward_at_the_training_shapes(cuda, dtype, shape, with_res,
                                                              relu):
    # One launch per call; dx within the kernel tolerance of the plain
    # version given the same statistics, dscale and dbias (sums over 4 x
    # H x W pixels in another order) within 1e-5 of their largest value;
    # bit-identical on repeat, and the same sums without the dx pass.
    g = torch.Generator(device=cuda).manual_seed(7)
    x = (torch.randn(*shape, device=cuda, generator=g) * 2 + 0.5).to(dtype)
    res = torch.randn(*shape, device=cuda, generator=g).to(dtype) if with_res else None
    scale = torch.rand(shape[3], device=cuda, generator=g) + 0.5
    bias = torch.randn(shape[3], device=cuda, generator=g)
    gy = torch.randn(*shape, device=cuda, generator=g).to(dtype)
    _, mean, inv = fused_instance_norm.forward(x, scale, bias, res, relu)
    before = fused_instance_norm.bwd_launches
    first = fused_instance_norm.backward(gy, x, res, mean, inv, scale, bias, relu)
    again = fused_instance_norm.backward(gy, x, res, mean, inv, scale, bias, relu)
    sums_only = fused_instance_norm.backward(gy, x, res, mean, inv, scale, bias, relu,
                                             need_dx=False)
    torch.cuda.synchronize()
    assert fused_instance_norm.bwd_launches == before + 3
    pdx, pdscale, pdbias = fused_instance_norm.backward_plain(gy, x, res, mean, inv, scale,
                                                              bias, relu)
    _close(first[0], pdx, dtype)
    assert _rel_to_max(first[1], pdscale) <= 1e-5
    assert _rel_to_max(first[2], pdbias) <= 1e-5
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert sums_only[0] is None
    assert torch.equal(sums_only[1], first[1]) and torch.equal(sums_only[2], first[2])


def test_fused_instance_norm_backward_grid_fits_the_device(cuda):
    # The cooperative launch is refused past the blocks the device holds at
    # once: every plan of the training shapes stays within them.
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.zeros(1, 4, 4, 4, device=cuda, dtype=dtype)
        resident = fused_instance_norm._resident(x.device, dtype)
        assert resident >= torch.cuda.get_device_properties(cuda).multi_processor_count
        for shape in _TRAIN_SHAPES + [(64, 64, 64, 128), (600, 4, 4, 8)]:
            assert fused_instance_norm.bwd_plan(*shape, resident).blocks <= resident


@pytest.mark.parametrize("resident", [None, 2, 3])
def test_fused_instance_norm_backward_with_few_workers(cuda, resident):
    # Each worker takes several chunks when the images outnumber the
    # workers: 600 small images on the device's blocks, and on one or two
    # workers (a plan for a device that holds 2 or 3 blocks at once).
    shape = (600, 4, 4, 8) if resident is None else (3, 9, 7, 128)
    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(*shape, device=cuda, generator=g)
    C = shape[3]
    scale, bias = torch.rand(C, device=cuda, generator=g) + 0.5, torch.randn(C, device=cuda)
    gy = torch.randn(*shape, device=cuda, generator=g)
    _, mean, inv = fused_instance_norm.forward(x, scale, bias, None, True)
    key = (torch.cuda.current_device(), torch.float32)
    found = fused_instance_norm._resident(x.device, torch.float32)
    try:
        fused_instance_norm._RESIDENT[key] = resident or found
        plan = fused_instance_norm.bwd_plan(*shape, resident or found)
        assert plan.blocks - 1 < shape[0] * plan.image_chunks
        dx, dscale, dbias = fused_instance_norm.backward(gy, x, None, mean, inv, scale, bias,
                                                         True)
        torch.cuda.synchronize()
    finally:
        fused_instance_norm._RESIDENT[key] = found
    pdx, pdscale, pdbias = fused_instance_norm.backward_plain(gy, x, None, mean, inv, scale,
                                                              bias, True)
    _close(dx, pdx, torch.float32)
    assert _rel_to_max(dscale, pdscale) <= 1e-5 and _rel_to_max(dbias, pdbias) <= 1e-5


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
    # O <= 4 on the narrow tile unsplit (flat_plan plans tiles and splits for
    # a batch of 4, whatever the batch).
    (1, 260, 260, 8, 3),
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


# (B, H, W, C, O): conv3x3_im2col's band route (see im2col_plan in
# tests/test_torch_conv3x3_flat.py) on VGG conv1_1 at 256 px, as a Gatys
# closure (batch 1) and a train step or a 4-image Gatys directory (batch 4)
# run it; then what the route distinguishes: C = 1, 2 and 4, odd widths, an
# image smaller than one tile, O = 3 (a mostly empty chunk, element stores),
# O = 130 (three chunks, element stores in bf16) and 136 (a last chunk of 8
# channels), and a row wider than a tile (W = 300). In f32 conv1_1 at batch
# 4 and the last two walk more than one tile a block, so their tiles go out
# by bulk stores: O = 36 with an odd width, and 5-wide images of 9 rows (a
# bulk copy per row).
_CONV1_1_SHAPES = [(1, 256, 256, 3, 64), (4, 256, 256, 3, 64)]
_BAND_SHAPES = _CONV1_1_SHAPES + [
    (2, 9, 7, 1, 3), (1, 13, 33, 2, 64), (3, 11, 5, 4, 130), (1, 1, 1, 3, 64),
    (2, 21, 300, 3, 136), (1, 40, 37, 3, 64), (9, 61, 125, 1, 36), (300, 9, 5, 4, 8),
]


def _im2col_inputs(cuda, dtype, shape, seed):
    B, H, W, C, O = shape
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(B, H + 2, W + 2, C, device=cuda, generator=g).to(dtype)
    w = (torch.randn(3, 3, C, O, device=cuda, generator=g) * (9 * C) ** -0.5).to(dtype)
    b = torch.randn(O, device=cuda, generator=g)
    return x, w, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _BAND_SHAPES)
@pytest.mark.parametrize("relu", [False, True])
def test_conv3x3_im2col_band_route_matches_plain(cuda, dtype, shape, relu):
    assert conv3x3_flat.im2col_plan(*shape, dtype).route == "band"
    x, w, b = _im2col_inputs(cuda, dtype, shape, 11)
    before = conv3x3_flat.im2col_launches
    out = conv3x3_flat.conv3x3_im2col(x, w, b, relu)
    torch.cuda.synchronize()
    assert conv3x3_flat.im2col_launches == before + 1
    assert out.shape == shape[:3] + shape[4:] and out.dtype == dtype
    _close(out, conv3x3_flat.conv3x3_im2col_plain(x, w, b, relu), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _CONV1_1_SHAPES + _STAT_FREE_SHAPES[:6])
def test_conv3x3_im2col_repeats_bit_for_bit(cuda, dtype, shape):
    # No atomics on either route: two calls on the same inputs give the same
    # bits.
    x, w, b = _im2col_inputs(cuda, dtype, shape, 12)
    first = conv3x3_flat.conv3x3_im2col(x, w, b, True)
    second = conv3x3_flat.conv3x3_im2col(x, w, b, True)
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


@pytest.mark.parametrize("precision,steps", [("f32", 1), ("bf16", 16)])
def test_zeros_serve_on_the_kernels_matches_the_cpu(cuda, precision, steps):
    """pad_mode="zeros" (a reference .pth): per forward 10 conv3x3_flat (the
    residual convs, through conv3x3_same) and 15 fused-IN forwards, neither
    conv3x3_valid nor IN-pad."""
    from styletransfer_tpu_torch.engines import fast

    params = transformer.init_params(seed=2, device="cpu")
    params_gpu = transformer.params_from_jax(transformer.params_to_tree(params), device=cuda)
    batch = torch.from_numpy(
        np.random.default_rng(1).integers(0, 256, size=(2, 64, 64, 3), dtype=np.uint8))
    serve = fast.make_serve_fn(precision, "zeros")

    def counts():
        return (conv3x3_flat.flat_launches, conv3x3_flat.im2col_launches,
                fused_instance_norm.fwd_launches, fused_instance_norm.bwd_launches,
                conv3x3.launches, instance_norm.launches)

    before = counts()
    got = serve(params_gpu, batch.to(cuda)).cpu()
    assert tuple(a - b for a, b in zip(counts(), before)) == (10, 0, 15, 0, 0, 0)
    want = serve(params, batch)
    assert int((got.int() - want.int()).abs().max()) <= steps


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_flat_at_the_zeros_residual_shape(cuda, dtype):
    """The residual conv of a zero-padded 256 px forward at batch 64:
    x [64, 66, 66, 128] -> 128, against the plain version, and repeated."""
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.nn.functional.pad(torch.randn(64, 64, 64, 128, device=cuda, generator=g),
                                (0, 0, 1, 1, 1, 1)).to(dtype)
    w = (torch.randn(3, 3, 128, 128, device=cuda, generator=g) / 34).to(dtype)
    b = torch.randn(128, device=cuda, generator=g)
    out = conv3x3_flat.conv3x3_flat(x, w, b)
    again = conv3x3_flat.conv3x3_flat(x, w, b)
    torch.cuda.synchronize()
    _close(out, conv3x3_flat.conv3x3_flat_plain(x, w, b), dtype)
    assert torch.equal(out, again)


@pytest.mark.parametrize("pad_mode", ["reflect", "zeros"])
def test_stylize_clip_on_the_kernels_matches_the_cpu(cuda, pad_mode):
    from styletransfer_tpu_torch.engines import video

    params = transformer.init_video_params(seed=3, device="cpu")
    params_gpu = transformer.params_from_jax(transformer.params_to_tree(params), device=cuda)
    frames = np.random.default_rng(2).integers(0, 256, size=(3, 2, 64, 64, 3), dtype=np.uint8)
    got = video.stylize_clip(params_gpu, frames, pad_mode=pad_mode)
    want = video.stylize_clip(params, frames, pad_mode=pad_mode)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# conv_direct at the video stylizer's library convs at 256 px (batch 2):
# (input [H, W, C] pre-padded, K, stride, O). The pad-early forward's conv1
# (6 channels), conv2, conv3, the phase-form up1 and up2 and the
# space-to-depth conv_out; the stacked (zeros) forward's 3-channel conv1,
# upsampled 3x3 convs and 9x9 conv_out; odd shapes: a 2x2 kernel at stride
# 2, channel counts no tile divides, a last pixel tile in part.
_DIRECT_SHAPES = [
    ((264, 264, 6), 9, 1, 32), ((258, 258, 32), 3, 2, 64), ((130, 130, 64), 3, 2, 128),
    ((66, 66, 128), 3, 1, 256), ((130, 130, 64), 3, 1, 128), ((66, 66, 512), 3, 1, 48),
    ((264, 264, 3), 9, 1, 32), ((130, 130, 128), 3, 1, 64), ((258, 258, 64), 3, 1, 32),
    ((264, 264, 32), 9, 1, 3),
    ((9, 11, 5), 2, 2, 7), ((7, 6, 12), 3, 1, 130), ((13, 17, 6), 3, 1, 6),
]


def _direct_inputs(cuda, dtype, shape, batch=2, seed=9):
    (H, W, C), K, stride, O = shape
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(batch, H, W, C, device=cuda, generator=g).to(dtype)
    w = (torch.randn(K, K, C, O, device=cuda, generator=g) * (K * K * C) ** -0.5).to(dtype)
    b = torch.randn(O, device=cuda, generator=g) * 0.1
    return x, w, b, stride


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _DIRECT_SHAPES)
def test_conv_direct_matches_plain_and_repeats_bit_for_bit(cuda, dtype, shape):
    x, w, b, stride = _direct_inputs(cuda, dtype, shape)
    before = conv_direct.launches
    out = conv_direct.conv_direct(x, w, b, stride)
    again = conv_direct.conv_direct(x, w, b, stride)
    torch.cuda.synchronize()
    assert conv_direct.launches == before + 2
    _close(out, conv_direct.conv_direct_plain(x, w, b, stride), dtype)
    assert torch.equal(out, again)
    nobias = conv_direct.conv_direct(x, w, None, stride)
    _close(nobias, conv_direct.conv_direct_plain(x, w, None, stride), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _DIRECT_SHAPES[:6])
def test_conv_direct_lane_is_the_image_alone(cuda, dtype, shape):
    x, w, b, stride = _direct_inputs(cuda, dtype, shape, batch=4, seed=10)
    many = conv_direct.conv_direct(x, w, b, stride)
    for i in range(4):
        assert torch.equal(many[i:i + 1], conv_direct.conv_direct(x[i:i + 1], w, b, stride))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    ((3, 16, 16, 32), 1, True, None, "reflect", False),
    ((3, 16, 16, 128), 1, False, 1, "edge", False),
    ((3, 12, 12, 128), 1, True, None, "reflect", True),
    ((2, 64, 64, 64), 4, True, None, "reflect", False),
])
def test_instance_norm_per_image_affines_match_plain(cuda, dtype, case):
    """IN-pad with [N, C] affines against the plain version; with each
    image's row equal to a [C] affine it gives that call's bits."""
    (N, H, W, C), pad, relu, rp, mode, with_stats = case
    g = torch.Generator(device=cuda).manual_seed(6)
    x = (torch.randn(N, H, W, C, device=cuda, generator=g) * 3 + 1).to(dtype)
    scale = torch.rand(N, C, device=cuda, generator=g) + 0.5
    bias = torch.randn(N, C, device=cuda, generator=g)
    res = None
    if rp is not None:
        res = torch.randn(N, H + 2 * rp, W + 2 * rp, C, device=cuda, generator=g).to(dtype)
    stats = (x.float().sum(dim=(1, 2)), (x.float() ** 2).sum(dim=(1, 2))) if with_stats else None
    args = (res, rp or 0, relu, pad, mode, stats)
    out = instance_norm.instance_norm_pad(x, scale, bias, *args)
    torch.cuda.synchronize()
    _close(out, instance_norm.instance_norm_pad_plain(x, scale, bias, *args), dtype)
    one = instance_norm.instance_norm_pad(x, scale[1], bias[1], *args)
    same = instance_norm.instance_norm_pad(x, scale[1].expand(N, C).contiguous(),
                                           bias[1].expand(N, C).contiguous(), *args)
    assert torch.equal(one, same)


def _frames_of(video):
    """Wraps video._open_video_writer so that each output's frames are kept
    by path. Returns (frames by path, restore)."""
    seen, real = {}, video._open_video_writer

    class Recorder:
        def __init__(self, writer, frames):
            self.writer, self.frames = writer, frames

        def append_data(self, frame):
            self.frames.append(np.array(frame))
            self.writer.append_data(frame)

        def close(self):
            self.writer.close()

    def opener(base, fps, logger):
        writer, path = real(base, fps, logger)
        return Recorder(writer, seen.setdefault(path, [])), path

    video._open_video_writer = opener
    return seen, lambda: setattr(video, "_open_video_writer", real)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("pad_mode", ["reflect", "zeros"])
@pytest.mark.parametrize("batch", [2, 4])
def test_convert_dir_lanes_are_each_clip_alone(cuda, tmp_path, precision, pad_mode, batch):
    """Five clips of 2 to 6 frames (a ragged last group at batch 2 and 4):
    each clip's frames from convert-dir are bit for bit its own
    convert-video's, over the whole clip (the port of
    tests/test_video_io.py's contract)."""
    from PIL import Image

    from styletransfer_tpu_torch.data import coco
    from styletransfer_tpu_torch.engines import video

    clips = tmp_path / "clips"
    clips.mkdir()
    for i, n in enumerate((3, 6, 2, 5, 4)):
        base = np.round(coco.synthetic_image(70 + i, 256) * 255).astype(np.uint8)
        imgs = [Image.fromarray(np.roll(base, 3 * t, axis=1)) for t in range(n)]
        imgs[0].save(clips / f"c{i}.gif", save_all=True, append_images=imgs[1:], duration=42)
    params = transformer.init_video_params(seed=5, device=cuda)
    seen, restore = _frames_of(video)
    try:
        outs = video.process_video_dir(str(clips), "lanes", out_dir=str(tmp_path / "dir"),
                                       batch_size=batch, params=params, chunk_size=4,
                                       precision=precision, pad_mode=pad_mode, device=cuda)
        for i, out in enumerate(outs):
            alone = video.process_video(str(clips / f"c{i}.gif"), "lanes",
                                        out_dir=str(tmp_path / f"one{i}"), params=params,
                                        chunk_size=3, precision=precision, pad_mode=pad_mode,
                                        device=cuda)
            assert len(seen[out]) == len(seen[alone]) == (3, 6, 2, 5, 4)[i]
            np.testing.assert_array_equal(np.stack(seen[out]), np.stack(seen[alone]))
    finally:
        restore()


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("pad_mode", ["reflect", "zeros"])
def test_stylize_clip_lanes_are_bit_identical_at_every_batch(cuda, precision, pad_mode):
    from styletransfer_tpu_torch.engines import video

    params = transformer.init_video_params(seed=6, device=cuda)
    frames = np.random.default_rng(8).integers(0, 256, size=(4, 4, 256, 256, 3), dtype=np.uint8)
    four = video.stylize_clip(params, frames, precision, pad_mode)
    two = video.stylize_clip(params, frames[:, 2:], precision, pad_mode)
    for j in range(4):
        one = video.stylize_clip(params, frames[:, j], precision, pad_mode)
        assert np.array_equal(four[:, j], one)
    assert np.array_equal(four[:, 2:], two)


@pytest.mark.parametrize("precision,steps", [("f32", 1), ("bf16", 16)])
def test_multistyle_on_the_kernels_matches_the_cpu(cuda, precision, steps):
    """A mixed batch by index and by blend: 10 conv3x3_valid and 15 IN-pad
    launches (per-image affines) per forward, against the port's CPU run."""
    from styletransfer_tpu_torch.models import multistyle
    from styletransfer_tpu_torch.utils import images

    params = multistyle.init_params(seed=1, num_styles=3, device="cpu")
    with torch.no_grad():
        for m in params.modules():
            if isinstance(m, transformer.InstanceNorm):
                m.scale.add_(torch.randn(m.scale.shape, generator=torch.Generator().manual_seed(
                    m.scale.shape[1])) * 0.3)
    params_gpu = multistyle.params_from_jax(transformer.params_to_tree(params), device=cuda)
    x = images.maybe_normalize_on_device(torch.from_numpy(
        np.random.default_rng(3).integers(0, 256, size=(3, 64, 64, 3), dtype=np.uint8)))
    cd = torch.bfloat16 if precision == "bf16" else None
    idx = torch.tensor([2, 0, 1])
    w = torch.tensor([[0.5, 0.5, 0.0], [0.2, 0.3, 0.5], [0.0, 0.0, 1.0]])
    for fn, arg in ((multistyle.apply, idx), (multistyle.apply_blend, w)):
        before = conv3x3.launches, instance_norm.launches
        got = fn(params_gpu, x.to(cuda), arg.to(cuda), cd)
        assert (conv3x3.launches - before[0], instance_norm.launches - before[1]) == (10, 15)
        want = fn(params, x, arg, cd)
        u8 = images.to_uint8_on_device
        assert int((u8(got.cpu()).int() - u8(want).int()).abs().max()) <= steps
