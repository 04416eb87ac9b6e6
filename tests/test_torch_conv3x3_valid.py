"""conv3x3_valid's plan (``ops/cuda/conv3x3.py::valid_plan``), a pure
function of the shape that names the route and tile of each call, and the
wrapper against the JAX kernel it ports (``ops/pallas/conv3x3.py::
conv3x3_valid``, in interpret mode on the CPU) at the shapes that the CUDA
tests run on each route. The kernels themselves are held against the plain
version on the GPU (tests/test_torch_cuda.py, chip_smoke.py)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletransfer_tpu.ops.pallas.conv3x3 import conv3x3_valid as jax_conv3x3
from styletransfer_tpu_torch.ops.cuda import conv3x3 as tc

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(tc.__file__))), "..",
                     "csrc")


@pytest.mark.parametrize("batch", [1, 4, 64])
def test_the_residual_stage_takes_the_wgmma_route_in_bf16(batch):
    # The ten residual convs of a 256 px forward: [B, 66, 66, 128] -> 128.
    plan = tc.valid_plan(batch, 64, 64, 128, 128, torch.bfloat16)
    assert plan.route == "bf16_wgmma"
    assert (plan.bm, plan.stages) in tc.WGMMA_CONFIGS
    assert plan.bm % 64 == 0 and plan.image_tiles == 64 // (plan.bm // 64)
    tiles = batch * plan.image_tiles
    assert plan.blocks == min(tiles, tc.SMS)
    # The larger tile (fewer bytes from L2 per output) once its 16 tiles per
    # image fill the card.
    assert plan.bm == (256 if batch * 16 >= tc.SMS else 128)


@pytest.mark.parametrize("batch", [1, 64])
def test_a_75_wide_stage_takes_the_mma_route(batch):
    # convert-image --size 300: the residual stage is 75 x 75, whose rows do
    # not tile a block. It runs on the wgmma kernel all the same: at batch 64
    # a tile is 3 whole rows, 225 of 256 positions, 25 tiles per image; at
    # batch 1 the 128-position tile of one row, whose 75 tiles fill more of
    # the card than 25 larger ones would.
    plan = tc.valid_plan(batch, 75, 75, 128, 128, torch.bfloat16)
    assert plan.route == "bf16_wgmma"
    if batch == 64:
        assert (plan.bm, plan.stages, plan.image_tiles) == (256, 3, 25)
        assert plan.blocks == tc.SMS and batch * plan.image_tiles == 1600
    else:
        assert (plan.bm, plan.stages, plan.image_tiles, plan.blocks) == (128, 4, 75, 75)


@pytest.mark.parametrize("shape", [(1, 64, 64, 128, 128), (64, 64, 64, 128, 128),
                                   (2, 16, 16, 64, 136), (1, 75, 75, 128, 128)])
def test_f32_takes_the_fma_route(shape):
    B, H, W, C, O = shape
    plan = tc.valid_plan(B, H, W, C, O, torch.float32)
    assert plan.route == "f32_fma" and plan.bm == tc.BLOCK_M
    assert plan.blocks == B * -(-H * W // tc.BLOCK_M) * -(-O // tc.BLOCK_N)


@pytest.mark.parametrize("W,route", [(1, "bf16_wgmma"), (48, "bf16_wgmma"), (64, "bf16_wgmma"),
                                     (128, "bf16_wgmma"), (200, "bf16_wgmma"),
                                     (256, "bf16_wgmma"), (512, "bf16_mma")])
def test_the_wgmma_route_needs_whole_rows_in_a_tile(W, route):
    # A tile is floor(bm / W) >= 1 whole rows: every width up to 256 has one
    # (48 and 200 wide only partly fill theirs), wider rows go to mma.sync.
    plan = tc.valid_plan(2, 5, W, 64, 64, torch.bfloat16)
    assert plan.route == route
    if route == "bf16_wgmma":
        rows = plan.bm // W
        assert W <= 256 and rows >= 1 and rows * W <= plan.bm
        assert plan.image_tiles == -(-5 // rows)
    else:
        assert W > 256 and plan.stages == 0


def test_every_wgmma_configuration_is_one_the_kernel_has():
    source = open(os.path.join(_CSRC, "conv3x3_wgmma.cu")).read()
    entry = source[source.index("int stx_conv3x3_wgmma("):]
    entry = entry[:entry.index("\n}\n")]
    built = set()
    for line in entry.splitlines():
        if "bm == " in line:
            cond = line.split("if (")[1].split(")")[0]
            built.add(tuple(int(part.split("==")[1]) for part in cond.split("&&")))
    assert built == set(tc.WGMMA_CONFIGS)
    # The mma.sync and FMA kernels' block of positions and channels.
    src = open(os.path.join(_CSRC, "conv3x3.cu")).read()
    assert f"constexpr int BM = {tc.BLOCK_M};" in src
    assert f"constexpr int BN = {tc.BLOCK_N};" in src
    assert f"constexpr int BN = {tc.BLOCK_N};" in source


@pytest.mark.parametrize("C,O", [(48, 128), (128, 132)])
def test_the_wrapper_refuses_channels_the_routes_cannot_stride(C, O):
    # valid_plan sends any bf16 width whose rows tile a block to the TMA
    # kernel, whose 16-byte strides need C and O to be multiples of 8: the
    # wrapper's check (C % 32, O % 8) guarantees that for every route.
    x, w, b = torch.zeros(1, 6, 6, C), torch.zeros(3, 3, C, O), torch.zeros(O)
    with pytest.raises(ValueError, match="C % 32"):
        tc.conv3x3_valid(x, w, b)
    assert tc.valid_plan(1, 4, 4, 32, 8, torch.bfloat16).route == "bf16_wgmma"


def test_the_cuda_test_shapes_reach_the_route_each_is_meant_for():
    # tests/test_torch_cuda.py holds each route's kernel against the plain
    # version on the card at _VALID_SHAPES; each names the bf16 route it
    # exercises, and together they reach both bf16 routes and both wgmma
    # configurations.
    from test_torch_cuda import _VALID_SHAPES

    reached = set()
    for B, H, W, C, O, route in _VALID_SHAPES:
        plan = tc.valid_plan(B, H, W, C, O, torch.bfloat16)
        assert plan.route == route, (B, H, W, C, O)
        assert tc.valid_plan(B, H, W, C, O, torch.float32).route == "f32_fma"
        reached.add((plan.route, plan.bm, plan.stages))
    assert {r for r in reached if r[0] == "bf16_wgmma"} == {
        ("bf16_wgmma",) + c for c in tc.WGMMA_CONFIGS}
    assert any(r[0] == "bf16_mma" for r in reached)


def test_the_serving_forward_runs_every_residual_conv_on_the_wgmma_route():
    # The serving path's ten convs at 256 px, at 64 px (the CUDA serving
    # test's size) and at 300 px (75-wide rows, partial tiles); only images
    # over 1,024 px (rows over 256 wide) run them on the mma.sync route.
    for size, route in ((256, "bf16_wgmma"), (64, "bf16_wgmma"), (300, "bf16_wgmma"),
                        (1028, "bf16_mma")):
        H = size // 4
        for batch in (1, 2, 64):
            assert tc.valid_plan(batch, H, H, 128, 128, torch.bfloat16).route == route


@pytest.mark.parametrize("shape", [(2, 16, 16, 64, 136), (3, 7, 32, 96, 72),
                                   (2, 4, 75, 32, 16)])
@pytest.mark.parametrize("relu", [False, True])
def test_wrapper_on_cpu_matches_the_jax_kernel_at_the_new_routes_shapes(shape, relu):
    # (2, 4, 75, 32, 16): a width whose rows only partly fill a wgmma tile.
    B, H, W, C, O = shape
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, H + 2, W + 2, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, O)) / np.sqrt(9 * C)).astype(np.float32)
    b = rng.standard_normal(O).astype(np.float32)
    before = tc.launches
    out, s, ss = tc.conv3x3_valid(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(b), relu)
    assert tc.launches == before  # CPU: the plain version
    jout, js, jss = jax_conv3x3(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), relu=relu,
                                interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(ss.numpy(), np.asarray(jss), rtol=1e-4, atol=1e-3)


def test_a_plan_on_a_given_route():
    # The mma.sync route runs any bf16 shape; the others only their own.
    mma = tc.valid_plan(64, 64, 64, 128, 128, torch.bfloat16, route="bf16_mma")
    assert mma.route == "bf16_mma" and mma.blocks == 64 * 32
    assert tc.valid_plan(1, 64, 64, 128, 128, torch.bfloat16, route="bf16_wgmma") == \
        tc.valid_plan(1, 64, 64, 128, 128, torch.bfloat16)
    for route, dtype, W in (("bf16_wgmma", torch.bfloat16, 300), ("f32_fma", torch.bfloat16, 64),
                            ("bf16_mma", torch.float32, 64), ("bf16_wgmma", torch.float32, 64)):
        with pytest.raises(ValueError):
            tc.valid_plan(1, 8, W, 128, 128, dtype, route=route)


def test_launch_refuses_a_route_of_another_dtype():
    x, w, b = torch.zeros(1, 4, 4, 32), torch.zeros(3, 3, 32, 8), torch.zeros(8)
    plan = tc.valid_plan(1, 2, 2, 32, 8, torch.bfloat16)
    with pytest.raises(ValueError):
        tc.launch(x, w, b, False, plan)  # on the CPU, and f32 against a bf16 route
