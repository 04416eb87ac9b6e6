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
    # The tile is scored at a batch of PLAN_BATCH (4), whatever the batch:
    # two whole rows of 128 positions, whose 32 tiles per image fill more
    # of the card there than 16 larger ones would.
    assert (plan.bm, plan.stages) == (128, 4)


@pytest.mark.parametrize("batch", [1, 64])
def test_a_75_wide_stage_takes_the_mma_route(batch):
    # convert-image --size 300: the residual stage is 75 x 75, whose rows do
    # not tile a block. It runs on the wgmma kernel all the same, at every
    # batch on the tile scored at a batch of PLAN_BATCH (4): 3 whole rows,
    # 225 of 256 positions, 25 tiles per image.
    plan = tc.valid_plan(batch, 75, 75, 128, 128, torch.bfloat16)
    assert plan.route == "bf16_wgmma"
    assert (plan.bm, plan.stages, plan.image_tiles) == (256, 3, 25)
    if batch == 64:
        assert plan.blocks == tc.SMS and batch * plan.image_tiles == 1600
    else:
        assert plan.blocks == 25


@pytest.mark.parametrize("shape", [(1, 64, 64, 128, 128), (64, 64, 64, 128, 128),
                                   (2, 16, 16, 64, 136), (1, 75, 75, 128, 128)])
def test_f32_takes_the_fma_route(shape):
    B, H, W, C, O = shape
    plan = tc.valid_plan(B, H, W, C, O, torch.float32)
    assert plan.route == "f32_fma" and plan.bm == tc.BLOCK_M
    assert plan.blocks == B * -(-H * W // tc.BLOCK_M) * -(-O // tc.BLOCK_N)


@pytest.mark.parametrize("W,route", [(1, "bf16_wgmma"), (48, "bf16_wgmma"), (64, "bf16_wgmma"),
                                     (128, "bf16_wgmma"), (200, "bf16_wgmma"),
                                     (256, "bf16_wgmma"), (512, "bf16_wgmma")])
def test_the_wgmma_route_needs_whole_rows_in_a_tile(W, route):
    # Up to 256 wide a tile is floor(bm / W) >= 1 whole rows (48 and 200
    # wide only partly fill theirs). A TMA box is at most 256 wide, so a
    # wider row is cut into segments, a tile being whole rows of segments.
    plan = tc.valid_plan(2, 5, W, 64, 64, torch.bfloat16)
    assert plan.route == route
    rows = plan.bm // plan.segment
    segs = -(-W // plan.segment)
    assert rows >= 1 and rows * plan.segment <= plan.bm
    assert plan.image_tiles == -(-5 // rows) * segs
    if W <= 256:
        assert plan.segment == W and segs == 1
    else:
        assert plan.segment <= 256 and segs >= 2 and segs * plan.segment >= W


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
    # exercises, forced where no plan takes it (mma.sync), and together
    # they reach both bf16 routes, both wgmma configurations, and tiles of
    # whole rows and of segments.
    from test_torch_cuda import _VALID_SHAPES

    reached = set()
    for B, H, W, C, O, route, forced in _VALID_SHAPES:
        plan = tc.valid_plan(B, H, W, C, O, torch.bfloat16)
        assert plan.route == ("bf16_wgmma" if forced else route), (B, H, W, C, O)
        if forced:
            plan = tc.valid_plan(B, H, W, C, O, torch.bfloat16, route=route)
        assert tc.valid_plan(B, H, W, C, O, torch.float32).route == "f32_fma"
        reached.add((plan.route, plan.bm, plan.stages, plan.segment not in (0, W)))
    assert {r[:3] for r in reached if r[0] == "bf16_wgmma"} == {
        ("bf16_wgmma",) + c for c in tc.WGMMA_CONFIGS}
    assert {r[3] for r in reached if r[0] == "bf16_wgmma"} == {False, True}
    assert any(r[0] == "bf16_mma" for r in reached)


def test_the_serving_forward_runs_every_residual_conv_on_the_wgmma_route():
    # The serving path's ten convs at 256 px, at 64 px (the CUDA serving
    # test's size), at 300 px (75-wide rows, partial tiles) and over 1,024
    # px (rows over 256 wide, cut into segments).
    for size, route in ((256, "bf16_wgmma"), (64, "bf16_wgmma"), (300, "bf16_wgmma"),
                        (1028, "bf16_wgmma")):
        H = size // 4
        for batch in (1, 2, 64):
            assert tc.valid_plan(batch, H, H, 128, 128, torch.bfloat16).route == route


@pytest.mark.parametrize("shape", [(2, 16, 16, 64, 136), (3, 7, 32, 96, 72),
                                   (2, 4, 75, 32, 16), (1, 1, 260, 32, 8)])
@pytest.mark.parametrize("relu", [False, True])
def test_wrapper_on_cpu_matches_the_jax_kernel_at_the_new_routes_shapes(shape, relu):
    # (2, 4, 75, 32, 16): a width whose rows only partly fill a wgmma tile;
    # (1, 1, 260, 32, 8): rows wider than a TMA box, cut into segments.
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
    for route, dtype, W in (("f32_fma", torch.bfloat16, 300), ("f32_fma", torch.bfloat16, 64),
                            ("bf16_mma", torch.float32, 64), ("bf16_wgmma", torch.float32, 64)):
        with pytest.raises(ValueError):
            tc.valid_plan(1, 8, W, 128, 128, dtype, route=route)


def test_launch_refuses_a_route_of_another_dtype():
    x, w, b = torch.zeros(1, 4, 4, 32), torch.zeros(3, 3, 32, 8), torch.zeros(8)
    plan = tc.valid_plan(1, 2, 2, 32, 8, torch.bfloat16)
    with pytest.raises(ValueError):
        tc.launch(x, w, b, False, plan)  # on the CPU, and f32 against a bf16 route


def _whole_row_plan(B, H, W, O):
    """valid_plan's wgmma plan for W <= 256 before rows were cut into
    segments: the configuration of the largest ``rows * W / bm * min(1,
    tiles / SMS)`` with the tiles of a batch of PLAN_BATCH, the first on a
    tie; the grid from B's tiles."""
    fits = [c for c in tc.WGMMA_CONFIGS if W <= c[0]]

    def tiles(bm, batch=tc.PLAN_BATCH):
        return batch * -(-H // (bm // W)) * -(-O // tc.BLOCK_N)

    bm, stages = max(fits, key=lambda c: (c[0] // W) * W / c[0] * min(1.0, tiles(c[0]) / tc.SMS))
    return (bm, stages, -(-H // (bm // W)), min(tiles(bm, B), tc.SMS))


@pytest.mark.parametrize("batch,size,want", [
    (1, 256, (128, 4, 32, 32)), (4, 256, (128, 4, 32, 128)), (64, 256, (128, 4, 32, 132)),
    (1, 300, (256, 3, 25, 25)), (64, 300, (256, 3, 25, 132)),
])
def test_whole_row_plans_stay_as_they_were(batch, size, want):
    # The 256 px and 300 px numbers in PERF.md rest on these plans: those
    # of batch 4 at 256 px and batch 64 at 300 px, now at every batch.
    H = W = size // 4
    plan = tc.valid_plan(batch, H, W, 128, 128, torch.bfloat16)
    assert plan == tc.ValidPlan("bf16_wgmma", *want, W)
    assert want == _whole_row_plan(batch, H, W, 128)


def test_every_width_up_to_256_keeps_its_whole_row_plan():
    for W in range(1, 257):
        for B, H, O in ((1, 5, 64), (2, 64, 136), (64, 75, 128)):
            plan = tc.valid_plan(B, H, W, 128, O, torch.bfloat16)
            assert plan == tc.ValidPlan("bf16_wgmma", *_whole_row_plan(B, H, W, O), W), (B, H, W)


@pytest.mark.parametrize("B,H,W", [(4, 260, 260), (1, 756, 1008), (2, 5, 257), (1, 3, 300),
                                   (64, 260, 260), (1, 16, 4096)])
def test_rows_wider_than_a_tma_box_are_cut_into_segments(B, H, W):
    plan = tc.valid_plan(B, H, W, 128, 128, torch.bfloat16)
    assert plan.route == "bf16_wgmma" and (plan.bm, plan.stages) in tc.WGMMA_CONFIGS
    seg = plan.segment
    segs, rows = -(-W // seg), plan.bm // seg
    assert seg <= tc.MAX_SEGMENT and rows >= 1 and rows * seg <= plan.bm
    assert segs * seg >= W and (segs - 1) * seg < W  # no segment lies wholly outside
    assert plan.image_tiles == -(-H // rows) * segs
    assert plan.blocks == min(B * plan.image_tiles, tc.SMS)
    assert plan == tc.wgmma_plan(B, H, W, 128, plan.bm, plan.stages, seg)


@pytest.mark.parametrize("B,H,W,want", [
    # 1040 px at batch 4: 12 segments of 22 columns (264, 4 past the
    # image), 11 rows: 242 of 256 positions, 24 row tiles.
    (4, 260, 260, (256, 3, 24 * 12, tc.SMS, 22)),
    # A 4032 x 3024 photo: 4 segments of 252, one row: 756 row tiles.
    (1, 756, 1008, (256, 3, 756 * 4, tc.SMS, 252)),
])
def test_the_wide_serving_shapes_take_the_stated_tiles(B, H, W, want):
    assert tc.valid_plan(B, H, W, 128, 128, torch.bfloat16) == tc.ValidPlan("bf16_wgmma", *want)


def test_wgmma_plan_refuses_tiles_the_kernel_cannot_take():
    for W, bm, stages, seg in ((300, 256, 3, 257), (100, 256, 3, 101), (300, 128, 4, 130),
                               (300, 256, 4, 100), (300, 256, 3, 0)):
        with pytest.raises(ValueError):
            tc.wgmma_plan(1, 4, W, 128, bm, stages, seg)


def test_the_ablation_script_edits_lines_the_kernel_has():
    # scripts/torch_wgmma_ablation.py takes parts out of the kernel by
    # replacing their text: each text must still be in the source.
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", "torch_wgmma_ablation.py")
    spec = importlib.util.spec_from_file_location("torch_wgmma_ablation", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    source = open(os.path.join(_CSRC, "conv3x3_wgmma.cu")).read()
    edits = [old for variant in module.VARIANTS.values() for old, _ in variant]
    assert len(edits) == 3 and all(old in source for old in edits)
