"""The stat-free 3x3 conv (``ops/cuda/conv3x3_flat.py``) against the JAX
package: the plain versions of ``conv3x3_flat`` and ``conv3x3_im2col``
against the Pallas kernels they port (``ops/pallas/conv3x3.py``, in interpret
mode on the CPU), and ``conv3x3_same``'s input gradient against ``jax.vjp`` of
the JAX VGG conv (``layers.conv2d`` with zero padding). On CPU tensors the
wrappers run the plain versions and launch no kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletransfer_tpu.ops import layers as jlayers
from styletransfer_tpu.ops.pallas import conv3x3 as pconv
from styletransfer_tpu_torch.ops.cuda import conv3x3_flat as tc

# f32: the same products summed in another order over K = 9C <= 576 terms.
ATOL = 1e-4
# The VJP through one conv: relative L2 of the input gradient.
GRAD_REL_L2 = 1e-5


def _inputs(C, O, seed=0, H=9, W=7, B=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H + 2, W + 2, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, O)) / np.sqrt(9 * C)).astype(np.float32)
    b = rng.standard_normal(O).astype(np.float32)
    return x, w, b


# (C, O, H, W): the VGG channel pairs, then what im2col_plan distinguishes:
# C = 1 and 4 (the band route's smallest and largest C) with O = 3 (a mostly
# empty chunk) and 130 (three chunks), odd widths, an image of one pixel and
# C = 5 (the gather route).
@pytest.mark.parametrize("kernel", ["flat", "im2col"])
@pytest.mark.parametrize("C,O,H,W", [(3, 64, 9, 7), (16, 8, 9, 7), (64, 3, 9, 7), (1, 3, 9, 7),
                                     (4, 130, 5, 33), (3, 64, 1, 1), (5, 13, 6, 5)])
@pytest.mark.parametrize("relu", [False, True])
def test_plain_matches_the_jax_kernel_in_interpret_mode(kernel, C, O, H, W, relu):
    x, w, b = _inputs(C, O, H=H, W=W)
    jfn = {"flat": pconv.conv3x3_flat, "im2col": pconv.conv3x3_im2col}[kernel]
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), relu=relu,
                          interpret=True))
    args = (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    counts = tc.flat_launches, tc.im2col_launches
    got = getattr(tc, f"conv3x3_{kernel}")(*args, relu)
    assert (tc.flat_launches, tc.im2col_launches) == counts  # CPU: the plain version
    assert torch.equal(got, getattr(tc, f"conv3x3_{kernel}_plain")(*args, relu))
    assert got.shape == want.shape == (2, H, W, O) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("kernel", ["flat", "im2col"])
def test_bf16_plain_is_the_f32_result_rounded_once(kernel):
    x, w, b = _inputs(16, 24, seed=1)
    xq, wq = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    plain = getattr(tc, f"conv3x3_{kernel}_plain")
    want = plain(xq.float(), wq.float(), torch.from_numpy(b), True)
    got = plain(xq, wq, torch.from_numpy(b), True)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want, rtol=2 ** -7, atol=1e-6)


def test_the_two_plain_forms_agree():
    x, w, b = _inputs(32, 40, seed=2)
    args = (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    torch.testing.assert_close(tc.conv3x3_flat_plain(*args), tc.conv3x3_im2col_plain(*args),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("C,O", [(3, 64), (64, 64), (64, 3)])
def test_conv3x3_same_matches_the_jax_vgg_conv_and_its_vjp(C, O):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 10, 8, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, O)) / np.sqrt(9 * C)).astype(np.float32)
    b = rng.standard_normal(O).astype(np.float32)
    g = rng.standard_normal((2, 10, 8, O)).astype(np.float32)
    want, vjp = jax.vjp(
        lambda a: jlayers.conv2d(a, jnp.asarray(w), jnp.asarray(b), stride=1, reflect=False),
        jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    got = tc.conv3x3_same(xt, torch.from_numpy(w), torch.from_numpy(b))
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)
    want_dx = np.asarray(want_dx)
    rel = np.linalg.norm(xt.grad.numpy() - want_dx) / np.linalg.norm(want_dx)
    assert rel <= GRAD_REL_L2


def test_conv3x3_same_refuses_weights_that_want_a_gradient():
    x, w, b = torch.zeros(1, 4, 4, 3), torch.zeros(3, 3, 3, 8), torch.zeros(8)
    with pytest.raises(NotImplementedError, match="input gradient only"):
        tc.conv3x3_same(x, w.requires_grad_(), b)
    with pytest.raises(NotImplementedError, match="input gradient only"):
        tc.conv3x3_same(x, w.detach(), b.requires_grad_())
    with torch.no_grad():  # nothing would need the gradient
        assert tc.conv3x3_same(x, w, b).shape == (1, 4, 4, 8)


def test_the_routing_rule_sends_few_input_channels_to_im2col():
    assert [tc.uses_im2col(c) for c in (1, 3, 31, 32, 64, 256)] == [
        True, True, True, False, False, False]


@pytest.mark.parametrize("bad, err", [
    (dict(x=np.zeros((1, 5, 5, 4), np.float16)), TypeError),
    (dict(w=np.zeros((3, 3, 5, 8), np.float32)), ValueError),
    (dict(b=np.zeros(8, np.float64)), ValueError),
    (dict(x=np.zeros((1, 2, 5, 4), np.float32)), ValueError),
])
def test_wrappers_check_their_inputs(bad, err):
    args = dict(x=np.zeros((1, 5, 5, 4), np.float32), w=np.zeros((3, 3, 4, 8), np.float32),
                b=np.zeros(8, np.float32))
    args.update(bad)
    t = {k: torch.from_numpy(v) for k, v in args.items()}
    for fn in (tc.conv3x3_flat, tc.conv3x3_im2col):
        with pytest.raises(err):
            fn(t["x"], t["w"], t["b"])


# conv3x3_flat's plan (tile and channel split per shape), a pure function of
# the shape that the CUDA kernels take as arguments. The shapes: the ten 3x3
# convs of the VGG tower up to conv3_1 (five forward, five input gradients)
# at 256 px, as one Gatys closure runs them (batch 1) and as a train step
# does (batch 4 and 16); (name, H, C, O).
_VGG_CONVS = [
    ("conv1_1", 256, 3, 64), ("conv1_2", 256, 64, 64), ("conv2_1", 128, 64, 128),
    ("conv2_2", 128, 128, 128), ("conv3_1", 64, 128, 256),
    ("conv1_1.dx", 256, 64, 3), ("conv1_2.dx", 256, 64, 64), ("conv2_1.dx", 128, 128, 64),
    ("conv2_2.dx", 128, 128, 128), ("conv3_1.dx", 64, 256, 128),
]
_DTYPES = [torch.float32, torch.bfloat16]


def _blocks(B, H, W, O, plan):
    return B * -(-H * (W + 2) // plan.bm) * -(-O // plan.bn) * plan.split


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("batch", [1, 4, 16])
@pytest.mark.parametrize("call,H,C,O", _VGG_CONVS)
def test_flat_plan_fills_the_card_on_the_vgg_shapes(dtype, batch, call, H, C, O):
    # The tile and split are planned for a batch of PLAN_BATCH (4) whatever
    # the batch, so that an image's sums do not depend on it: they fill the
    # card there and at every larger batch; one image gets the same plan.
    plan = tc.flat_plan(batch, H, H, C, O, dtype)
    assert plan.blocks == _blocks(batch, H, H, O, plan)
    assert _blocks(max(batch, tc.PLAN_BATCH), H, H, O, plan) >= tc.SMS


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("shape", [(b, H, H, C, O) for b in (1, 4, 16) for _, H, C, O in _VGG_CONVS]
                         + [(1, 8, 8, 128, 256), (2, 9, 7, 5, 13), (1, 11, 6, 40, 72),
                            (1, 30, 30, 37, 130), (1, 4, 4, 3, 3)])
def test_a_flat_split_divides_the_channel_chunks(dtype, shape):
    B, H, W, C, O = shape
    route, bk, tiles = tc.FLAT_ROUTES[dtype]
    plan = tc.flat_plan(B, H, W, C, O, dtype)
    chunks = -(-C // bk)
    assert 1 <= plan.split <= tc.MAX_SPLIT and chunks % plan.split == 0
    assert plan.blocks == _blocks(B, H, W, O, plan)
    if _blocks(tc.PLAN_BATCH, H, W, O, plan) < tc.SMS:
        # too little work at the batch planned for: the smallest tile at the widest split
        group = next(g for g in tiles.values() if (plan.bm, plan.bn) in g)
        assert (plan.bm, plan.bn) == group[-1]
        assert plan.split == max(d for d in range(1, tc.MAX_SPLIT + 1) if chunks % d == 0)


@pytest.mark.parametrize("dtype", _DTYPES)
def test_every_flat_plan_is_a_named_route_and_a_tile_the_kernels_have(dtype):
    source = open(tc.__file__.replace("ops/cuda/conv3x3_flat.py", "csrc/conv3x3_flat.cu")).read()
    route, _, tiles = tc.FLAT_ROUTES[dtype]
    entry = source[source.index(f"int stx_conv3x3_flat_{route.split('_')[0]}("):]
    entry = entry[:entry.index("\n}\n")]
    built = {tuple(int(v) for v in line.split("bm == ")[1].split(")")[0].split(" && bn == "))
             for line in entry.splitlines() if "bm == " in line}
    assert built == {t for group in tiles.values() for t in group}
    shapes = [(b, H, H, C, O) for b in (1, 4, 16) for _, H, C, O in _VGG_CONVS]
    for shape in shapes:
        plan = tc.flat_plan(*shape, dtype)
        assert plan.route == route and (plan.bm, plan.bn) in built
        assert str(plan).startswith(f"{route} {plan.bm}x{plan.bn} split {plan.split}")


@pytest.mark.parametrize("dtype", _DTYPES)
def test_the_cuda_test_shapes_reach_every_flat_plan(dtype):
    # tests/test_torch_cuda.py holds every kernel against its plain version
    # on the card at _STAT_FREE_SHAPES: they must reach each tile unsplit and
    # the smallest tile of each group split.
    from test_torch_cuda import _STAT_FREE_SHAPES

    _, _, tiles = tc.FLAT_ROUTES[dtype]
    want = {t + (False,) for group in tiles.values() for t in group}
    want |= {group[-1] + (True,) for group in tiles.values()}
    reached = set()
    for shape in _STAT_FREE_SHAPES:
        plan = tc.flat_plan(*shape, dtype)
        reached.add((plan.bm, plan.bn, plan.split > 1))
    assert reached == want


# conv3x3_im2col's plan: the band route for C <= 4 where its shared memory
# fits two blocks an SM (every VGG conv1_1), the gather route otherwise; in
# f32 the band route's bulk stores where blocks walk more than one tile.
_CONV1_1 = [(b, 256, 256, 3, 64) for b in (1, 4, 16)]


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("shape", _CONV1_1)
def test_conv1_1_takes_the_band_route_at_every_batch(dtype, shape):
    B = shape[0]
    plan = tc.im2col_plan(*shape, dtype)
    tiles = B * 258 * 1  # 256 rows of the 258-wide grid, 256 positions a tile; one chunk
    blocks = min(tiles, 2 * tc.SMS)
    # f32 stores through a staging tile where blocks walk more than one tile.
    bulk = dtype == torch.float32 and B > 1
    assert plan == ("band", 256, 64, tiles, blocks, bulk)
    assert str(plan) == (f"band 256x64{' bulk stores' if bulk else ''} "
                         f"({tiles} tiles on {blocks} blocks)")


@pytest.mark.parametrize("dtype", _DTYPES)
def test_the_cuda_test_shapes_take_the_routes_named(dtype):
    # tests/test_torch_cuda.py holds conv3x3_im2col against its plain
    # version at _STAT_FREE_SHAPES (among them conv1_1 at 16 px: band) and
    # at _BAND_SHAPES (all band).
    from test_torch_cuda import _BAND_SHAPES, _STAT_FREE_SHAPES

    want = {(1, 18, 18, 3, 64): ("band", 256, 64, 2, 2, False),
            (2, 16, 16, 64, 64): ("gather", 128, 64, 4, 4),
            (1, 16, 16, 64, 3): ("gather", 128, 16 if dtype == torch.float32 else 32, 2, 2),
            (1, 8, 8, 128, 256): ("gather", 128, 128, 2, 2),
            (2, 9, 7, 5, 13): ("gather", 128, 16 if dtype == torch.float32 else 32, 2, 2),
            (1, 11, 6, 40, 72): ("gather", 128, 128, 1, 1),
            (4, 64, 64, 128, 256): ("gather", 128, 128, 256, 256),
            (1, 64, 64, 256, 128): ("gather", 128, 128, 32, 32),
            (1, 64, 64, 128, 256): ("gather", 128, 128, 64, 64),
            (3, 128, 128, 64, 64): ("gather", 128, 64, 384, 384),
            (16, 64, 64, 64, 3): ("gather", 128, 16 if dtype == torch.float32 else 32, 512, 512),
            (1, 40, 40, 44, 64): ("gather", 128, 64, 13, 13),
            (1, 30, 30, 37, 130): ("gather", 128, 128, 16, 16),
            (1, 260, 260, 8, 3): ("gather", 128, 16 if dtype == torch.float32 else 32, 529,
                                  529)}
    want = {s: p if len(p) == 6 else p + (False,) for s, p in want.items()}
    assert {s: tuple(tc.im2col_plan(*s, dtype)) for s in _STAT_FREE_SHAPES} == want
    assert all(tc.im2col_plan(*s, dtype).route == "band" for s in _BAND_SHAPES)
    # Both f32 store routes of the band kernel are among the card's shapes.
    assert ({tc.im2col_plan(*s, torch.float32).bulk_store for s in _BAND_SHAPES}
            == {False, True})


@pytest.mark.parametrize("dtype", _DTYPES)
def test_every_shape_gets_an_im2col_route(dtype):
    for B in (1, 3):
        for H, W in ((1, 1), (7, 9), (256, 256), (300, 1000), (1008, 1344), (3024, 4032)):
            for C in (1, 2, 3, 4, 5, 16, 31, 64):
                for O in (1, 3, 64, 65, 130, 256):
                    plan = tc.im2col_plan(B, H, W, C, O, dtype)
                    assert 1 <= plan.blocks <= plan.tiles
                    if plan.route == "band":
                        assert C <= tc.BAND_MAX_C
                        assert tc.band_smem_bytes(W, C, O, dtype) <= tc.BAND_SMEM_MAX
                        assert plan.blocks == min(plan.tiles, tc.BAND_BLOCKS_PER_SM * tc.SMS)
                        assert plan.tiles == B * -(-H * (W + 2) // 256) * -(-O // 64)
                        assert plan.bulk_store == (
                            dtype == torch.float32 and plan.tiles > plan.blocks and O <= 64
                            and O % 4 == 0 and tc.band_smem_bytes(W, C, O, dtype, True)
                            <= tc.BAND_SMEM_MAX)
                    else:
                        assert plan.route == "gather" and plan.blocks == plan.tiles
                        assert not plan.bulk_store
                        assert (C > tc.BAND_MAX_C
                                or tc.band_smem_bytes(W, C, O, dtype) > tc.BAND_SMEM_MAX)
                        assert plan.tiles == B * -(-H * W // 128) * -(-O // plan.bn)
    # A photo's conv1_1 span does not fit two blocks an SM: the gather route.
    assert tc.im2col_plan(1, 3024, 4032, 3, 64, dtype).route == "gather"


def test_the_im2col_plan_is_cached():
    tc.im2col_plan.cache_clear()
    first = tc.im2col_plan(1, 256, 256, 3, 64, torch.float32)
    assert tc.im2col_plan(1, 256, 256, 3, 64, torch.float32) is first
    info = tc.im2col_plan.cache_info()
    assert (info.hits, info.misses) == (1, 1)


def test_the_band_constants_match_the_kernel_source():
    # band_smem_bytes mirrors the kernel's own (csrc/conv3x3_im2col.cu):
    # the same tile, chunk and largest C.
    source = open(tc.__file__.replace("ops/cuda/conv3x3_flat.py", "csrc/conv3x3_im2col.cu")).read()
    for name, value in (("BAND_BM", tc.BAND_BM), ("BAND_BN", tc.BAND_BN),
                        ("BAND_MAX_C", tc.BAND_MAX_C)):
        assert f"constexpr int {name} = {value};" in source
    assert "constexpr int STAGING_LD = BAND_BN + 8;" in source
    # conv1_1 at 256 px: two stages of (256 + 2 * 258 + 2) * 3 values (+16
    # bytes, 128-aligned), 27 x 64 weights (bf16: 16 packed rows of 72
    # words), 64 biases (and, in bf16, a 256 x 72 staging tile).
    assert tc.band_smem_bytes(256, 3, 64, torch.float32) == 128 + 2 * 9344 + 6912 + 256
    # f32 with bulk stores: a 256 x 64 f32 staging tile as well.
    assert tc.band_smem_bytes(256, 3, 64, torch.float32, True) == (
        128 + 2 * 9344 + 6912 + 256 + 65536)
    assert tc.band_smem_bytes(256, 3, 64, torch.bfloat16) == 128 + 2 * 4736 + 4608 + 256 + 36864
