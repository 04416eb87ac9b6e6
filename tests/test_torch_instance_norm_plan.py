"""The IN kernel's plan (``ops/cuda/instance_norm.py::in_plan``), a pure
function of the shape that names the route (statistics given, or a
cluster's reduction with the band read again from L2), the blocks per image
and the cluster of each call, at every call shape of the serving and training
forwards and at ragged shapes. The kernel itself is held against the plain
version on the GPU (tests/test_torch_cuda.py, chip_smoke.py)."""

import os

import pytest
import torch

from styletransfer_tpu_torch.ops.cuda import instance_norm as tin

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(tin.__file__))), "..",
                     "csrc")

# The fifteen instance norms of a forward at 256 px: (name, H, C, residual,
# statistics given), and the route each takes at batch 64 in f32 and bf16.
_SERVING = [
    ("in1", 256, 32, False, False, "l2"),
    ("in2", 128, 64, False, False, "l2"),
    ("in3", 64, 128, False, False, "l2"),
    ("res.in1", 64, 128, False, True, "sums"),
    ("res.in2", 64, 128, True, False, "l2"),
    ("up1_in", 128, 64, False, False, "l2"),
    ("up2_in", 256, 32, False, False, "l2"),
]


def _check_invariants(plan, H, C, dtype):
    assert plan.rows * plan.ctas >= H
    if plan.route == "sums":
        assert plan.cluster == 1
        assert (plan.ctas - 1) * plan.rows < H  # no block without rows
    else:
        assert plan.cluster == plan.ctas <= tin.MAX_CLUSTER
        assert plan.cluster & (plan.cluster - 1) == 0 and plan.cluster <= H
    assert C % plan.vec == 0 and C // plan.vec <= tin.THREADS
    assert plan.vec * (2 if dtype == torch.bfloat16 else 4) in (8, 16)
    # mean, inv * scale and the cluster partials; on the L2 route each
    # thread's (n, mean, M2) of its channel group. Under 48 KB at any C.
    scratch = tin.THREADS * (1 + 2 * plan.vec) * 4 if plan.route == "l2" else 0
    assert plan.smem == 16 * C + scratch <= 48 * 1024


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("call", _SERVING)
def test_every_serving_call_has_its_route(dtype, call):
    name, H, C, has_residual, has_stats, route = call
    plan = tin.in_plan(64, H, H, C, dtype, has_stats)
    assert plan.route == route
    _check_invariants(plan, H, C, dtype)
    if not has_stats:
        assert plan.cluster == 16  # every image of the forward is at least 16 rows
    else:
        # About one wave of three blocks per SM: 6 blocks of 11 rows here.
        assert 64 * plan.ctas <= 3 * tin.SMS and (plan.ctas, plan.rows) == (6, 11)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("call", _SERVING)
def test_every_training_call_has_its_route(dtype, call):
    # The training forward: batch 4, no statistics given (res.in1 computes
    # its own, as in3 does), the residual of res.in2 added in f32: every
    # call is one image per 16-block cluster on the L2 route.
    name, H, C, _, _, _ = call
    plan = tin.in_plan(4, H, H, C, dtype, False)
    _check_invariants(plan, H, C, dtype)
    assert plan.route == "l2" and plan.cluster == 16 and plan.ctas * plan.rows == H


@pytest.mark.parametrize("H,C,route", [(300, 32, "l2"), (150, 64, "l2"), (75, 128, "l2")])
def test_the_300_px_forward_in_bf16(H, C, route):
    # 75 and 150 rows in 16 blocks: bands of 5 and 10 rows, the last blocks
    # of 150 with none.
    plan = tin.in_plan(64, H, H, C, torch.bfloat16, False)
    assert plan.route == route and plan.cluster == 16
    assert plan.rows == -(-H // 16)
    _check_invariants(plan, H, C, torch.bfloat16)


@pytest.mark.parametrize("H,C,has_stats,route", [
    (1040, 32, False, "l2"), (520, 64, False, "l2"), (260, 128, False, "l2"),
    (260, 128, True, "sums"),
])
def test_the_1040_px_forward_in_bf16(H, C, has_stats, route):
    # Batch 4: 16-block clusters of 65, 33 and 17 rows; with the conv's
    # sums, 87 blocks of 3 rows per image, 348 blocks: about one wave of
    # three per SM.
    plan = tin.in_plan(4, H, H, C, torch.bfloat16, has_stats)
    assert plan.route == route
    _check_invariants(plan, H, C, torch.bfloat16)
    if has_stats:
        assert (plan.ctas, plan.rows) == (87, 3) and 4 * plan.ctas <= 3 * tin.SMS
    else:
        assert plan.cluster == 16 and plan.rows == -(-H // 16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,has_stats", [
    ((1, 300, 5, 4), False), ((2, 9, 7, 128), False), ((1, 1, 1, 4), False),
    ((1, 3, 5, 4), False), ((3, 7, 11, 12), True), ((1, 300, 5, 4), True),
])
def test_ragged_shapes_have_a_plan(dtype, shape, has_stats):
    # H not a multiple of the cluster: the last blocks own fewer rows, or
    # none; four channels in bf16 take 8-byte accesses.
    N, H, W, C = shape
    plan = tin.in_plan(N, H, W, C, dtype, has_stats)
    _check_invariants(plan, H, C, dtype)
    if not has_stats:
        assert plan.cluster == min(16, 1 << (H.bit_length() - 1))
        bands = [min(H, (k + 1) * plan.rows) - min(H, k * plan.rows) for k in range(plan.ctas)]
        assert sum(bands) == H and all(b >= 0 for b in bands)
    if C % 8:
        assert plan.vec == 4


def test_every_shape_the_wrapper_takes_has_a_plan():
    for C in (4, 12, 1020, 1024):
        for dtype in (torch.float32, torch.bfloat16):
            for has_stats in (False, True):
                plan = tin.in_plan(2, 300, 300, C, dtype, has_stats)
                _check_invariants(plan, 300, C, dtype)


def test_the_plan_is_what_the_kernel_builds():
    src = open(os.path.join(_CSRC, "instance_norm.cu")).read()
    assert f"constexpr int NT = {tin.THREADS};" in src
    assert f"constexpr int MAX_CLUSTER = {tin.MAX_CLUSTER};" in src
    routes = ", ".join(f"ROUTE_{name.upper()} = {n}" for name, n in tin.ROUTES.items())
    assert f"constexpr int {routes};" in src


def test_the_cuda_cases_reach_every_plan_branch():
    # tests/test_torch_cuda.py holds the kernel against the plain version
    # on the card at _IN_PLAN_CASES; each names the route it reaches.
    from test_torch_cuda import _IN_PLAN_CASES

    reached = set()
    for route, (N, H, W, C), pad, mode, rp, stats, res_f32 in _IN_PLAN_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            plan = tin.in_plan(N, H, W, C, dtype, stats)
            assert plan.route == route, (N, H, W, C, dtype)
            reached.add((plan.route, rp is not None, res_f32, dtype, plan.vec))
    assert {r[0] for r in reached} == set(tin.ROUTES)
    # A residual rounded to x's dtype and one added in f32, in both dtypes.
    assert {(r[1], r[2], r[3]) for r in reached if r[1]} == {
        (True, f32, dtype) for f32 in (False, True) for dtype in (torch.float32, torch.bfloat16)}
    # bf16 with C % 8 != 0 takes 8-byte accesses.
    assert ("l2", False, False, torch.bfloat16, 4) in reached
    assert {r[4] for r in reached} == {4, 8}


def test_the_plan_is_cached_and_pure():
    a = tin.in_plan(64, 256, 256, 32, torch.bfloat16, False)
    assert tin.in_plan(64, 256, 256, 32, torch.bfloat16, False) is a
