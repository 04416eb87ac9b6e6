"""The rule every plan on the video stylizer's path keeps: a plan may use the
batch B to size its grid, never to decide how one image is cut into tiles
or the order in which anything is summed. Pure functions, on the CPU: for
each stylizer shape and every B in 1..128, the per-image fields of each
plan equal those at B = 1. (That a lane of a batch then comes out bit for
bit as the image alone is checked on the card, tests/test_torch_cuda.py and
chip_smoke.py, and on the CPU by tests/test_torch_video.py.)"""

import pytest
import torch

from styletransfer_tpu_torch.ops.cuda import conv3x3, conv3x3_flat, conv_direct, instance_norm

BATCHES = range(1, 129)
# The residual stage of a 256 px frame (64 wide), and in bf16 of 300 px
# (75 wide, partial tiles) and 1040 px (260 wide, rows in segments).
_RESIDUAL = [(64, torch.float32), (64, torch.bfloat16), (75, torch.bfloat16),
             (260, torch.bfloat16)]


def _per_image(plan, drop=("blocks",)):
    return {k: v for k, v in plan._asdict().items() if k not in drop}


@pytest.mark.parametrize("W,dtype", _RESIDUAL)
def test_valid_plan_cuts_an_image_the_same_at_every_batch(W, dtype):
    one = _per_image(conv3x3.valid_plan(1, W, W, 128, 128, dtype))
    for B in BATCHES:
        plan = conv3x3.valid_plan(B, W, W, 128, 128, dtype)
        assert _per_image(plan) == one, B
        assert plan.blocks == (min(B * plan.image_tiles, conv3x3.SMS) if plan.stages
                               else B * plan.image_tiles)


@pytest.mark.parametrize("W,dtype", _RESIDUAL)
def test_flat_plan_tiles_and_splits_an_image_the_same_at_every_batch(W, dtype):
    # The zero-padded forward's residual convs at each frame size.
    one = _per_image(conv3x3_flat.flat_plan(1, W, W, 128, 128, dtype))
    for B in BATCHES:
        plan = conv3x3_flat.flat_plan(B, W, W, 128, 128, dtype)
        assert _per_image(plan) == one, B
        assert plan.blocks == B * conv3x3_flat.flat_plan(1, W, W, 128, 128, dtype).blocks


# conv_direct's calls in a 256 px video forward: (output H, W, O) of the
# pad-early convs and of the stacked forward's.
_DIRECT = [(256, 256, 32), (128, 128, 64), (64, 64, 128), (64, 64, 256), (128, 128, 128),
           (64, 64, 48), (256, 256, 3), (128, 128, 64), (256, 256, 32)]


@pytest.mark.parametrize("Ho,Wo,O", _DIRECT)
def test_direct_plan_tiles_an_image_the_same_at_every_batch(Ho, Wo, O):
    one = _per_image(conv_direct.direct_plan(1, Ho, Wo, O))
    for B in BATCHES:
        plan = conv_direct.direct_plan(B, Ho, Wo, O)
        assert _per_image(plan) == one and plan.blocks == B * conv_direct.direct_plan(
            1, Ho, Wo, O).blocks


# The instance norms of a 256 px forward: [H, C] of each call.
_NORMS = [(256, 32), (128, 64), (64, 128), (128, 64), (256, 32)]


@pytest.mark.parametrize("H,C", _NORMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_in_plan_reduces_an_image_the_same_at_every_batch(H, C, dtype):
    # Without given sums an image is one cluster whose size is a function
    # of H; with them there is no reduction, so the rows per block may
    # follow the batch.
    one = instance_norm.in_plan(1, H, H, C, dtype, False)
    assert one.route == "l2"
    for B in BATCHES:
        assert instance_norm.in_plan(B, H, H, C, dtype, False) == one, B
        sums = instance_norm.in_plan(B, H, H, C, dtype, True)
        assert sums.route == "sums" and sums.cluster == 1
