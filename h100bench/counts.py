"""Operation and byte counts of the two configurations and of the kernels
whose rooflines the benchmark reports.

These are the benchmark's own arithmetic, written from each model's
published equations (2 operations per multiply-add) and, for the kernels,
copied from the repository's ``chip_smoke.py`` (``conv_phase``,
``in_phase``, ``stat_free_phase``; ``_IN_CALLS``, ``_GATYS_CONVS``): each
input byte read once, each output byte written once. A later change to the
program does not move them.
"""

from __future__ import annotations

from typing import Dict, Tuple

from h100bench import peaks

F32 = 4

# Johnson et al. (arXiv:1603.08155, supplementary Table 1) with instance
# norm: (name, output side as a divisor of the image side, kernel, in, out).
TRANSFORMNET_CONVS: Tuple[Tuple[str, int, int, int, int], ...] = (
    ("conv1", 1, 9, 3, 32),
    ("conv2", 2, 3, 32, 64),
    ("conv3", 4, 3, 64, 128),
    *((f"res{i // 2 + 1}.conv{i % 2 + 1}", 4, 3, 128, 128) for i in range(10)),
    ("up1_conv", 2, 3, 128, 64),
    ("up2_conv", 1, 3, 64, 32),
    ("conv_out", 1, 9, 32, 3),
)

# VGG19 (configuration E, arXiv:1409.1556) up to conv3_1, the deepest tap of
# the Gatys loss: (name, output side divisor, in, out); every kernel 3x3.
VGG_CONVS: Tuple[Tuple[str, int, int, int], ...] = (
    ("conv1_1", 1, 3, 64), ("conv1_2", 1, 64, 64),
    ("conv2_1", 2, 64, 128), ("conv2_2", 2, 128, 128),
    ("conv3_1", 4, 128, 256),
)
# The style taps are conv1_1 .. conv3_1 (before ReLU); the content tap is
# conv2_2.
CONTENT_DEPTH = 4


def _conv_flops(side: int, div: int, k: int, cin: int, cout: int) -> float:
    h = side // div
    return 2.0 * h * h * k * k * cin * cout


def transformnet_forward_flops(side: int) -> float:
    """One image's forward: 20.16 GFLOP at 256 px."""
    return sum(_conv_flops(side, d, k, ci, co) for _, d, k, ci, co in TRANSFORMNET_CONVS)


def vgg_forward_flops(side: int, depth: int = len(VGG_CONVS)) -> float:
    return sum(_conv_flops(side, d, 3, ci, co) for _, d, ci, co in VGG_CONVS[:depth])


def gram_flops(side: int) -> float:
    """The Gram products of the five style taps of one image, forward."""
    return sum(2.0 * (side // d) ** 2 * co * co for _, d, _, co in VGG_CONVS)


def gatys_eval_flops(side: int) -> float:
    """One closure evaluation: VGG to conv3_1 forward and its input
    gradient (the same operations again), the Grams forward and backward."""
    return 2.0 * vgg_forward_flops(side) + 2.0 * gram_flops(side)


def train_image_flops(side: int) -> float:
    """One image of a training step: the transform net's forward, weight
    gradient and input gradient (not conv1's: the batch takes no
    gradient); VGG to conv3_1 on the stylized image, forward and input
    gradient, with the Grams forward and backward; VGG to conv2_2 on the
    content image, forward."""
    fwd = transformnet_forward_flops(side)
    conv1 = _conv_flops(side, *TRANSFORMNET_CONVS[0][1:])
    return (3.0 * fwd - conv1 + gatys_eval_flops(side)
            + vgg_forward_flops(side, CONTENT_DEPTH))


# The 15 IN-pad calls of a serving forward, from chip_smoke.py: (name, side
# divisor, C, pad, residual pad or None, stats from the conv, count).
IN_PAD_CALLS = (
    ("in1", 1, 32, 1, None, False, 1),
    ("in2", 2, 64, 1, None, False, 1),
    ("in3", 4, 128, 1, None, False, 1),
    ("res.in1", 4, 128, 1, None, True, 5),
    ("res.in2", 4, 128, 1, 1, False, 5),
    ("up1_in", 2, 64, 1, None, False, 1),
    ("up2_in", 1, 32, 4, None, False, 1),
)


def conv3x3_valid_bound_s(batch: int, side: int) -> float:
    """Least time of one residual conv3x3_valid call (f32)."""
    h = side // 4
    c = o = 128
    flops = 2.0 * batch * h * h * 9 * c * o
    nbytes = ((batch * (h + 2) ** 2 * c + 9 * c * o + batch * h * h * o) * F32
              + (o + 2 * batch * o) * F32)
    return peaks.bound_s(flops, nbytes)[0]


def in_pad_forward_bound_s(batch: int, side: int) -> float:
    """Least time of the 15 IN-pad calls of one forward (f32)."""
    total = 0.0
    for _, div, c, pad, rp, stats, count in IN_PAD_CALLS:
        h = side // div
        x = batch * h * h * c
        out = batch * (h + 2 * pad) ** 2 * c
        interior = x * (2 if rp is not None else 1)
        nbytes = (interior + out) * F32 + 2 * c * F32 + (2 * batch * c * F32 if stats else 0)
        total += count * peaks.bound_s(8.0 * x, nbytes)[0]
    return total


# conv3x3_flat's calls, from chip_smoke.py's _GATYS_CONVS: (name, input side,
# C, O); conv1_1 itself runs on conv3x3_im2col.
GATYS_FLAT_CALLS = (
    ("conv1_2", 1, 64, 64), ("conv2_1", 2, 64, 128), ("conv2_2", 2, 128, 128),
    ("conv3_1", 4, 128, 256),
    ("conv1_1.dx", 1, 64, 3), ("conv1_2.dx", 1, 64, 64), ("conv2_1.dx", 2, 128, 64),
    ("conv2_2.dx", 2, 128, 128), ("conv3_1.dx", 4, 256, 128),
)
# Per image, before its first closure: the style Grams (conv1_2 .. conv3_1)
# and the content targets (conv1_2 .. conv2_2).
GATYS_TARGET_FLAT_CALLS = GATYS_FLAT_CALLS[:4] + GATYS_FLAT_CALLS[:3]


def _flat_bound_s(side: int, div: int, c: int, o: int) -> float:
    h = side // div
    flops = 2.0 * h * h * 9 * c * o
    nbytes = ((h + 2) ** 2 * c + 9 * c * o + h * h * o) * F32 + o * F32
    return peaks.bound_s(flops, nbytes)[0]


def conv3x3_flat_bound_s(side: int, evals: int, images: int) -> float:
    """Least time of conv3x3_flat's calls for ``images`` Gatys images of
    ``evals`` closure evaluations in all, batch 1."""
    per_eval = sum(_flat_bound_s(side, *c[1:]) for c in GATYS_FLAT_CALLS)
    per_image = sum(_flat_bound_s(side, *c[1:]) for c in GATYS_TARGET_FLAT_CALLS)
    return evals * per_eval + images * per_image


def conv3x3_flat_calls(evals: int, images: int) -> int:
    return evals * len(GATYS_FLAT_CALLS) + images * len(GATYS_TARGET_FLAT_CALLS)


def summary(side: int) -> Dict[str, float]:
    """The per-image and per-evaluation counts, for the tests and PERF.md."""
    return {"transformnet_forward": transformnet_forward_flops(side),
            "train_image": train_image_flops(side),
            "gatys_eval": gatys_eval_flops(side)}
