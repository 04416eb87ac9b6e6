"""Operation and byte counts of the SANet configuration
(``configs/park2019-sanet-vgg19.json``) and of the kernels whose rooflines
its cell reports: the benchmark's own arithmetic, written from the paper's
layer list (2 operations per multiply-add, every 3x3 conv counted with its 9
published taps, as ``counts_adain.py`` counts AdaIN's, whose encoder to
relu4_1 and decoder it reuses), each input byte read once and each output
byte written once. A change to the program does not move them.
"""

from __future__ import annotations

from typing import Tuple

from h100bench import counts_adain, peaks
from h100bench.counts import _conv_flops

F32 = 4
D = 512

# The encoder on past relu4_1: (name, output side as a divisor of the image
# side, kernel, in, out).
ENCODER5_CONVS: Tuple[Tuple[str, int, int, int, int], ...] = (
    ("conv4_2", 8, 3, 512, 512), ("conv4_3", 8, 3, 512, 512), ("conv4_4", 8, 3, 512, 512),
    ("conv5_1", 16, 3, 512, 512),
)
# The attention blocks: (span tap, positions' side as a divisor of the side).
BLOCKS = (("r4_1", 8), ("r5_1", 16))
ATTENTION_CALLS = len(BLOCKS)  # a forward's launches of the attention kernel


def positions(side: int, div: int) -> int:
    return (side // div) ** 2


def encoder_flops(side: int) -> float:
    """One image's encoder to relu5_1: 506.2 + 251.3 GFLOP at 1024 px."""
    return counts_adain.encoder_flops(side) + sum(
        _conv_flops(side, *c[1:]) for c in ENCODER5_CONVS)


def attention_flops(side: int, style_side: int, div: int) -> float:
    """One block's q k^T and p v: 4 Nq Nk D (549.8 GFLOP at relu4_1, 1024 px)."""
    return 4.0 * positions(side, div) * positions(style_side, div) * D


def pointwise_flops(side: int, style_side: int) -> float:
    """The eight 1x1 convs: Wf and Wo on the content's positions, Wg and Wh
    on the style's, at each tap (42.9 GFLOP at 1024 px)."""
    return sum(2.0 * 2 * (positions(side, div) + positions(style_side, div)) * D * D
               for _, div in BLOCKS)


def merge_flops(side: int) -> float:
    """The merge conv, 3x3 512 -> 512 at relu4_1's grid (77.3 GFLOP)."""
    return _conv_flops(side, 8, 3, D, D)


def pair_flops(side: int, style_side: int) -> float:
    """One pair: content and style encoded to relu5_1, both attentions, the
    1x1 convs, the merge, one decode (2725.3 GFLOP at 1024 px each); the
    norms, the softmax's exponentials and the adds are not counted."""
    return (encoder_flops(side) + encoder_flops(style_side)
            + sum(attention_flops(side, style_side, div) for _, div in BLOCKS)
            + pointwise_flops(side, style_side) + merge_flops(side)
            + counts_adain.decoder_flops(side))


def attention_bound_s(batch: int, side: int, style_side: int) -> float:
    """Least time of one forward's two attention calls (f32): each call's
    4 Nq Nk D operations over 67 TFLOP/s or its bytes, q, k, v read and the
    output written once ((2 Nq + 2 Nk) D floats), over 3.35 TB/s, the larger:
    8.21 ms and 0.51 ms a pair at 1024 px."""
    total = 0.0
    for _, div in BLOCKS:
        nq, nk = positions(side, div), positions(style_side, div)
        total += peaks.bound_s(batch * attention_flops(side, style_side, div),
                               batch * (2 * nq + 2 * nk) * D * F32)[0]
    return total


def enc5_bound_s(batch: int, side: int, style_side: int) -> float:
    """Least time of conv4_2 .. conv5_1 in one forward of ``batch`` pairs
    (f32): each conv's operations over 67 TFLOP/s or its bytes (the input
    padded by 1, the weights, the output) over 3.35 TB/s, the larger, summed
    over the convs and the ``2 batch`` images (30.0 ms at 4 pairs of 1024
    px)."""
    total = 0.0
    for s in (side, style_side):
        for _, div, k, cin, cout in ENCODER5_CONVS:
            h = s // div
            nbytes = (batch * (h + 2) ** 2 * cin + k * k * cin * cout + batch * h * h * cout) * F32
            total += peaks.bound_s(batch * _conv_flops(s, div, k, cin, cout), nbytes)[0]
    return total


def conv3x3_valid_calls(side: int, style_side: int) -> int:
    """``conv3x3_valid``'s launches in one forward: the encoder's twelve 3x3
    convs after conv1_1 to conv5_1 (content and style as one batch where
    their sides agree, else apart), the merge and the decoder's five that
    neither upsample nor write the image: 18 at equal sides."""
    encoder = len(counts_adain.ENCODER_CONVS[2:]) + len(ENCODER5_CONVS)
    return (encoder if side == style_side else 2 * encoder) + 1 + len(counts_adain.VALID_DECODER)


def conv3x3_valid_bound_s(batch: int, side: int, style_side: int) -> float:
    """Least time of those convs in one forward of ``batch`` pairs (f32):
    AdaIN's thirteen (``counts_adain.conv3x3_valid_bound_s``), conv4_2 ..
    conv5_1 (``enc5_bound_s``) and the merge, each conv's operations over 67
    TFLOP/s or its bytes (the input padded by 1, the weights, the output)
    over 3.35 TB/s, the larger (110.8 ms at 4 pairs of 1024 px)."""
    h = side // 8
    nbytes = (batch * (h + 2) ** 2 * D + 9 * D * D + batch * h * h * D) * F32
    merge = peaks.bound_s(batch * merge_flops(side), nbytes)[0]
    return (counts_adain.conv3x3_valid_bound_s(batch, side, style_side)
            + enc5_bound_s(batch, side, style_side) + merge)
