"""Operation and byte counts of the AdaIN configuration
(``configs/huang2017-adain-vgg19.json``) and of the kernels whose rooflines
its cell reports: the benchmark's own arithmetic, written from the paper's
layer list (2 operations per multiply-add, every 3x3 conv counted with its 9
published taps, as ``counts.py`` counts the transform net's), each input
byte read once and each output byte written once. A change to the program
does not move them.
"""

from __future__ import annotations

from typing import Tuple

from h100bench import peaks
from h100bench.counts import _conv_flops

F32 = 4

# (name, output side as a divisor of the image side, kernel, in, out).
ENCODER_CONVS: Tuple[Tuple[str, int, int, int, int], ...] = (
    ("conv0", 1, 1, 3, 3),
    ("conv1_1", 1, 3, 3, 64), ("conv1_2", 1, 3, 64, 64),
    ("conv2_1", 2, 3, 64, 128), ("conv2_2", 2, 3, 128, 128),
    ("conv3_1", 4, 3, 128, 256), ("conv3_2", 4, 3, 256, 256),
    ("conv3_3", 4, 3, 256, 256), ("conv3_4", 4, 3, 256, 256),
    ("conv4_1", 8, 3, 256, 512),
)
DECODER_CONVS: Tuple[Tuple[str, int, int, int, int], ...] = (
    ("conv1", 8, 3, 512, 256), ("up1", 4, 3, 256, 256),
    ("conv2", 4, 3, 256, 256), ("conv3", 4, 3, 256, 256),
    ("conv4", 4, 3, 256, 128), ("up2", 2, 3, 128, 128),
    ("conv5", 2, 3, 128, 64), ("up3", 1, 3, 64, 64),
    ("conv_out", 1, 3, 64, 3),
)
UPCONVS = ("up1", "up2", "up3")
# The decoder's convs on conv3x3_valid: neither the phase convs nor conv_out.
VALID_DECODER = tuple(c for c in DECODER_CONVS if c[0] not in UPCONVS + ("conv_out",))


def encoder_flops(side: int) -> float:
    """One image's encoder to relu4_1: 126.5 GFLOP at 512 px."""
    return sum(_conv_flops(side, *c[1:]) for c in ENCODER_CONVS)


def decoder_flops(side: int) -> float:
    """One decode to a ``side`` px image: 126.5 GFLOP at 512 px."""
    return sum(_conv_flops(side, *c[1:]) for c in DECODER_CONVS)


def pair_flops(side: int, style_side: int) -> float:
    """One pair: content and style encoded, one decode (379.6 GFLOP at 512
    px each); AdaIN's statistics are a few MFLOP and not counted."""
    return encoder_flops(side) + encoder_flops(style_side) + decoder_flops(side)


def encoder_bound_s(batch: int, side: int, style_side: int) -> float:
    """Least time of the encoder's convs in one forward of ``batch`` pairs
    (f32): each conv's operations over 67 TFLOP/s or its bytes (the input
    padded by k // 2, the weights, the output) over 3.35 TB/s, the larger,
    summed over the convs and the ``2 batch`` images."""
    total = 0.0
    for s in (side, style_side):
        for _, div, k, cin, cout in ENCODER_CONVS:
            h = s // div
            hp = h + 2 * (k // 2)
            nbytes = (batch * hp * hp * cin + k * k * cin * cout + batch * h * h * cout) * F32
            total += peaks.bound_s(batch * _conv_flops(s, div, k, cin, cout), nbytes)[0]
    return total


def upconv_phase_bound_s(batch: int, side: int) -> float:
    """Least time of the decoder's three phase-form upsample convs in one
    forward (f32): 16 C O multiply-adds a small-grid pixel (each phase's 2x2
    taps), 1.374e11 operations each at batch 16 and 512 px, 2.05 ms; bytes
    the edge-padded small grid, the taps and the output."""
    total = 0.0
    for name, div, _, cin, cout in DECODER_CONVS:
        if name in UPCONVS:
            h = side // div // 2
            flops = 2.0 * 16 * cin * cout * batch * h * h
            nbytes = (batch * (h + 2) ** 2 * cin + 16 * cin * cout + batch * 4 * h * h * cout) * F32
            total += peaks.bound_s(flops, nbytes)[0]
    return total


def conv3x3_valid_calls(side: int, style_side: int) -> int:
    """``conv3x3_valid``'s launches in one forward: the encoder's eight 3x3
    convs after conv1_1 (content and style as one batch where their sides
    agree, else apart) and the decoder's five that neither upsample nor
    write the image."""
    return (8 if side == style_side else 16) + len(VALID_DECODER)



def conv3x3_valid_bound_s(batch: int, side: int, style_side: int) -> float:
    """Least time of those convs in one forward of ``batch`` pairs (f32):
    each conv's operations over 67 TFLOP/s or its bytes (the input padded by
    1, the weights, the output) over 3.35 TB/s, the larger, summed over the
    convs, for the encoder over the ``2 batch`` images."""
    def bound(s, div, cin, cout):
        h = s // div
        nbytes = (batch * (h + 2) ** 2 * cin + 9 * cin * cout + batch * h * h * cout) * F32
        return peaks.bound_s(batch * _conv_flops(s, div, 3, cin, cout), nbytes)[0]

    total = sum(bound(s, div, cin, cout) for s in (side, style_side)
                for _, div, _, cin, cout in ENCODER_CONVS[2:])
    return total + sum(bound(side, div, cin, cout) for _, div, _, cin, cout in VALID_DECODER)
