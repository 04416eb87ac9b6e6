"""SANet (Park & Lee, "Arbitrary Style Transfer with Style-Attentional
Networks", CVPR 2019, arXiv:1812.02342) in plain PyTorch:
``torch.nn.functional`` on NCHW tensors, f32 with TF32 off.

Written from the paper's equations and the public PyTorch
re-implementation's layer lists (``net.py``: the normalized VGG and the
decoder it shares with AdaIN, the ``SANet`` and ``Transform`` modules;
``Eval.py``: one step), and importing nothing but ``torch``:

- encoder f: a 1x1 conv 3->3; conv1_1 3->64, conv1_2 64->64, max pool;
  conv2_1 64->128, conv2_2 128->128, max pool; conv3_1 128->256, conv3_2 ..
  conv3_4 256->256, max pool; conv4_1 256->512 (tap relu4_1), conv4_2 ..
  conv4_4 512->512, max pool; conv5_1 512->512 (tap relu5_1). A reflection
  pad of 1 before every 3x3 conv, a ReLU after it, 2x2 pools of stride 2
  with ``ceil_mode=True``. Input RGB in [0, 1];
- mean-variance norm of features x, per image and channel over H and W:
  ``(x - mean) / sqrt(var + eps)``, the unbiased variance (``calc_mean_std``);
- a SANet block at each tap, content features c and style features s:
  ``F = f(norm(c))``, ``G = g(norm(s))``, ``H = h(s)`` (1x1 convs),
  ``S = softmax(bmm(F^T, G))`` over the style positions (no scale),
  ``O = out_conv(bmm(H, S^T)) + c``;
- the transform: ``merge_conv(reflect_pad(SANet4(c4, s4) +
  up2(SANet5(c5, s5)), 1))``, a 3x3 conv 512->512 with a bias and no ReLU,
  ``up2`` nearest x2 (``F.interpolate``);
- decoder g: conv 512->256, up; conv 256->256 x3, conv 256->128, up; conv
  128->128, conv 128->64, up; conv 64->64, conv 64->3. A reflection pad of 1
  before every 3x3 conv, a ReLU after each but the last, nearest x2
  upsampling.

Departures, each deliberate:

- the weights are whatever the caller hands in (the pretrained files are not
  in the repository); they come in the released layout, OIHW, with the
  ``nn.Sequential`` indices of ``vgg_normalised.pth`` (to index 42) and
  ``decoder_iter_500000.pth`` and the keys of ``transformer_iter_500000.pth``;
- content and style come as batches of pairs (``Eval.py`` takes one pair);
  pair i takes style i;
- the output is g(m) unclamped; a caller clamps it to [0, 1] to save it;
- image sides are multiples of 16, so the pools' ceil mode never acts;
- it computes in the inputs' type: f32, or f64 where a check measures the
  f32 computation's own rounding against it.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Mapping

import torch
import torch.nn.functional as F

EPS = 1e-5
# (index in the normalized VGG's nn.Sequential, kernel size, pool after,
# tap name or None); conv5_1 (index 42) is the last layer used.
ENCODER = ((0, 1, False, None), (2, 3, False, None), (5, 3, True, None), (9, 3, False, None),
           (12, 3, True, None), (16, 3, False, None), (19, 3, False, None),
           (22, 3, False, None), (25, 3, True, None), (29, 3, False, "relu4_1"),
           (32, 3, False, None), (35, 3, False, None), (38, 3, True, None),
           (42, 3, False, "relu5_1"))
# (index in the decoder's nn.Sequential, nearest x2 upsample before it); a
# ReLU follows every conv but the last.
DECODER = ((1, False), (5, True), (8, False), (11, False), (14, False), (18, True),
           (21, False), (25, True), (28, False))
# The transformer's blocks and each block's 1x1 convs.
BLOCKS = ("sanet4_1", "sanet5_1")

Weights = Mapping[str, torch.Tensor]


@contextlib.contextmanager
def precision(tf32: bool = False) -> Iterator[None]:
    """f32 convolutions and matmuls with TF32 off (or on), restored after."""
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def _conv(x: torch.Tensor, sd: Weights, key) -> torch.Tensor:
    w, b = sd[f"{key}.weight"].to(x.dtype), sd[f"{key}.bias"].to(x.dtype)
    if w.shape[-1] == 3:
        x = F.pad(x, (1, 1, 1, 1), mode="reflect")
    return F.conv2d(x, w, b)


def encoder(vgg: Weights, x: torch.Tensor):
    """(relu4_1, relu5_1) of ``x`` [N, 3, H, W] in [0, 1]."""
    taps = {}
    for idx, k, pool, tap in ENCODER:
        x = _conv(x, vgg, idx)
        if k == 3:
            x = F.relu(x)
        if tap is not None:
            taps[tap] = x
        if pool:
            x = F.max_pool2d(x, 2, 2, ceil_mode=True)
    return taps["relu4_1"], taps["relu5_1"]


def mean_variance_norm(feat: torch.Tensor) -> torch.Tensor:
    """Per image and channel: ``(feat - mean) / sqrt(unbiased var + eps)``."""
    n, c = feat.shape[:2]
    flat = feat.reshape(n, c, -1)
    std = (flat.var(dim=2) + EPS).sqrt().reshape(n, c, 1, 1)
    mean = flat.mean(dim=2).reshape(n, c, 1, 1)
    return (feat - mean) / std


def sanet(tr: Weights, name: str, content: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """One SANet block of content features [N, C, h, w] and style features
    [N, C, hs, ws]."""
    f = _conv(mean_variance_norm(content), tr, f"{name}.f")
    g = _conv(mean_variance_norm(style), tr, f"{name}.g")
    h = _conv(style, tr, f"{name}.h")
    n, c, hh, ww = f.shape
    s = torch.softmax(torch.bmm(f.reshape(n, c, hh * ww).permute(0, 2, 1),
                                g.reshape(n, c, -1)), dim=-1)
    o = torch.bmm(h.reshape(n, c, -1), s.permute(0, 2, 1)).reshape(n, c, hh, ww)
    return _conv(o, tr, f"{name}.out_conv") + content


def transform(tr: Weights, c4, s4, c5, s5) -> torch.Tensor:
    o5 = F.interpolate(sanet(tr, BLOCKS[1], c5, s5), scale_factor=2, mode="nearest")
    return _conv(sanet(tr, BLOCKS[0], c4, s4) + o5, tr, "merge_conv")


def decoder(dec: Weights, t: torch.Tensor) -> torch.Tensor:
    for idx, up in DECODER:
        if up:
            t = F.interpolate(t, scale_factor=2, mode="nearest")
        t = _conv(t, dec, idx)
        if idx != DECODER[-1][0]:
            t = F.relu(t)
    return t


def stylize(vgg: Weights, dec: Weights, tr: Weights, content: torch.Tensor,
            style: torch.Tensor) -> torch.Tensor:
    """g(transform(f(content), f(style))) of ``content`` [N, 3, H, W] and
    ``style`` [N, 3, Hs, Ws], RGB in [0, 1]: [N, 3, H, W], unclamped."""
    c4, c5 = encoder(vgg, content)
    s4, s5 = encoder(vgg, style)
    return decoder(dec, transform(tr, c4, s4, c5, s5))
