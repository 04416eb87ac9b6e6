"""AdaIN (Huang & Belongie, "Arbitrary Style Transfer in Real-time with
Adaptive Instance Normalization", ICCV 2017, arXiv:1703.06868) in plain
PyTorch: ``torch.nn.functional`` on NCHW tensors, f32 with TF32 off.

Written from the paper's equations and the released code's layer lists (the
normalized VGG and the decoder, as the PyTorch re-implementation's
``net.py`` writes them out), and importing nothing but ``torch``:

- encoder f: a 1x1 conv 3->3; conv1_1 3->64, conv1_2 64->64, max pool;
  conv2_1 64->128, conv2_2 128->128, max pool; conv3_1 128->256, conv3_2 ..
  conv3_4 256->256, max pool; conv4_1 256->512. A reflection pad of 1 before
  every 3x3 conv, a ReLU after it, 2x2 pools of stride 2. Input RGB in [0, 1];
- AdaIN of content features x and style features y, per image and channel
  over H and W: ``t = sigma(y) (x - mu(x)) / sigma(x) + mu(y)``, with
  ``sigma = sqrt(var + eps)`` and the biased variance (the mean over H W of
  the squared deviation), as the paper's IN equations write it; the output
  is ``alpha t + (1 - alpha) x``;
- decoder g: conv 512->256, up; conv 256->256 x3, conv 256->128, up; conv
  128->128, conv 128->64, up; conv 64->64, conv 64->3. A reflection pad of 1
  before every 3x3 conv, a ReLU after each but the last, nearest x2
  upsampling (``F.interpolate``).

Departures from the paper, each deliberate:

- eps = 1e-5 (the paper leaves it open; the released code's value);
- the re-implementation's ``calc_mean_std`` takes the unbiased variance (a
  factor 4096/4095 at relu4_1's 64x64 grid for a 512 px image); this module
  takes the paper's biased one;
- the weights are whatever the caller hands in (the pretrained files are not
  in the repository); they come in the released layout, OIHW, with the
  ``nn.Sequential`` indices of ``vgg_normalised.pth`` and ``decoder.pth``;
- the output is g(t) unclamped; a caller clamps it to [0, 1] to save it;
- image sides are multiples of 8, so the pools' ceil mode never acts.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Mapping

import torch
import torch.nn.functional as F

EPS = 1e-5
# (index in the normalized VGG's nn.Sequential, kernel size, pool after);
# conv4_1 (index 29) is the last layer used.
ENCODER = ((0, 1, False), (2, 3, False), (5, 3, True), (9, 3, False), (12, 3, True),
           (16, 3, False), (19, 3, False), (22, 3, False), (25, 3, True), (29, 3, False))
# (index in the decoder's nn.Sequential, nearest x2 upsample before it); a
# ReLU follows every conv but the last.
DECODER = ((1, False), (5, True), (8, False), (11, False), (14, False), (18, True),
           (21, False), (25, True), (28, False))

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


def _conv(x: torch.Tensor, sd: Weights, idx: int) -> torch.Tensor:
    w, b = sd[f"{idx}.weight"].float(), sd[f"{idx}.bias"].float()
    if w.shape[-1] == 3:
        x = F.pad(x, (1, 1, 1, 1), mode="reflect")
    return F.conv2d(x, w, b)


def encoder(vgg: Weights, x: torch.Tensor) -> torch.Tensor:
    """relu4_1 of ``x`` [N, 3, H, W] in [0, 1]."""
    for idx, k, pool in ENCODER:
        x = _conv(x, vgg, idx)
        if k == 3:
            x = F.relu(x)
        if pool:
            x = F.max_pool2d(x, 2, 2)
    return x


def mean_std(feat: torch.Tensor):
    """Per image and channel: the mean and sqrt(biased variance + eps),
    each [N, C, 1, 1]."""
    mean = feat.mean(dim=(2, 3), keepdim=True)
    var = ((feat - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    return mean, torch.sqrt(var + EPS)


def adain(content_feat: torch.Tensor, style_feat: torch.Tensor) -> torch.Tensor:
    c_mean, c_std = mean_std(content_feat)
    s_mean, s_std = mean_std(style_feat)
    return s_std * (content_feat - c_mean) / c_std + s_mean


def decoder(dec: Weights, t: torch.Tensor) -> torch.Tensor:
    for idx, up in DECODER:
        if up:
            t = F.interpolate(t, scale_factor=2, mode="nearest")
        t = _conv(t, dec, idx)
        if idx != DECODER[-1][0]:
            t = F.relu(t)
    return t


def stylize(vgg: Weights, dec: Weights, content: torch.Tensor, style: torch.Tensor,
            alpha: float = 1.0) -> torch.Tensor:
    """g(alpha AdaIN(f(c), f(s)) + (1 - alpha) f(c)) of ``content`` [N, 3, H, W]
    and ``style`` [N, 3, Hs, Ws], RGB in [0, 1]: [N, 3, H, W], unclamped."""
    x = encoder(vgg, content)
    t = adain(x, encoder(vgg, style))
    return decoder(dec, alpha * t + (1.0 - alpha) * x)
