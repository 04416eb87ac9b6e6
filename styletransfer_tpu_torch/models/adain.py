"""AdaIN arbitrary style transfer ("Arbitrary Style Transfer in Real-time
with Adaptive Instance Normalization", Huang & Belongie, ICCV 2017,
arXiv:1703.06868): one net for any style, each content image brought to the
statistics of its own style image.

Not the port of a JAX model: the JAX package has no AdaIN. The layers follow
the released code's normalized VGG and decoder (the ``nn.Sequential`` lists
of the PyTorch re-implementation's ``net.py``):

- encoder f: VGG19 up to relu4_1 on RGB in [0, 1]: a 1x1 conv 3->3, then
  conv1_1 .. conv4_1, each 3x3 after a reflection pad of 1 and followed by
  a ReLU, with a 2x2 max pool after conv1_2, conv2_2 and conv3_4;
- AdaIN: ``t = sigma(y) * (x - mu(x)) / sigma(x) + mu(y)`` per image and
  channel over the spatial dims (biased variance, eps inside the root),
  blended as ``alpha * t + (1 - alpha) * x``;
- decoder g: the encoder mirrored, nearest x2 upsampling for the pools, a
  reflection pad of 1 before every 3x3 conv, a ReLU after each but the last.

:func:`apply` runs the forward on the port's kernels, NHWC and f32:

- the 1x1 conv folded into conv1_1 (a reflection pad commutes with a
  pointwise affine map, so the fold is exact up to rounding), which runs on
  ``conv3x3_im2col``; the other eight encoder convs on ``conv3x3_valid``
  (bias and ReLU fused), content and style encoded as one batch where their
  shapes agree;
- AdaIN as ``instance_norm_pad`` with an affine per image ([N, C]) from the
  style's statistics, written reflect-padded for the decoder's first conv;
- the decoder's three ``upsample -> reflect-pad -> conv3x3`` layers on
  ``upconv_phase`` (2x2 taps a phase on the small grid, bias and ReLU in its
  epilogue), its other 3x3 convs on ``conv3x3_valid``, and the last, 64 -> 3,
  on ``conv3x3_flat`` (a narrow tile of 4 channels).

The pads between convs and the pools are plain PyTorch passes. On CPU
tensors every kernel's wrapper computes its plain version. Each layer is a
span (``utils/profiling.py``): ``adain.enc.<conv>`` (conv1_1 .. conv4_1,
each with its input's pad; conv1_1's holds the fold), ``adain.enc.pool<i>``,
``adain.norm`` (the style's statistics and the IN-pad) and
``adain.dec.<conv>`` (``conv1``, ``up1``, ``conv2`` .. ``conv4``, ``up2``,
``conv5``, ``up3``, ``conv_out``; the ``up<i>`` are the phase convs).

Weights: :func:`import_torch_state_dict` reads the released files' layout
(``vgg_normalised.pth``, ``decoder.pth``: OIHW ``nn.Sequential`` keys) and
:func:`export_torch_state_dict` writes it; :func:`init_params` makes seeded
ones that keep activations in range through the 19 convs.

SANet (``models/sanet.py``) runs this encoder on to relu5_1
(:data:`ENCODER5`: conv4_2 .. conv5_1 after pool4 follows conv4_4) and
this decoder, under span names of its own: :func:`encode` and
:func:`decode` take the span prefix, and :func:`encode` the tap.
"""

from __future__ import annotations

import functools
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from styletransfer_tpu_torch import constants
from styletransfer_tpu_torch.models.transformer import Conv
from styletransfer_tpu_torch.ops import layers
from styletransfer_tpu_torch.ops.cuda.conv3x3 import conv3x3_valid
from styletransfer_tpu_torch.ops.cuda.conv3x3_flat import conv3x3_flat, conv3x3_im2col
from styletransfer_tpu_torch.ops.cuda.instance_norm import EPS, instance_norm_pad
from styletransfer_tpu_torch.ops.cuda.upconv_phase import upconv_phase
from styletransfer_tpu_torch.utils import profiling

# The encoder: (name, kernel size, in, out, index in vgg_normalised.pth's
# nn.Sequential), and the convs a 2x2 max pool follows.
ENCODER = (
    ("conv0", 1, 3, 3, 0),
    ("conv1_1", 3, 3, 64, 2), ("conv1_2", 3, 64, 64, 5),
    ("conv2_1", 3, 64, 128, 9), ("conv2_2", 3, 128, 128, 12),
    ("conv3_1", 3, 128, 256, 16), ("conv3_2", 3, 256, 256, 19),
    ("conv3_3", 3, 256, 256, 22), ("conv3_4", 3, 256, 256, 25),
    ("conv4_1", 3, 256, 512, 29),
)
# The normalized VGG on to relu5_1, SANet's second tap: the same rows.
ENCODER5 = (
    ("conv4_2", 3, 512, 512, 32), ("conv4_3", 3, 512, 512, 35),
    ("conv4_4", 3, 512, 512, 38), ("conv5_1", 3, 512, 512, 42),
)
POOL_AFTER = ("conv1_2", "conv2_2", "conv3_4", "conv4_4")
# The decoder: (name, in, out, nearest x2 upsample before it, index in
# decoder.pth's nn.Sequential); every conv is 3x3 and all but the last are
# followed by a ReLU.
DECODER = (
    ("conv1", 512, 256, False, 1), ("up1", 256, 256, True, 5),
    ("conv2", 256, 256, False, 8), ("conv3", 256, 256, False, 11),
    ("conv4", 256, 128, False, 14), ("up2", 128, 128, True, 18),
    ("conv5", 128, 64, False, 21), ("up3", 64, 64, True, 25),
    ("conv_out", 64, 3, False, 28),
)
DOWNSCALE = 8  # three pools: the image sides must be multiples of this
# The seeded init's output layer (see init_params): its kernel's scale on
# top of He-normal, and its bias, the middle of [0, 1].
OUT_GAIN = 0.1
OUT_BIAS = 0.5

# The encoder's taps: the last conv of each.
TAPS = {"relu4_1": "conv4_1", "relu5_1": "conv5_1"}
NORM_SPAN = "adain.norm"


@functools.lru_cache(maxsize=None)
def _spans(prefix: str) -> Dict[str, str]:
    """Span names of a prefix, made once: a forward formats no string.
    Keys ``enc.<conv>``, ``pool.<conv>`` (the pool after that conv) and
    ``dec.<conv>``; names ``<prefix>.enc.<conv>``, ``<prefix>.enc.pool<i>``
    and ``<prefix>.dec.<conv>``."""
    names = {"enc." + name: f"{prefix}.enc.{name}" for name, *_ in ENCODER + ENCODER5}
    names.update({f"pool.{name}": f"{prefix}.enc.pool{i + 1}"
                  for i, name in enumerate(POOL_AFTER)})
    names.update({"dec." + name: f"{prefix}.dec.{name}" for name, *_ in DECODER})
    return names


class _Convs(nn.Module):
    def __init__(self, convs: Mapping[str, Conv]):
        super().__init__()
        for name, conv in convs.items():
            self.add_module(name, conv)


class AdaINNet(nn.Module):
    """AdaIN's parameters: ``enc.<conv>`` (``conv0`` the 1x1, ``conv1_1`` ..
    ``conv4_1``, and ``conv4_2`` .. ``conv5_1`` where the VGG goes on to
    relu5_1) and ``dec.<conv>`` (:data:`DECODER`), each a
    :class:`transformer.Conv` with an HWIO ``kernel`` and a ``bias``."""

    def __init__(self, enc: Mapping[str, Conv], dec: Mapping[str, Conv]):
        super().__init__()
        self.enc = _Convs(enc)
        self.dec = _Convs(dec)


def init_params(seed: int = 0, device=constants.DEFAULT_DEVICE) -> AdaINNet:
    """Seeded f32 weights that keep activations in range through the 19
    convs: every conv followed by a ReLU He-normal (std sqrt(2 / fan-in)),
    the 1x1 conv fan-in normal (std sqrt(1 / 3)), biases U(-0.1, 0.1); the
    last conv He-normal times :data:`OUT_GAIN` with biases
    :data:`OUT_BIAS`, so that the output lies about [0, 1] and few of its
    levels clamp."""
    return AdaINNet(*seeded_convs(torch.Generator().manual_seed(seed),
                                  constants.resolve_device(device)))


def seeded_convs(gen: torch.Generator, dev, tap: str = "relu4_1"
                 ) -> Tuple[Dict[str, Conv], Dict[str, Conv]]:
    """The encoder's convs to ``tap`` and the decoder's, drawn from ``gen``
    by :func:`init_params`'s rule (the relu5_1 convs He-normal too)."""
    def conv(k, cin, cout, std, bias=None):
        kernel = torch.randn((k, k, cin, cout), generator=gen) * std
        b = (torch.rand((cout,), generator=gen) * 0.2 - 0.1) if bias is None \
            else torch.full((cout,), bias)
        return Conv(kernel.to(dev), b.to(dev))

    rows = ENCODER + (ENCODER5 if tap == "relu5_1" else ())
    enc = {name: conv(k, cin, cout, (2.0 / (k * k * cin)) ** 0.5 if k == 3 else (1.0 / cin) ** 0.5)
           for name, k, cin, cout, _ in rows}
    dec = {}
    for name, cin, cout, _, _ in DECODER:
        he = (2.0 / (9 * cin)) ** 0.5
        dec[name] = (conv(3, cin, cout, he * OUT_GAIN, OUT_BIAS) if name == "conv_out"
                     else conv(3, cin, cout, he))
    return enc, dec


def _fold_input_conv(conv0: Conv, conv1_1: Conv) -> Tuple[torch.Tensor, torch.Tensor]:
    """conv1_1 after the 1x1 conv as one 3x3 conv of the image: the kernel
    ``sum_c' A[c, c'] K[y, x, c', o]`` and the bias ``b1 + sum K b0``."""
    a = conv0.kernel[0, 0]  # [3 in, 3 out]
    kernel = torch.einsum("ic,yxco->yxio", a, conv1_1.kernel).contiguous()
    bias = conv1_1.bias + torch.einsum("yxco,c->o", conv1_1.kernel, conv0.bias)
    return kernel, bias


def check_side(x: torch.Tensor, what: str, multiple: int = DOWNSCALE) -> None:
    """Raise unless ``x`` is [B, H, W, 3] with H and W multiples of
    ``multiple`` and at least twice it."""
    if x.dim() != 4 or x.shape[3] != 3:
        raise ValueError(f"{what} must be [B, H, W, 3], got {tuple(x.shape)}")
    h, w = x.shape[1], x.shape[2]
    if h % multiple or w % multiple or min(h, w) < 2 * multiple:
        raise ValueError(f"{what}'s sides must be multiples of {multiple} and at least "
                         f"{2 * multiple}, got {h}x{w}")


@torch.no_grad()
def encode(params: AdaINNet, x: torch.Tensor, tap: str = "relu4_1", prefix: str = "adain"):
    """relu4_1 of ``x`` [N, H, W, 3] f32 in [0, 1]: [N, H/8, W/8, 512]. With
    ``tap="relu5_1"`` (the params must hold :data:`ENCODER5`) the pair
    (relu4_1, relu5_1 [N, H/16, W/16, 512]). Spans ``<prefix>.enc.*``."""
    if tap not in TAPS:
        raise ValueError(f"tap must be one of {sorted(TAPS)}, got {tap!r}")
    span = profiling.span
    names = _spans(prefix)
    enc = params.enc
    with span(names["enc.conv1_1"]):
        kernel, bias = _fold_input_conv(enc.conv0, enc.conv1_1)
        h = conv3x3_im2col(layers.reflect_pad(x, 1), kernel, bias, relu=True)
    relu4_1 = None
    for name, *_ in ENCODER[2:] + (ENCODER5 if tap == "relu5_1" else ()):
        with span(names["enc." + name]):
            conv = getattr(enc, name)
            h, _, _ = conv3x3_valid(layers.reflect_pad(h, 1), conv.kernel, conv.bias, relu=True)
        if name == TAPS["relu4_1"]:
            relu4_1 = h
        if name in POOL_AFTER:
            with span(names["pool." + name]):
                h = layers.max_pool(h)
    return h if tap == "relu4_1" else (relu4_1, h)


def adain_affine(content_feat: torch.Tensor, style_feat: torch.Tensor,
                 alpha: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-image [N, C] scale and bias that make the instance norm of
    the content features ``alpha * t + (1 - alpha) * x``: sigma and mu of
    the style (alpha 1), or ``alpha * sigma(y) + (1 - alpha) * sigma(x)``
    and the same blend of the means, since ``(x - mu(x)) / sigma(x) *
    sigma(x) + mu(x) = x``. A style batch of one serves every image."""
    var, mean = torch.var_mean(style_feat, dim=(1, 2), unbiased=False)
    scale, bias = torch.sqrt(var + EPS), mean
    if alpha != 1.0:
        cvar, cmean = torch.var_mean(content_feat, dim=(1, 2), unbiased=False)
        scale = alpha * scale + (1.0 - alpha) * torch.sqrt(cvar + EPS)
        bias = alpha * bias + (1.0 - alpha) * cmean
    n = content_feat.shape[0]
    return scale.expand(n, -1).contiguous(), bias.expand(n, -1).contiguous()


@torch.no_grad()
def decode(params: AdaINNet, t_padded: torch.Tensor, prefix: str = "adain") -> torch.Tensor:
    """g of the AdaIN output (or of SANet's merge), reflect-padded by 1:
    [N, 8h, 8w, 3], not clamped. Spans ``<prefix>.dec.*``."""
    span = profiling.span
    names = _spans(prefix)
    h = t_padded
    for name, _, _, up, _ in DECODER:
        conv = getattr(params.dec, name)
        with span(names["dec." + name]):
            if up:
                h = upconv_phase(layers.edge_pad(h, 1), layers.upsample_phase_taps(conv.kernel),
                                 conv.bias, relu=True)
            elif name == "conv_out":
                h = conv3x3_flat(layers.reflect_pad(h, 1), conv.kernel, conv.bias)
            else:
                padded = h if name == "conv1" else layers.reflect_pad(h, 1)
                h, _, _ = conv3x3_valid(padded, conv.kernel, conv.bias, relu=True)
    return h


@torch.no_grad()
def apply(params: AdaINNet, content: torch.Tensor, style: torch.Tensor,
          alpha: float = 1.0) -> torch.Tensor:
    """``g(alpha * AdaIN(f(content), f(style)) + (1 - alpha) * f(content))``.

    ``content`` [B, H, W, 3] and ``style`` [B or 1, Hs, Ws, 3] f32 RGB in
    [0, 1], NHWC, on the params' device; every side a multiple of 8 and at
    least 16. Pair i takes style i (a style batch of one serves every
    image). Returns [B, H, W, 3] f32, unclamped. Forward only, f32."""
    check_side(content, "content")
    check_side(style, "style")
    if style.shape[0] not in (1, content.shape[0]):
        raise ValueError(f"style batch {style.shape[0]} must be 1 or the content's "
                         f"{content.shape[0]}")
    if content.dtype != torch.float32 or style.dtype != torch.float32:
        raise TypeError(f"content and style must be float32, got {content.dtype}, "
                        f"{style.dtype}")
    b = content.shape[0]
    if style.shape == content.shape:
        feat = encode(params, torch.cat([content, style]))
        content_feat, style_feat = feat[:b], feat[b:]
    else:
        content_feat, style_feat = encode(params, content), encode(params, style)
    with profiling.span(NORM_SPAN):
        scale, bias = adain_affine(content_feat, style_feat, alpha)
        t = instance_norm_pad(content_feat.contiguous(), scale, bias, pad=1)
    return decode(params, t)


def import_torch_state_dict(vgg: Mapping[str, object], decoder: Mapping[str, object],
                            device=constants.DEFAULT_DEVICE, tap: str = "relu4_1") -> AdaINNet:
    """The released layout (``vgg_normalised.pth``: keys ``<i>.weight`` /
    ``<i>.bias`` of the normalized VGG's ``nn.Sequential``, read to ``tap``,
    the later layers ignored; ``decoder.pth``: the decoder's) as the port's
    parameters, HWIO kernels. Tensors or arrays."""
    dev = constants.resolve_device(device)

    def conv(sd, idx):
        w, b = sd[f"{idx}.weight"], sd[f"{idx}.bias"]
        w = w if isinstance(w, torch.Tensor) else torch.as_tensor(np.asarray(w))
        b = b if isinstance(b, torch.Tensor) else torch.as_tensor(np.asarray(b))
        return Conv(w.detach().float().permute(2, 3, 1, 0).contiguous().to(dev),
                    b.detach().float().clone().to(dev))

    rows = ENCODER + (ENCODER5 if tap == "relu5_1" else ())
    enc = {name: conv(vgg, idx) for name, _, _, _, idx in rows}
    dec = {name: conv(decoder, idx) for name, _, _, _, idx in DECODER}
    return AdaINNet(enc, dec)


def export_torch_state_dict(params: AdaINNet) -> Tuple[Dict[str, torch.Tensor],
                                                      Dict[str, torch.Tensor]]:
    """The inverse of :func:`import_torch_state_dict`: ``(vgg, decoder)``
    state dicts of CPU tensors in the released layout (the VGG's up to
    relu4_1, or relu5_1 where the params go on), which ``torch.save``
    writes as the two files."""
    def put(out, idx, conv):
        out[f"{idx}.weight"] = conv.kernel.detach().permute(3, 2, 0, 1).contiguous().cpu()
        out[f"{idx}.bias"] = conv.bias.detach().clone().cpu()

    vgg: Dict[str, torch.Tensor] = {}
    decoder: Dict[str, torch.Tensor] = {}
    for name, _, _, _, idx in ENCODER + ENCODER5:
        if hasattr(params.enc, name):
            put(vgg, idx, getattr(params.enc, name))
    for name, _, _, _, idx in DECODER:
        put(decoder, idx, getattr(params.dec, name))
    return vgg, decoder
