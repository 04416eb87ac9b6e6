"""SANet arbitrary style transfer ("Arbitrary Style Transfer with
Style-Attentional Networks", Park & Lee, CVPR 2019, arXiv:1812.02342): every
content position takes a softmax-weighted mix of all style positions, at
relu4_1 and at relu5_1.

Not the port of a JAX model: the JAX package has no SANet. The layers follow
the public PyTorch re-implementation's ``net.py`` and ``Eval.py``, which
reuse AdaIN's normalized VGG and decoder (``models/adain.py``):

- encoder f: AdaIN's, on past relu4_1 through conv4_2 .. conv4_4, a 2x2 max
  pool and conv5_1 (512 -> 512 each, reflect pad, ReLU); taps relu4_1 and
  relu5_1;
- mean-variance norm: ``(x - mu(x)) / sqrt(var(x) + eps)`` per image and
  channel over positions, with the re-implementation's unbiased variance;
- a SANet block at each tap, content features c and style features s
  ([B, N, 512], positions row-major): ``Q = norm(c) Wf + bf``, ``K =
  norm(s) Wg + bg``, ``V = s Wh + bh`` (1x1 convs), ``O = softmax(Q K^T)
  V Wo + bo + c``, the softmax over the style positions, with no
  1/sqrt(d) scale;
- the merge: ``conv3x3(reflect_pad(SANet4(c4, s4) + up2(SANet5(c5,
  s5)), 1))`` with a bias and no ReLU, ``up2`` a nearest x2 upsample;
- decoder g: AdaIN's, on the merge; one step.

:func:`apply` runs the forward on the port's kernels, NHWC and f32: the
encoder through ``adain.encode`` (content and style as one batch where their
shapes agree), the norms as plain PyTorch statistics passes, the eight 1x1
convs as ``torch.addmm`` on [B N, 512], the attention on
``ops/cuda/attention.py`` (the [Nq, Nk] scores never reach device memory),
the merge conv on ``conv3x3_valid`` without its ReLU, and the decoder through
``adain.decode``. Each layer is a span (``utils/profiling.py``):
``sanet.enc.<conv>`` and ``sanet.enc.pool<i>``; per block
``sanet.<tap>.norm``, ``.proj`` (Q, K, V), ``.attn`` (the kernel alone) and
``.out`` (the out conv and the residual), ``tap`` ``r4_1`` or ``r5_1``;
``sanet.merge`` (the upsample, the add, the pad and the conv);
``sanet.dec.<conv>``.

Weights: :func:`import_torch_state_dict` reads the three released files'
layout (``vgg_normalised.pth`` to index 42, ``decoder_iter_500000.pth``,
``transformer_iter_500000.pth``) and :func:`export_torch_state_dict`
writes it; :func:`init_params` makes seeded ones.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from styletransfer_tpu_torch import constants
from styletransfer_tpu_torch.models import adain
from styletransfer_tpu_torch.models.transformer import Conv
from styletransfer_tpu_torch.ops import layers
from styletransfer_tpu_torch.ops.cuda.attention import attention
from styletransfer_tpu_torch.ops.cuda.conv3x3 import conv3x3_valid
from styletransfer_tpu_torch.utils import profiling

FEATURES = 512
EPS = 1e-5
# Four pools: the image sides must be multiples of this, so that relu5_1's
# grid upsampled by 2 is relu4_1's.
DOWNSCALE = 16
# The blocks, by tap: (span name, key prefix in transformer_iter_500000.pth).
BLOCKS = (("r4_1", "sanet4_1"), ("r5_1", "sanet5_1"))
# A block's 1x1 convs: (the port's name, the released file's).
BLOCK_CONVS = (("f", "f"), ("g", "g"), ("h", "h"), ("out", "out_conv"))
# The seeded init's query and key convs (Wf, Wg): fan-in normal times this,
# so that the logits Q K^T spread by a few units over seeded images (a
# softmax neither near uniform nor near one-hot; see init_params).
LOGIT_GAIN = 0.5

_SPANS = {tap: {part: f"sanet.{tap}.{part}" for part in ("norm", "proj", "attn", "out")}
          for tap, _ in BLOCKS}
MERGE_SPAN = "sanet.merge"


class Block(nn.Module):
    """One SANet block's 1x1 convs ``f``, ``g``, ``h``, ``out``: each a
    :class:`transformer.Conv` with an HWIO [1, 1, 512, 512] ``kernel``."""

    def __init__(self, convs: Mapping[str, Conv]):
        super().__init__()
        for name, _ in BLOCK_CONVS:
            self.add_module(name, convs[name])


class Transform(nn.Module):
    """``sanet4_1``, ``sanet5_1`` (:class:`Block`) and ``merge`` (3x3, HWIO)."""

    def __init__(self, sanet4_1: Block, sanet5_1: Block, merge: Conv):
        super().__init__()
        self.sanet4_1 = sanet4_1
        self.sanet5_1 = sanet5_1
        self.merge = merge


class SANetNet(nn.Module):
    """SANet's parameters: AdaIN's ``enc`` (to conv5_1) and ``dec``, and
    ``transform`` (:class:`Transform`)."""

    def __init__(self, net: adain.AdaINNet, transform: Transform):
        super().__init__()
        self.enc = net.enc
        self.dec = net.dec
        self.transform = transform


def init_params(seed: int = 0, device=constants.DEFAULT_DEVICE) -> SANetNet:
    """Seeded f32 weights, one generator: the encoder (to conv5_1) and the
    decoder by ``adain.init_params``' rule, then per block ``f`` and ``g``
    fan-in normal (std sqrt(1 / 512)) times :data:`LOGIT_GAIN`, ``h`` and
    ``out`` fan-in normal, and the merge conv fan-in normal (std
    sqrt(1 / (9 * 512))); every bias U(-0.1, 0.1)."""
    dev = constants.resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    enc, dec = adain.seeded_convs(gen, dev, tap="relu5_1")

    def conv(k, std):
        kernel = torch.randn((k, k, FEATURES, FEATURES), generator=gen) * std
        bias = torch.rand((FEATURES,), generator=gen) * 0.2 - 0.1
        return Conv(kernel.to(dev), bias.to(dev))

    fan_in = (1.0 / FEATURES) ** 0.5
    blocks = []
    for _ in BLOCKS:
        blocks.append(Block({name: conv(1, fan_in * (LOGIT_GAIN if name in ("f", "g") else 1.0))
                             for name, _ in BLOCK_CONVS}))
    merge = conv(3, (1.0 / (9 * FEATURES)) ** 0.5)
    return SANetNet(adain.AdaINNet(enc, dec), Transform(*blocks, merge))


def mean_variance_norm(x: torch.Tensor) -> torch.Tensor:
    """``(x - mean) / sqrt(var + eps)`` of ``x`` [B, N, C] over N per image
    and channel, the unbiased variance."""
    var, mean = torch.var_mean(x, dim=1, keepdim=True, unbiased=True)
    return (x - mean) / torch.sqrt(var + EPS)


def _pointwise(x: torch.Tensor, conv: Conv) -> torch.Tensor:
    """A 1x1 conv of ``x`` [B, N, C]: ``x W + b``."""
    b, n, c = x.shape
    return torch.addmm(conv.bias, x.reshape(b * n, c), conv.kernel[0, 0]).reshape(b, n, -1)


@torch.no_grad()
def block(params: Block, content: torch.Tensor, style: torch.Tensor, tap: str) -> torch.Tensor:
    """One SANet block: ``content`` [B, h, w, 512], ``style`` [B or 1, hs,
    ws, 512] -> [B, h, w, 512]."""
    span = profiling.span
    names = _SPANS[tap]
    b, h, w, c = content.shape
    cf = content.reshape(b, h * w, c)
    sf = style.reshape(style.shape[0], -1, c)
    with span(names["norm"]):
        cn, sn = mean_variance_norm(cf), mean_variance_norm(sf)
    with span(names["proj"]):
        q, k, v = _pointwise(cn, params.f), _pointwise(sn, params.g), _pointwise(sf, params.h)
        del cn, sn
    with span(names["attn"]):
        a = attention(q, k, v)
        del q, k, v
    with span(names["out"]):
        out = _pointwise(a, params.out)
        out += cf
    return out.reshape(b, h, w, c)


@torch.no_grad()
def apply(params: SANetNet, content: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """``g(merge(SANet4(c4, s4), SANet5(c5, s5)))``.

    ``content`` [B, H, W, 3] and ``style`` [B or 1, Hs, Ws, 3] f32 RGB in
    [0, 1], NHWC, on the params' device; every side a multiple of 16 and at
    least 32. Pair i takes style i (a style batch of one serves every
    image). Returns [B, H, W, 3] f32, unclamped. Forward only, f32."""
    adain.check_side(content, "content", DOWNSCALE)
    adain.check_side(style, "style", DOWNSCALE)
    if style.shape[0] not in (1, content.shape[0]):
        raise ValueError(f"style batch {style.shape[0]} must be 1 or the content's "
                         f"{content.shape[0]}")
    if content.dtype != torch.float32 or style.dtype != torch.float32:
        raise TypeError(f"content and style must be float32, got {content.dtype}, "
                        f"{style.dtype}")
    b = content.shape[0]
    if style.shape == content.shape:
        f4, f5 = adain.encode(params, torch.cat([content, style]), "relu5_1", "sanet")
        c4, s4, c5, s5 = f4[:b], f4[b:], f5[:b], f5[b:]
    else:
        c4, c5 = adain.encode(params, content, "relu5_1", "sanet")
        s4, s5 = adain.encode(params, style, "relu5_1", "sanet")
    t = params.transform
    o4 = block(t.sanet4_1, c4, s4, "r4_1")
    o5 = block(t.sanet5_1, c5, s5, "r5_1")
    del c4, s4, c5, s5
    with profiling.span(MERGE_SPAN):
        o4 += layers.upsample_nearest(o5, 2)
        m, _, _ = conv3x3_valid(layers.reflect_pad(o4, 1), t.merge.kernel, t.merge.bias)
        del o4, o5
    return adain.decode(params, layers.reflect_pad(m, 1), prefix="sanet")


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def import_torch_state_dict(vgg: Mapping[str, object], decoder: Mapping[str, object],
                            transformer: Mapping[str, object],
                            device=constants.DEFAULT_DEVICE) -> SANetNet:
    """The released layout as the port's parameters: ``vgg_normalised.pth``
    (the normalized VGG's ``nn.Sequential`` to index 42, conv5_1),
    ``decoder_iter_500000.pth`` (AdaIN's decoder layout) and
    ``transformer_iter_500000.pth`` (keys ``sanet4_1.{f,g,h,out_conv}``,
    ``sanet5_1.*``, ``merge_conv``, each ``.weight`` OIHW and ``.bias``).
    Tensors or arrays."""
    missing = [f"{idx}.weight" for *_, idx in adain.ENCODER5 if f"{idx}.weight" not in vgg]
    if missing:
        raise KeyError(f"SANet's VGG goes on to relu5_1; the state dict lacks {missing}")
    net = adain.import_torch_state_dict(vgg, decoder, device=device, tap="relu5_1")
    dev = constants.resolve_device(device)

    def conv(key):
        w, b = _tensor(transformer[f"{key}.weight"]), _tensor(transformer[f"{key}.bias"])
        return Conv(w.detach().float().permute(2, 3, 1, 0).contiguous().to(dev),
                    b.detach().float().clone().to(dev))

    blocks = [Block({name: conv(f"{prefix}.{key}") for name, key in BLOCK_CONVS})
              for _, prefix in BLOCKS]
    return SANetNet(net, Transform(*blocks, conv("merge_conv")))


def export_torch_state_dict(params: SANetNet) -> Tuple[Dict[str, torch.Tensor],
                                                      Dict[str, torch.Tensor],
                                                      Dict[str, torch.Tensor]]:
    """The inverse of :func:`import_torch_state_dict`: ``(vgg, decoder,
    transformer)`` state dicts of CPU tensors in the released layout, which
    ``torch.save`` writes as the three files."""
    vgg, decoder = adain.export_torch_state_dict(params)
    transformer: Dict[str, torch.Tensor] = {}

    def put(key, conv):
        transformer[f"{key}.weight"] = conv.kernel.detach().permute(3, 2, 0, 1).contiguous().cpu()
        transformer[f"{key}.bias"] = conv.bias.detach().clone().cpu()

    t = params.transform
    for (_, prefix), blk in zip(BLOCKS, (t.sanet4_1, t.sanet5_1)):
        for name, key in BLOCK_CONVS:
            put(f"{prefix}.{key}", getattr(blk, name))
    put("merge_conv", t.merge)
    return vgg, decoder, transformer
