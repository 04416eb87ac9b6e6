"""The image transform net ("Perceptual Losses for Real-Time Style Transfer").

The port of ``styletransfer_tpu/models/transformer.py``: parameters as
``nn.Module``s named after the JAX parameter keys, the stacked forward
(:func:`apply_stacked`, differentiable, every instance norm on the fused-IN
kernels; the training forward and ``pad_mode="zeros"``), and for serving
the pad-early forward (``_apply_padearly`` there) on three CUDA kernels:

- ``conv3x3_valid`` runs the ten 3x3 128->128 residual convs and hands the
  per-image sums of its output to the instance norm after the first conv
  of each block;
- ``instance_norm_pad`` runs all 15 instance norms, each writing its output
  already padded (reflect, or edge before a phase-form upsample conv) for the
  next conv;
- ``upconv_phase`` runs the two upsample convs in f32: each phase's 2x2
  taps on the small grid, the bias and the reassembly in one kernel;
- ``conv9x9`` runs conv_out in f32, the 9x9 32->3 conv on up2_in's padded
  output with the bias in its epilogue (in the stacked forward too, where
  ``Conv9x9Function`` takes its input gradient on the same kernel).

The other convs (9x9 conv1, stride-2 conv2/conv3, and in bf16 the phase-form
upsample convs and the space-to-depth conv_out) run as ``F.conv2d``, as the
JAX package leaves them to XLA; with ``fixed_order=True`` (the video
stylizer) they, the upsample convs and conv_out run on ``conv_direct``
instead, whose sums do not depend on the batch, so that every image of a
batch comes out bit for bit as it would alone. With ``pad_mode="zeros"`` (the reference's
own checkpoints) the forward is the stacked one, its ten residual convs on
``conv3x3_flat`` (``conv3x3_same``: a zero-padded 3x3 conv with no
statistics) wherever no weight gradient is asked for. On CPU tensors the
kernels' wrappers compute their plain PyTorch versions, which the tests hold
against the JAX forward.

Reference ``.pth`` state dicts (``nn.Sequential`` keys, OIHW kernels) cross
with :func:`import_torch_state_dict` / :func:`export_torch_state_dict`, and
:func:`init_video_params` builds the 6-channel video net, warm-started from
a fast_st net where one is given.

Both forwards mark each layer as a span (``utils/profiling.py``): the
convs ``tn.conv1`` .. ``tn.conv_out`` and ``tn.res<i>.conv<j>``, each
holding all of its layer's work as implemented here (pads, weight
re-layouts, phase forms, bias adds), and the norms ``tn.in1`` ..
``tn.up2_in`` and ``tn.res<i>.in<j>``. While spans are recorded the
stacked forward also marks each conv's backward, ``tn.<conv>.bwd``.

Architecture (identical to the reference):
- conv 9x9 s1 (3 or 6)->32, IN, ReLU; conv 3x3 s2 32->64, IN, ReLU;
  conv 3x3 s2 64->128, IN, ReLU
- 5x residual block(128): conv-IN-ReLU-conv, add the input, then IN
- 2x [nearest upsample x2 -> conv 3x3 -> IN -> ReLU] 128->64->32
- conv 9x9 32->3
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from styletransfer_tpu_torch import constants
from styletransfer_tpu_torch.ops import layers
from styletransfer_tpu_torch.ops.cuda.conv3x3 import conv3x3_valid
from styletransfer_tpu_torch.ops.cuda.conv3x3_flat import conv3x3_same
from styletransfer_tpu_torch.ops.cuda.conv9x9 import Conv9x9Function, conv9x9_valid
from styletransfer_tpu_torch.ops.cuda.conv_direct import conv_direct
from styletransfer_tpu_torch.ops.cuda.fused_instance_norm import fused_instance_norm
from styletransfer_tpu_torch.ops.cuda.instance_norm import instance_norm_pad
from styletransfer_tpu_torch.ops.cuda.upconv_phase import upconv_phase
from styletransfer_tpu_torch.utils import profiling

NUM_RESIDUAL_BLOCKS = 5


class Conv(nn.Module):
    """Conv parameters: ``kernel`` [kh, kw, cin, cout] (HWIO) and ``bias``."""

    def __init__(self, kernel: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(bias)


class InstanceNorm(nn.Module):
    """Affine instance-norm parameters: ``scale`` and ``bias`` [C]."""

    def __init__(self, scale: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.scale = nn.Parameter(scale)
        self.bias = nn.Parameter(bias)


class ResidualBlock(nn.Module):
    def __init__(self, conv1: Conv, in1: InstanceNorm, conv2: Conv, in2: InstanceNorm):
        super().__init__()
        self.conv1, self.in1, self.conv2, self.in2 = conv1, in1, conv2, in2


class TransformerNet(nn.Module):
    """ImageTransformNet parameters, with the JAX parameter tree's names
    (``conv1``, ``in1``, ``res1.conv1``, ..., ``up1_conv``, ``conv_out``)."""

    def __init__(self, convs: Mapping[str, Conv], norms: Mapping[str, InstanceNorm],
                 blocks: Mapping[str, ResidualBlock]):
        super().__init__()
        for name, module in {**convs, **norms, **blocks}.items():
            self.add_module(name, module)

    def forward(self, x: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return apply(self, x, compute_dtype)


# (name, kernel size, in channels (None = the net's input), out channels)
_CONVS = [("conv1", 9, None, 32), ("conv2", 3, 32, 64), ("conv3", 3, 64, 128),
          ("up1_conv", 3, 128, 64), ("up2_conv", 3, 64, 32), ("conv_out", 9, 32, 3)]
_NORMS = [("in1", 32), ("in2", 64), ("in3", 128), ("up1_in", 64), ("up2_in", 32)]
# Span names by layer, made once: a forward formats no string. _RES_SPANS[i]
# holds block i + 1's (conv1, in1, conv2, in2).
_SPAN = {name: "tn." + name for name in [n for n, *_ in _CONVS] + [n for n, _ in _NORMS]}
_RES_SPANS = [tuple(f"tn.res{i + 1}.{layer}" for layer in ("conv1", "in1", "conv2", "in2"))
              for i in range(NUM_RESIDUAL_BLOCKS)]
_BWD_SPAN = {s: s + ".bwd" for s in [_SPAN[n] for n, *_ in _CONVS]
             + [s for spans in _RES_SPANS for s in spans[0::2]]}


def init_params(
    seed: int = 0,
    in_channels: int = 3,
    device=constants.DEFAULT_DEVICE,
) -> TransformerNet:
    """Seeded fan-in-uniform f32 init (``in_channels=6`` for the video net).

    The numbers differ from the JAX package's for the same seed (another
    generator); :func:`params_from_jax` carries JAX parameters across."""
    dev = constants.resolve_device(device)
    gen = torch.Generator().manual_seed(seed)

    def conv(k, cin, cout):
        return Conv(*layers.init_conv(gen, k, k, cin, cout, device=dev))

    def norm(c):
        return InstanceNorm(*layers.init_instance_norm(c, device=dev))

    convs = {n: conv(k, cin or in_channels, cout) for n, k, cin, cout in _CONVS}
    norms = {n: norm(c) for n, c in _NORMS}
    blocks = {
        f"res{i + 1}": ResidualBlock(conv(3, 128, 128), norm(128), conv(3, 128, 128), norm(128))
        for i in range(NUM_RESIDUAL_BLOCKS)
    }
    return TransformerNet(convs, norms, blocks)


def params_from_jax(tree: Mapping[str, Any], device=constants.DEFAULT_DEVICE) -> TransformerNet:
    """Build the port's parameters from a JAX parameter tree (nested dicts of
    numpy arrays, e.g. ``jax.device_get(params)`` or a loaded checkpoint)."""
    dev = constants.resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a, copy=True)).to(dev)

    def conv(p):
        return Conv(t(p["kernel"]), t(p["bias"]))

    def norm(p):
        return InstanceNorm(t(p["scale"]), t(p["bias"]))

    convs = {n: conv(tree[n]) for n, *_ in _CONVS}
    norms = {n: norm(tree[n]) for n, _ in _NORMS}
    blocks = {}
    for i in range(NUM_RESIDUAL_BLOCKS):
        r = tree[f"res{i + 1}"]
        blocks[f"res{i + 1}"] = ResidualBlock(
            conv(r["conv1"]), norm(r["in1"]), conv(r["conv2"]), norm(r["in2"])
        )
    return TransformerNet(convs, norms, blocks)


def init_video_params(
    seed: int = 0,
    fast_params=None,
    device=constants.DEFAULT_DEVICE,
) -> TransformerNet:
    """The 6-channel video net: input [current frame, previous stylized
    frame] on channels. Given ``fast_params`` (a trained 3-channel net, as a
    module or a JAX-layout tree) every layer but the first conv is copied
    from it: the reference's state-dict surgery drops exactly ``0.weight``
    and ``0.bias``, so the first instance norm is warm-started too."""
    params = init_params(seed, in_channels=6, device=device)
    if fast_params is not None:
        tree = fast_params if isinstance(fast_params, Mapping) else params_to_tree(fast_params)
        warm = params_from_jax(tree, device=device)
        warm.conv1 = params.conv1
        params = warm
    return params


def params_to_tree(params: nn.Module) -> Dict[str, Any]:
    """The JAX parameter tree of ``params``: nested dicts of numpy arrays."""
    tree: Dict[str, Any] = {}
    for key, value in params.state_dict().items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value.detach().cpu().numpy()
    return tree


def num_params(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


def _conv(x, kernel, bias, stride, cd, padding="valid", fixed_order=False):
    """A conv that the JAX package leaves to XLA: ``layers.conv2d`` (cuDNN
    on the card), or with ``fixed_order`` the padding (reflect or zeros, by
    k // 2), then ``conv_direct``, whose sums for an image do not depend on
    the batch (forward only)."""
    if not fixed_order:
        return layers.conv2d(x, kernel, bias, stride, compute_dtype=cd, padding=padding)
    if cd is not None:
        x = x.to(cd)
    pad = kernel.shape[0] // 2
    if padding == "reflect":
        x = layers.reflect_pad(x, pad)
    elif padding == "zeros":
        x = layers.zero_pad(x, pad)
    return conv_direct(x.contiguous(), kernel.to(x.dtype), bias, stride)


def _conv_in_relu(x, conv: Conv, norm: InstanceNorm, stride, cd, padding, fixed_order,
                  spans, upsample=False):
    """conv (after a nearest x2 upsample with ``upsample``), IN, ReLU; the
    conv and the norm are the spans ``spans``."""
    with profiling.span(spans[0]):
        h = layers.upsample_nearest(x, 2) if upsample else x
        h = _conv(h, conv.kernel, conv.bias, stride, cd, padding, fixed_order)
    profiling.backward_span(_BWD_SPAN[spans[0]], h, x)
    with profiling.span(spans[1]):
        return fused_instance_norm(h, norm.scale, norm.bias, relu=True)


def _res_conv(x, p: Conv, cd, padding, fixed_order):
    """A residual 3x3 128->128 conv. Zero-padded with no weight gradient to
    take (the serving forward), it runs on ``conv3x3_flat``; otherwise as
    :func:`_conv`, since ``conv3x3_same`` has no weight-gradient kernel."""
    if padding == "zeros" and not (torch.is_grad_enabled() and p.kernel.requires_grad):
        return conv3x3_same(x, p.kernel.to(x.dtype), p.bias)
    return _conv(x, p.kernel, p.bias, 1, cd, padding, fixed_order)


def _residual_block(x, p: ResidualBlock, cd, padding, fixed_order, spans):
    """conv-IN-ReLU-conv, then IN of (out + the block's input): the residual
    add is inside the second norm's kernel. ``spans``: the four layers'."""
    conv1, in1, conv2, in2 = spans
    with profiling.span(conv1):
        h = _res_conv(x, p.conv1, cd, padding, fixed_order)
    profiling.backward_span(_BWD_SPAN[conv1], h, x)
    with profiling.span(in1):
        y = fused_instance_norm(h, p.in1.scale, p.in1.bias, relu=True)
    with profiling.span(conv2):
        h = _res_conv(y, p.conv2, cd, padding, fixed_order)
    profiling.backward_span(_BWD_SPAN[conv2], h, y)
    with profiling.span(in2):
        return fused_instance_norm(h, p.in2.scale, p.in2.bias, residual=x)


def apply_stacked(
    params: TransformerNet,
    x: torch.Tensor,
    compute_dtype: Optional[torch.dtype] = None,
    pad_mode: str = "reflect",
    fixed_order: bool = False,
) -> torch.Tensor:
    """The stacked forward, differentiable: the port of the JAX
    ``_apply_stacked`` with ``use_pallas=True``.

    Each conv pads its own input (``pad_mode`` "reflect" or "zeros") and
    runs as ``F.conv2d``, except the ten residual convs of a zero-padded
    forward that takes no weight gradient, which run on ``conv3x3_flat``,
    and conv_out in f32, which runs on ``conv9x9`` (``Conv9x9Function``: the
    kernel forward and for the input gradient, cuDNN's weight gradient);
    all 15 instance norms run on the fused-IN kernels and their backward
    (``ops/cuda/fused_instance_norm.py``). This is the training forward; in
    exact arithmetic it equals the pad-early :func:`apply` (the two differ
    by about 1e-6 in f32). ``fixed_order=True`` (forward only: it raises
    where a gradient is wanted) runs the ``F.conv2d`` convs on
    ``conv_direct`` instead, so that an image's output does not depend on
    the batch."""
    if pad_mode not in ("reflect", "zeros"):
        raise ValueError(f"pad_mode must be 'reflect' or 'zeros', got {pad_mode!r}")
    in_dtype = x.dtype
    cd = compute_dtype
    if cd is not None:
        x = x.to(cd)
    fo = fixed_order
    sp = _SPAN
    x = _conv_in_relu(x, params.conv1, params.in1, 1, cd, pad_mode, fo, (sp["conv1"], sp["in1"]))
    x = _conv_in_relu(x, params.conv2, params.in2, 2, cd, pad_mode, fo, (sp["conv2"], sp["in2"]))
    x = _conv_in_relu(x, params.conv3, params.in3, 2, cd, pad_mode, fo, (sp["conv3"], sp["in3"]))
    for i in range(NUM_RESIDUAL_BLOCKS):
        x = _residual_block(x, getattr(params, f"res{i + 1}"), cd, pad_mode, fo, _RES_SPANS[i])
    x = _conv_in_relu(x, params.up1_conv, params.up1_in, 1, cd, pad_mode, fo,
                      (sp["up1_conv"], sp["up1_in"]), upsample=True)
    x = _conv_in_relu(x, params.up2_conv, params.up2_in, 1, cd, pad_mode, fo,
                      (sp["up2_conv"], sp["up2_in"]), upsample=True)
    with profiling.span(sp["conv_out"]):
        out = _conv_out_stacked(x, params.conv_out, cd, pad_mode, fo)
    profiling.backward_span(_BWD_SPAN[sp["conv_out"]], out, x)
    return out.to(in_dtype)


def _conv_out_stacked(x, p: Conv, cd, padding, fixed_order):
    """conv_out of the stacked forward, padding its own input. In f32
    without ``fixed_order``, the pad (autograd ops) and ``Conv9x9Function``
    (the conv9x9 kernel forward and for the input gradient; its plain
    version on the CPU); otherwise :func:`_conv`."""
    if x.dtype == torch.float32 and not fixed_order:
        xp = layers.reflect_pad(x, 4) if padding == "reflect" else layers.zero_pad(x, 4)
        return Conv9x9Function.apply(xp, p.kernel, p.bias)
    return _conv(x, p.kernel, p.bias, 1, cd, padding, fixed_order)


def _conv_valid(x, p: Conv, stride, cd, fixed_order):
    return _conv(x, p.kernel, p.bias, stride, cd, fixed_order=fixed_order)


def _conv3x3(y, p: Conv, cd):
    """A residual conv on the conv3x3 kernel: (out, sums, sumsqs)."""
    w = p.kernel if cd is None else p.kernel.to(cd)
    return conv3x3_valid(y, w, p.bias, relu=False)


def _in_pad(h, p: InstanceNorm, pad, relu=True, residual=None, res_pad=0,
            mode="reflect", stats=None):
    return instance_norm_pad(h, p.scale, p.bias, residual=residual, res_pad=res_pad,
                             relu=relu, pad=pad, mode=mode, stats=stats)


def _conv_phase_up(y_padded, p: Conv, cd, fixed_order):
    """Phase-form ``upsample x2 -> reflect-pad 1 -> conv3x3`` of the small
    grid (input edge-padded by 1): [B, 2h, 2w, Cout]. In f32 without
    ``fixed_order``, ``upconv_phase`` (each phase's 2x2 taps, the bias and the
    reassembly in one kernel; its plain version on the CPU); otherwise one
    VALID conv of the 3x3 phase kernel (:func:`_conv`), output channel order
    (py, px, o), then ``depth_to_space``."""
    if y_padded.dtype == torch.float32 and not fixed_order:
        return upconv_phase(y_padded, layers.upsample_phase_taps(p.kernel), p.bias)
    kp = layers.upsample_phase_kernel(p.kernel)
    return layers.depth_to_space(
        _conv(y_padded, kp, p.bias.repeat(4), 1, cd, fixed_order=fixed_order), 2)


def _conv_out(y_padded, p: Conv, cd, fixed_order):
    """conv_out, the 9x9 32->3 conv, of its input reflect-padded by 4. In f32
    without ``fixed_order``, ``conv9x9`` (the bias in its epilogue; its plain
    version on the CPU); otherwise in 4x4 space-to-depth phase form (3x3,
    512->48) as :func:`_conv`, then ``depth_to_space`` and the bias."""
    if y_padded.dtype == torch.float32 and not fixed_order:
        return conv9x9_valid(y_padded, p.kernel, p.bias)
    kp = layers.phase_conv_kernel(p.kernel, 4)
    out = _conv(layers.space_to_depth(y_padded, 4), kp, None, 1, cd, fixed_order=fixed_order)
    return layers.depth_to_space(out, 4) + p.bias.to(out.dtype)


@torch.no_grad()
def apply(
    params: TransformerNet,
    x: torch.Tensor,
    compute_dtype: Optional[torch.dtype] = None,
    pad_mode: str = "reflect",
    fixed_order: bool = False,
) -> torch.Tensor:
    """Forward pass, forward only: NHWC in (3 or 6 channels), NHWC out.

    With ``compute_dtype=torch.bfloat16`` activations stay bf16 between ops
    (instance-norm statistics are f32); the output has the input's dtype.
    This is the pad-early formulation: every IN writes its output padded for
    the next conv, and the convs run VALID. The instance norms here take the
    exact two-pass variance (or the conv kernel's one-pass sums), where the
    JAX forward takes the one-pass form everywhere: the two differ by about
    1e-6.

    ``pad_mode="zeros"`` zero-pads every conv, as the reference's own
    checkpoints were trained (see the JAX ``apply``); it runs the stacked
    form (:func:`apply_stacked`), since zero padding belongs to the conv:
    per forward 10 ``conv3x3_flat`` and 15 fused-IN forward launches, and
    in f32 one ``conv9x9``.

    ``fixed_order=True`` runs the six convs outside the residual blocks on
    ``conv_direct`` (cuDNN's summation order follows the batch size); every
    other op of the forward is per image and sums in an order its plan
    fixes without the batch. So each image of the batch comes out bit for
    bit as it would alone: the video stylizer's lanes need this, image
    serving does not pay for it.

    The instance-norm ``scale``/``bias`` may be [C] or per image [B, C]
    (multi-style, ``models/multistyle.py``).
    """
    if pad_mode not in ("reflect", "zeros"):
        raise ValueError(f"pad_mode must be 'reflect' or 'zeros', got {pad_mode!r}")
    if pad_mode == "zeros":
        return apply_stacked(params, x, compute_dtype, pad_mode="zeros", fixed_order=fixed_order)
    in_dtype = x.dtype
    cd = compute_dtype
    if cd is not None:
        x = x.to(cd)

    fo = fixed_order
    span = profiling.span
    with span(_SPAN["conv1"]):
        h = _conv_valid(layers.reflect_pad(x, 4), params.conv1, 1, cd, fo)
    with span(_SPAN["in1"]):
        y = _in_pad(h, params.in1, pad=1)                          # [B,H+2,W+2,32]
    with span(_SPAN["conv2"]):
        h = _conv_valid(y, params.conv2, 2, cd, fo)
    with span(_SPAN["in2"]):
        y = _in_pad(h, params.in2, pad=1)
    with span(_SPAN["conv3"]):
        h = _conv_valid(y, params.conv3, 2, cd, fo)
    with span(_SPAN["in3"]):
        y = _in_pad(h, params.in3, pad=1)

    for i in range(NUM_RESIDUAL_BLOCKS):
        r = getattr(params, f"res{i + 1}")
        conv1, in1, conv2, in2 = _RES_SPANS[i]
        with span(conv1):
            h1, s1, ss1 = _conv3x3(y, r.conv1, cd)
        with span(in1):
            y1 = _in_pad(h1, r.in1, pad=1, stats=(s1, ss1))
        with span(conv2):
            h2, _, _ = _conv3x3(y1, r.conv2, cd)
        last = i == NUM_RESIDUAL_BLOCKS - 1
        # The block's input is the interior of the padded y. The last block
        # feeds a phase-form upsample conv, which wants EDGE padding.
        with span(in2):
            y = _in_pad(h2, r.in2, pad=1, relu=False, residual=y, res_pad=1,
                        mode="edge" if last else "reflect")

    # Decoder in 2x2 phase form; the phase output is reassembled
    # (depth_to_space) before the IN kernel, whose statistics over the
    # reassembled tensor are the statistics pooled over the phases.
    with span(_SPAN["up1_conv"]):
        h = _conv_phase_up(y, params.up1_conv, cd, fo)                # [B,2h,2w,64]
    with span(_SPAN["up1_in"]):
        y = _in_pad(h, params.up1_in, pad=1, mode="edge")
    with span(_SPAN["up2_conv"]):
        h = _conv_phase_up(y, params.up2_conv, cd, fo)
    with span(_SPAN["up2_in"]):
        y = _in_pad(h, params.up2_in, pad=4)                       # conv_out is 9x9
    with span(_SPAN["conv_out"]):
        out = _conv_out(y, params.conv_out, cd, fo)
    return out.to(in_dtype)


# The reference's nn.Sequential indices -> the port's parameter names: (index,
# name, kind) of the convs and instance norms outside the residual blocks,
# and the module index of each residual block (keys "{idx}.conv1",
# "{idx}.insn1", "{idx}.conv2", "{idx}.insn2").
_SEQ_MAP = [
    ("0", "conv1", "conv"), ("1", "in1", "in"),
    ("3", "conv2", "conv"), ("4", "in2", "in"),
    ("6", "conv3", "conv"), ("7", "in3", "in"),
    ("15", "up1_conv", "conv"), ("16", "up1_in", "in"),
    ("19", "up2_conv", "conv"), ("20", "up2_in", "in"),
    ("22", "conv_out", "conv"),
]
_RES_SEQ_IDX = ("9", "10", "11", "12", "13")


def import_torch_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """A reference ``ImageTransformNet`` / ``VideoTransformNet`` state dict
    (torch ``nn.Sequential`` keys, OIHW kernels; tensors or arrays) as the
    JAX parameter tree (HWIO kernels, numpy), for :func:`params_from_jax`."""
    def arr(key):
        v = state_dict[key]
        return np.asarray(v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)

    def conv(prefix):
        return {"kernel": np.ascontiguousarray(arr(f"{prefix}.weight").transpose(2, 3, 1, 0)),
                "bias": arr(f"{prefix}.bias")}

    def norm(prefix):
        return {"scale": arr(f"{prefix}.weight"), "bias": arr(f"{prefix}.bias")}

    tree: Dict[str, Any] = {name: conv(idx) if kind == "conv" else norm(idx)
                            for idx, name, kind in _SEQ_MAP}
    for i, idx in enumerate(_RES_SEQ_IDX):
        tree[f"res{i + 1}"] = {"conv1": conv(f"{idx}.conv1"), "in1": norm(f"{idx}.insn1"),
                               "conv2": conv(f"{idx}.conv2"), "in2": norm(f"{idx}.insn2")}
    return tree


def export_torch_state_dict(params) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`import_torch_state_dict`: ``params`` (a module
    or a JAX-layout tree) as a reference state dict of CPU tensors, which
    ``torch.save`` writes as the reference's ``.pth``."""
    tree = params if isinstance(params, Mapping) else params_to_tree(params)
    out: Dict[str, torch.Tensor] = {}

    def t(a):
        return torch.tensor(np.ascontiguousarray(a))

    def put(prefix, p, kind):
        if kind == "conv":
            out[f"{prefix}.weight"] = t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
            out[f"{prefix}.bias"] = t(p["bias"])
        else:
            out[f"{prefix}.weight"] = t(p["scale"])
            out[f"{prefix}.bias"] = t(p["bias"])

    for idx, name, kind in _SEQ_MAP:
        put(idx, tree[name], kind)
    for i, idx in enumerate(_RES_SEQ_IDX):
        r = tree[f"res{i + 1}"]
        put(f"{idx}.conv1", r["conv1"], "conv")
        put(f"{idx}.insn1", r["in1"], "in")
        put(f"{idx}.conv2", r["conv2"], "conv")
        put(f"{idx}.insn2", r["in2"], "in")
    return out
