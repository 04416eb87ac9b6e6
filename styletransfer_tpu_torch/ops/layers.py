"""Neural-net building blocks as plain PyTorch functions on NHWC tensors.

The port of what the pad-early forward, the stacked (training) forward and
the VGG tower need from ``styletransfer_tpu/ops/layers.py``. The layout is
the JAX package's: NHWC activations and HWIO conv kernels. ``F.conv2d``
takes an NHWC tensor through ``permute(0, 3, 1, 2)``, a ``channels_last``
view with no copy.

Parity notes (the same as the JAX module's):
- reflection padding does not repeat the edge pixel; edge padding does;
- instance norm uses eps=1e-5 and the biased variance, per (sample, channel).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def disable_tf32() -> None:
    """Keep f32 convolutions and matmuls in full f32 on the GPU, unless
    ``STX_MATMUL_PRECISION`` asks for less (``utils/cache.py``).

    cuDNN runs f32 convolutions in TF32 by default (about three decimal
    digits), which would drift from the f32 JAX reference; both flags are
    set explicitly. With the knob set to a valid value, its flags apply
    instead (``high``: TF32 on). The hand-written kernels compute f32 with
    FMAs whatever the knob says."""
    from styletransfer_tpu_torch.utils import cache

    if cache.apply_matmul_precision():
        return
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _pad_index(n: int, pad: int, mode: str, device) -> torch.Tensor:
    i = torch.arange(-pad, n + pad, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    i = i.abs()
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def _pad(x: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    if pad == 0:
        return x
    if mode == "reflect" and pad >= min(x.shape[1], x.shape[2]):
        raise ValueError(f"reflect padding {pad} needs H and W > {pad}, got {tuple(x.shape)}")
    iy = _pad_index(x.shape[1], pad, mode, x.device)
    ix = _pad_index(x.shape[2], pad, mode, x.device)
    return x.index_select(1, iy).index_select(2, ix)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflection-pad the spatial dims of an NHWC tensor by ``pad`` per side."""
    return _pad(x, pad, "reflect")


def zero_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad the spatial dims of an NHWC tensor by ``pad`` per side."""
    return F.pad(x, (0, 0, pad, pad, pad, pad)) if pad else x


def edge_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Edge (replicate) padding of the spatial dims.

    The small-grid form of reflection padding after a 2x nearest upsample:
    with u = upsample2(s), u[-1] = u[1] = s[0] (see upsample_phase_kernel)."""
    return _pad(x, pad, "edge")


def conv2d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    compute_dtype: Optional[torch.dtype] = None,
    padding: str = "valid",
) -> torch.Tensor:
    """2-D convolution of an NHWC input; differentiable.

    ``kernel`` is HWIO. ``padding``: "valid" (the input is already padded),
    "reflect" (reflection padding of k//2, the transform net's) or "zeros"
    (zero padding of k//2, VGG's). With a ``compute_dtype`` the inputs are
    cast to it and the output comes in it (the product still accumulates in
    f32); the bias is added in the output's dtype, as in the JAX function."""
    if padding not in ("valid", "reflect", "zeros"):
        raise ValueError(f"padding must be 'valid', 'reflect' or 'zeros', got {padding!r}")
    pad = kernel.shape[0] // 2
    if padding == "reflect":
        x = reflect_pad(x, pad)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        kernel = kernel.to(compute_dtype)
    w = kernel.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    out = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride,
                   padding=pad if padding == "zeros" else 0).permute(0, 2, 3, 1)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.contiguous()


def instance_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """Affine instance norm over the spatial dims of NHWC ``x``, as
    ``nn.InstanceNorm2d(C, affine=True)``: per (sample, channel), biased
    variance, in f32; the output has ``x.dtype``. ``scale``/``bias`` are
    [C] or [B, C]."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2), keepdim=True)
    var = (x32 - mean).square().mean(dim=(1, 2), keepdim=True)
    if scale.dim() == 2:
        scale, bias = scale[:, None, None, :], bias[:, None, None, :]
    return ((x32 - mean) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample of NHWC by an integer factor
    (``nn.Upsample(mode='nearest', scale_factor=factor)``)."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, factor, w, factor, c)
    return x.reshape(n, h * factor, w * factor, c)


def max_pool(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    """Max pooling (VGG's ``nn.MaxPool2d(2, 2)``) on NHWC, no padding."""
    out = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return out.permute(0, 2, 3, 1).contiguous()


def instance_norm_stats(
    x: torch.Tensor, eps: float = 1e-5, one_pass: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(sample, channel) ``(mean, rsqrt(var + eps))``, shaped [B, 1, 1, C].

    ``one_pass=True`` takes E[x^2] - E[x]^2 from f32 sums, clamped at 0 so
    cancellation never gives a NaN; ``one_pass=False`` is the exact centered
    two-pass variance."""
    x32 = x.float()
    n = x.shape[1] * x.shape[2]
    if one_pass:
        s = x32.sum(dim=(1, 2), keepdim=True)
        sq = (x32 * x32).sum(dim=(1, 2), keepdim=True)
        mean = s / n
        var = torch.clamp(sq / n - mean * mean, min=0.0)
    else:
        mean = x32.mean(dim=(1, 2), keepdim=True)
        var = (x32 - mean).square().mean(dim=(1, 2), keepdim=True)
    return mean, torch.rsqrt(var + eps)


def instance_norm_stats_phased(
    x: torch.Tensor, phases: int = 4, eps: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Instance-norm stats of a phase-form tensor [B, h, w, phases*C]
    (channel order (phase, c)), pooled over space and phases: exactly the
    stats of the depth_to_space-reassembled tensor. Returns [B, C] arrays
    (one-pass, clamped)."""
    x32 = x.float()
    b, h, w, c4 = x.shape
    c = c4 // phases
    n = h * w * phases
    s = x32.sum(dim=(1, 2)).reshape(b, phases, c).sum(dim=1)
    sq = (x32 * x32).sum(dim=(1, 2)).reshape(b, phases, c).sum(dim=1)
    mean = s / n
    var = torch.clamp(sq / n - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + eps)


def instance_norm_affine(
    s: torch.Tensor,
    mean: torch.Tensor,
    inv: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    relu: bool = False,
) -> torch.Tensor:
    """Apply the IN affine given precomputed stats (+ReLU), forward only.

    ``s`` may be a padded view of the tensor the stats came from: the
    normalization is pointwise, so it commutes with padding."""
    out = (s.float() - mean) * inv * scale + bias
    if relu:
        out = torch.relu(out)
    return out.to(s.dtype)


def space_to_depth(x: torch.Tensor, block: int = 4) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/b, W/b, b*b*C] (phase-major channel order)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // block, w // block, block * block * c)


def depth_to_space(y: torch.Tensor, block: int = 4) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    b, h, w, cbb = y.shape
    c = cbb // (block * block)
    y = y.reshape(b, h, w, block, block, c)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(b, h * block, w * block, c)


def phase_conv_kernel(kernel: torch.Tensor, block: int = 4) -> torch.Tensor:
    """Rearrange a [K, K, C, O] stride-1 kernel into its space-to-depth phase
    form [K', K', block^2*C, block^2*O], K' = 2*(K//2)//block + 1.

    A conv of the space-to-depth input with this kernel is the original
    conv, regrouped (out[bY+py, bX+px, o] = sum x[bY+py+dy-r, bX+px+dx-r, c]
    * K[dy, dx, c, o], r = K//2, with source row b(Y+sy)+qy, so
    dy = b*sy + qy - py + r). The kernel is a pure gather of the weights,
    with zeros where a phase's tap falls outside the window."""
    k, _, c, o = kernel.shape
    r = k // 2
    if r % block:
        raise ValueError(
            f"phase_conv_kernel requires block ({block}) to divide "
            f"kernel_size//2 ({r}); got a {k}x{k} kernel"
        )
    ks = 2 * (r // block) + 1
    dy, dx = _phase_index(k, block, kernel.device)
    kpad = F.pad(kernel, (0, 0, 0, 0, 0, 1, 0, 1))  # row/col k = zeros
    g = kpad[dy, dx]
    bb = block * block
    return g.permute(0, 1, 2, 3, 6, 4, 5, 7).reshape(ks, ks, bb * c, bb * o)


# Constant index and weight tensors of the phase forms, by their arguments
# and device, made once: a copy from the host at every forward would also
# stop the forward from being captured in a CUDA graph.
_CONSTANTS: Dict[tuple, Tuple[torch.Tensor, ...]] = {}


def _phase_index(k: int, block: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (dy, dx) gather indices of :func:`phase_conv_kernel`."""
    key = ("phase", k, block, torch.device(device))
    if key not in _CONSTANTS:
        r = k // 2
        span = r // block
        ks = 2 * span + 1
        dy = np.zeros((ks, ks, block, block, block, block), np.int64)
        dx = np.zeros_like(dy)
        for syi, sy in enumerate(range(-span, span + 1)):
            for sxi, sx in enumerate(range(-span, span + 1)):
                for qy in range(block):
                    for qx in range(block):
                        for py in range(block):
                            for px in range(block):
                                y_ = block * sy + qy - py + r
                                x_ = block * sx + qx - px + r
                                dy[syi, sxi, qy, qx, py, px] = y_ if 0 <= y_ < k else k
                                dx[syi, sxi, qy, qx, py, px] = x_ if 0 <= x_ < k else k
        _CONSTANTS[key] = (torch.from_numpy(dy).to(device), torch.from_numpy(dx).to(device))
    return _CONSTANTS[key]


# _UP_COMBOS[p][t][d] == 1 iff original tap d contributes to phase p's 2-tap
# kernel position t: with u = upsample2(s),
#   out[2Y+0] = K0*s[Y-1] + (K1+K2)*s[Y]
#   out[2Y+1] = (K0+K1)*s[Y] + K2*s[Y+1]
_UP_COMBOS = np.array([[[1, 0, 0], [0, 1, 1]], [[1, 1, 0], [0, 0, 1]]], np.float32)


def upsample_phase_taps(kernel: torch.Tensor) -> torch.Tensor:
    """The 2x2 taps of each phase of ``nearest-upsample x2 -> reflect-pad 1
    -> conv3x3`` with a [3, 3, C, O] kernel: [2(py), 2(px), 2(ty), 2(tx), C, O],
    contiguous. Output pixel (2Y+py, 2X+px) is the sum over (ty, tx) of
    ``edge_pad(s, 1)[Y+py+ty, X+px+tx] @ taps[py, px, ty, tx]``."""
    k, k2, _, _ = kernel.shape
    if (k, k2) != (3, 3):
        raise ValueError(f"the upsample phase form is for 3x3 kernels, got {k}x{k2}")
    key = ("up", kernel.dtype, kernel.device)
    if key not in _CONSTANTS:
        _CONSTANTS[key] = (torch.as_tensor(_UP_COMBOS, dtype=kernel.dtype,
                                           device=kernel.device),)
    (m,) = _CONSTANTS[key]
    return torch.einsum("ptd,qse,deco->pqtsco", m, m, kernel).contiguous()


def phase_taps_kernel(taps: torch.Tensor) -> torch.Tensor:
    """The [3, 3, C, 4*O] phase kernel (output channel order (py, px, o)) of
    :func:`upsample_phase_taps`' taps: each phase's 2x2 support at offset
    (py, px) of the 3x3 kernel, zeros elsewhere."""
    c, o = taps.shape[4:]
    blocks = []
    for py in range(2):
        row = [F.pad(taps[py, px], (0, 0, 0, 0, px, 1 - px, py, 1 - py)) for px in range(2)]
        blocks.append(torch.stack(row, dim=3))  # [3, 3, C, 2(px), O]
    return torch.stack(blocks, dim=3).reshape(3, 3, c, 4 * o)  # [3,3,C,2(py),2(px),O]


def upsample_phase_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """Rearrange a [3, 3, C, O] kernel so that one VALID conv on the SMALL
    grid computes ``nearest-upsample x2 -> reflect-pad 1 -> conv3x3`` in 2x2
    space-to-depth phase form (output channel order (py, px, o)).

    ``conv(edge_pad(s, 1), upsample_phase_kernel(K))`` equals
    ``space_to_depth(conv3x3(reflect_pad(upsample2(s), 1), K), 2)``. Each
    phase's 2x2 support sits at offset (py, px) in the 3x3 kernel."""
    return phase_taps_kernel(upsample_phase_taps(kernel))


def init_conv(
    generator: torch.Generator,
    kh: int,
    kw: int,
    cin: int,
    cout: int,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform fan-in init matching torch ``nn.Conv2d`` defaults: kernel
    (HWIO) and bias ~ U(-b, b), b = 1/sqrt(kh*kw*cin)."""
    bound = 1.0 / float(np.sqrt(kh * kw * cin))
    kernel = torch.empty((kh, kw, cin, cout), dtype=dtype)
    kernel.uniform_(-bound, bound, generator=generator)
    bias = torch.empty((cout,), dtype=dtype)
    bias.uniform_(-bound, bound, generator=generator)
    return kernel.to(device), bias.to(device)


def init_instance_norm(c: int, dtype: torch.dtype = torch.float32, device=None):
    """torch ``nn.InstanceNorm2d(affine=True)`` init: scale=1, bias=0."""
    return torch.ones((c,), dtype=dtype, device=device), torch.zeros(
        (c,), dtype=dtype, device=device
    )
