"""Direct VALID conv + bias of a pre-padded NHWC input, summed in one fixed
order, so that an image's result does not depend on the batch.

Not the port of a TPU kernel: the convs of the transform net that the JAX
package leaves to XLA (the 9x9 conv1, the stride-2 conv2 and conv3, the
phase-form upsample convs, the space-to-depth conv_out, and in the stacked
forward the 9x9 and upsampled 3x3 convs) run as ``F.conv2d`` in the port,
and cuDNN sums in an order that depends on the call's batch size.
``models/transformer.py`` sends them here with ``fixed_order=True`` (the
video stylizer): ``csrc/conv_direct.cu``, whose header gives the order
((ky, kx, c) ascending, one f32 accumulator per output) and what bounds it.

:func:`conv_direct` launches the kernel on CUDA tensors on the tile that
:func:`direct_plan` names (a function of O alone) and computes
:func:`conv_direct_plain`, the same function in plain PyTorch, image by
image, on CPU tensors. ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from styletransfer_tpu_torch.ops.cuda import _build, check_cuda_inputs

# Kernel launches since the counter was last set to 0.
launches = 0

_DTYPES = (torch.float32, torch.bfloat16)
# Threads per block, and the tiles the kernel builds: (output channels,
# pixels per thread), each thread holding 4 channels; a block is
# 256 / (channels / 4) * pixels output pixels.
THREADS = 256
TILES = ((64, 8), (32, 4), (16, 2), (8, 1), (4, 1))


class DirectPlan(NamedTuple):
    """The tile of conv_direct for one shape: ``to`` output channels by
    ``tp`` output pixels of one image, and the blocks of the grid."""
    to: int
    tp: int
    blocks: int

    def __str__(self) -> str:
        return f"{self.tp}x{self.to} tiles ({self.blocks} blocks)"


@functools.lru_cache(maxsize=1024)  # a pure function, called on every launch
def direct_plan(B: int, Ho: int, Wo: int, O: int) -> DirectPlan:
    """The tile and grid of conv_direct for B images of ``Ho x Wo`` outputs
    of O channels. The tile is the widest of :data:`TILES` whose channel
    count divides O (else the narrowest that covers min(O, 64)): a function
    of O alone, so that how an image is cut into tiles never depends on B,
    which only multiplies the blocks."""
    to = next((t for t, _ in TILES if O % t == 0),
              min(t for t, _ in TILES if t >= min(O, TILES[0][0])))
    pm = dict(TILES)[to]
    tp = THREADS // (to // 4) * pm
    return DirectPlan(to, tp, B * -(-Ho * Wo // tp) * -(-O // to))


def conv_direct_plain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                      stride: int = 1) -> torch.Tensor:
    """Plain PyTorch version, one image at a time (so that on the CPU too an
    image's result does not depend on the batch): an f32 VALID conv of the
    (f32-exact) inputs, + bias in f32, then one cast to ``x.dtype``."""
    wc = w.float().permute(3, 2, 0, 1)
    outs = []
    for i in range(x.shape[0]):
        acc = F.conv2d(x[i:i + 1].float().permute(0, 3, 1, 2), wc, stride=stride)
        acc = acc.permute(0, 2, 3, 1)
        if b is not None:
            acc = acc + b.float()
        outs.append(acc.to(x.dtype))
    return torch.cat(outs).contiguous()


def _check(x, w, b, stride) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be [B, Hp, Wp, C], got shape {tuple(x.shape)}")
    B, Hp, Wp, C = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w.dim() != 4 or w.shape[0] != w.shape[1] or w.shape[2] != C:
        raise ValueError(f"w must be [K, K, {C}, O], got {tuple(w.shape)}")
    K, O = w.shape[0], w.shape[3]
    if w.dtype != x.dtype:
        raise TypeError(f"w must have x's dtype {x.dtype}, got {w.dtype}")
    if b is not None and (tuple(b.shape) != (O,) or b.dtype != torch.float32):
        raise ValueError(f"b must be float32 [{O}] or None, got {b.dtype} {tuple(b.shape)}")
    if stride < 1 or Hp < K or Wp < K or B < 1 or O < 1:
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)} and stride {stride} give an "
                         "empty conv")


def conv_direct(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                stride: int = 1) -> torch.Tensor:
    """VALID conv of a pre-padded NHWC input, + bias: ``x`` [B, Hp, Wp, C]
    f32 or bf16, ``w`` [K, K, C, O] in x's dtype, ``b`` [O] f32 or None;
    returns [B, Ho, Wo, O] in x's dtype, ``Ho = (Hp - K) // stride + 1``.
    Forward only: raises NotImplementedError where autograd would want a
    gradient through it."""
    _check(x, w, b, stride)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, w, b)):
        raise NotImplementedError("conv_direct has no backward; call it without gradients")
    if x.device.type == "cpu":
        return conv_direct_plain(x, w, b, stride)
    global launches
    check_cuda_inputs(x, w, *([] if b is None else [b]))
    B, Hp, Wp, C = x.shape
    K, O = w.shape[0], w.shape[3]
    Ho, Wo = (Hp - K) // stride + 1, (Wp - K) // stride + 1
    plan = direct_plan(B, Ho, Wo, O)
    out = torch.empty((B, Ho, Wo, O), dtype=x.dtype, device=x.device)
    lib = _library()
    fn = lib.stx_conv_direct_f32 if x.dtype == torch.float32 else lib.stx_conv_direct_bf16
    with torch.cuda.device(x.device):  # the library launches on the current device
        err = fn(x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
                 out.data_ptr(), B, Hp, Wp, C, O, K, stride, plan.to,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"conv_direct kernel ({plan}) launch failed: "
                           f"{lib.stx_conv_direct_error_string(err).decode()}")
    launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.library("conv_direct")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.stx_conv_direct_f32, lib.stx_conv_direct_bf16):
        fn.argtypes = [p] * 4 + [i] * 8 + [p]
        fn.restype = i
    lib.stx_conv_direct_error_string.argtypes = [i]
    lib.stx_conv_direct_error_string.restype = ctypes.c_char_p
    return lib
