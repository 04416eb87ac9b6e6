"""3x3 VALID conv + bias (+ReLU) with per-image instance-norm sums.

The port of ``styletransfer_tpu/ops/pallas/conv3x3.py::conv3x3_valid``. The
kernel is ``csrc/conv3x3.cu``, whose header says what bounds it on the card
and how it is built. :func:`conv3x3_valid` launches it on CUDA tensors and
computes :func:`conv3x3_valid_plain`, the same function in plain PyTorch, on
CPU tensors. ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from styletransfer_tpu_torch.ops.cuda import _build, check_cuda_inputs

# Kernel launches since the counter was last set to 0.
launches = 0

_DTYPES = (torch.float32, torch.bfloat16)


def conv3x3_valid_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: f32 conv of the (f32-exact) inputs, + bias,
    ReLU, the sums of the f32 result, then the cast to ``x.dtype``."""
    acc = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1))
    acc = acc.permute(0, 2, 3, 1) + b.float()
    if relu:
        acc = torch.relu(acc)
    return acc.to(x.dtype), acc.sum(dim=(1, 2)), (acc * acc).sum(dim=(1, 2))


def _check(x, w, b) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H+2, W+2, C], got shape {tuple(x.shape)}")
    B, Hp, Wp, C = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, C):
        raise ValueError(f"w must be [3, 3, {C}, O], got {tuple(w.shape)}")
    O = w.shape[3]
    if w.dtype != x.dtype:
        raise TypeError(f"w must have x's dtype {x.dtype}, got {w.dtype}")
    if tuple(b.shape) != (O,) or b.dtype != torch.float32:
        raise ValueError(f"b must be float32 [{O}], got {b.dtype} {tuple(b.shape)}")
    if Hp < 3 or Wp < 3:
        raise ValueError(f"x is too small for a 3x3 VALID conv: {tuple(x.shape)}")
    if C % 32 or O % 8:
        raise ValueError(f"the kernel needs C % 32 == 0 and O % 8 == 0, got C={C}, O={O}")


def conv3x3_valid(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """VALID 3x3 conv + bias (+ReLU) of a pre-padded NHWC input.

    ``x`` [B, H+2, W+2, C] f32 or bf16, ``w`` [3, 3, C, O] in ``x``'s dtype,
    ``b`` [O] f32. Returns ``(out [B, H, W, O] in x.dtype, sums [B, O],
    sumsqs [B, O])``, the sums of the post-activation f32 result.
    """
    _check(x, w, b)
    if x.device.type == "cpu":
        return conv3x3_valid_plain(x, w, b, relu)
    check_cuda_inputs(x, w, b)
    global launches
    lib = _library()
    B, Hp, Wp, C = x.shape
    O = w.shape[3]
    H, W = Hp - 2, Wp - 2
    tiles = -(-(H * W) // lib.stx_conv3x3_block_m())
    out = torch.empty((B, H, W, O), dtype=x.dtype, device=x.device)
    partials = torch.empty((2, B, tiles, O), dtype=torch.float32, device=x.device)
    sums = torch.empty((2, B, O), dtype=torch.float32, device=x.device)
    fn = lib.stx_conv3x3_f32 if x.dtype == torch.float32 else lib.stx_conv3x3_bf16
    with torch.cuda.device(x.device):  # the library launches on the current device
        err = fn(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
            partials[0].data_ptr(), partials[1].data_ptr(),
            sums[0].data_ptr(), sums[1].data_ptr(),
            B, Hp, Wp, C, O, int(relu), torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"conv3x3 kernel launch failed: {lib.stx_conv3x3_error_string(err).decode()}"
        )
    launches += 1
    return out, sums[0], sums[1]


def _library() -> ctypes.CDLL:
    lib = _build.library("conv3x3")
    if not getattr(lib, "_stx_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.stx_conv3x3_f32, lib.stx_conv3x3_bf16):
            fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
            fn.restype = i
        lib.stx_conv3x3_block_m.argtypes = []
        lib.stx_conv3x3_block_m.restype = i
        lib.stx_conv3x3_error_string.argtypes = [i]
        lib.stx_conv3x3_error_string.restype = ctypes.c_char_p
        lib._stx_typed = True
    return lib
