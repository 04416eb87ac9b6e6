"""The transform net's last conv, ``conv_out`` (9x9, 32 -> 3), as one direct
9x9 VALID conv in f32, and its input gradient as the same kernel at 3 -> 32.

Not the port of a TPU kernel: the JAX package leaves ``conv_out`` to XLA (a
3x3 512 -> 48 conv of the 4x4 space-to-depth input when serving, a 9x9 conv
of the padded input when training) and its gradients to XLA's autodiff.
``csrc/conv9x9.cu`` multiplies the 7,776 products of each output pixel and
no zero tap, reads the padded input where it lies and adds the bias in its
epilogue; its header says what bounds it on the card.

:func:`conv9x9_valid` launches the kernel on CUDA tensors and computes
:func:`conv9x9_plain` on CPU tensors. :class:`Conv9x9Function` is the
differentiable conv: its forward is the (32, 3) kernel, its input gradient
the (3, 32) kernel on ``dy`` zero-padded by 8 with the kernel turned 180
degrees and its channels swapped (:func:`rotated`), its weight gradient
cuDNN's and its bias gradient ``dy``'s sum; on CPU tensors it computes the
same formulas with the plain conv. ``launches`` counts the kernel's
launches: one per f32 serving forward of the transform net
(``models/transformer.py::apply``), two per f32 training step (the forward
and the input gradient, ``apply_stacked``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from styletransfer_tpu_torch.ops import layers
from styletransfer_tpu_torch.ops.cuda import _build, check_cuda_inputs

# Kernel launches since the counter was last set to 0.
launches = 0

# The (C, O) pairs the kernel is built for: conv_out's forward and its input
# gradient.
PAIRS = ((32, 3), (3, 32))
KSIZE = 9
# The pixels a block owns, (rows, columns), by (C, O, RUN): RUN pixels of a
# row a thread. The forward takes RUN = 16 (one block an SM) where that fills
# WAVES waves of the card, else RUN = 8; the input gradient RUN = 8.
TILES = {(32, 3, 16): (32, 128), (32, 3, 8): (32, 32), (3, 32, 8): (16, 32)}
WAVES = 4


def conv9x9_plain(xp: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: ``layers.conv2d`` VALID (cuDNN on the card)."""
    return layers.conv2d(xp, w, bias)


def rotated(w: torch.Tensor) -> torch.Tensor:
    """The kernel of the input gradient: ``w`` [9, 9, C, O] turned 180
    degrees with its channels swapped, [9, 9, O, C]."""
    return w.flip((0, 1)).transpose(2, 3).contiguous()


def plan(B: int, H: int, W: int, C: int, O: int, sms: int = 132) -> dict:
    """The tile of a call at output [B, H, W, O]: the pixels a thread owns
    (``run``), the block's rows and columns and the number of blocks. It
    depends on the shape alone (and the card's SM count), never on the
    data; every output sums in the same order at every tile."""
    def blocks(run):
        rows, cols = TILES[(C, O, run)]
        return B * -(-H // rows) * -(-W // cols)

    run = 16 if (C, O) == (32, 3) and blocks(16) >= WAVES * sms else 8
    return {"run": run, "tile": TILES[(C, O, run)], "blocks": blocks(run)}


def _check(xp, w, bias) -> None:
    if xp.dim() != 4 or xp.shape[1] < KSIZE or xp.shape[2] < KSIZE:
        raise ValueError(f"xp must be [B, H+8, W+8, C] with H, W >= 1, got {tuple(xp.shape)}")
    C = xp.shape[3]
    if w.dim() != 4 or tuple(w.shape[:3]) != (KSIZE, KSIZE, C) or (C, w.shape[3]) not in PAIRS:
        raise ValueError(f"w must be [9, 9, C, O] with (C, O) in {PAIRS} and C that of xp, "
                         f"got {tuple(w.shape)} for xp {tuple(xp.shape)}")
    O = w.shape[3]
    if bias is not None and tuple(bias.shape) != (O,):
        raise ValueError(f"bias must be [{O}], got {tuple(bias.shape)}")
    allowed = (torch.float32,) if xp.device.type == "cuda" else (torch.float32, torch.float64)
    for name, t in (("xp", xp), ("w", w), ("bias", bias)):
        if t is not None and (t.dtype not in allowed or t.dtype != xp.dtype):
            raise TypeError(f"{name} must be float32 (float64 too on the CPU, all alike), "
                            f"got {t.dtype}")


def conv9x9_valid(xp: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``xp`` [B, H+8, W+8, C], ``w`` [9, 9, C, O] (HWIO), ``bias`` [O] or
    None -> [B, H, W, O]: the VALID 9x9 conv + bias. (C, O) is (32, 3) or
    (3, 32); f32 (the plain version on the CPU takes f64 too). Forward
    only: :class:`Conv9x9Function` is the differentiable one."""
    _check(xp, w, bias)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (xp, w, bias)):
        raise NotImplementedError("conv9x9_valid has no backward; call Conv9x9Function")
    if xp.device.type == "cpu":
        return conv9x9_plain(xp, w, bias)
    global launches
    tensors = (xp, w) if bias is None else (xp, w, bias)
    check_cuda_inputs(*tensors)
    B, Hp, Wp, C = xp.shape
    O = w.shape[3]
    H, W = Hp - KSIZE + 1, Wp - KSIZE + 1
    run = plan(B, H, W, C, O, _sm_count(xp.device))["run"]
    out = torch.empty((B, H, W, O), dtype=xp.dtype, device=xp.device)
    lib = _library()
    with torch.cuda.device(xp.device):  # the library launches on the current device
        err = lib.stx_conv9x9_f32(xp.data_ptr(), w.data_ptr(),
                                  None if bias is None else bias.data_ptr(), out.data_ptr(),
                                  B, Hp, Wp, C, O, run,
                                  torch.cuda.current_stream(xp.device).cuda_stream)
    if err:
        raise RuntimeError(f"conv9x9 kernel launch failed for xp {tuple(xp.shape)} -> {O}: "
                           f"{lib.stx_conv9x9_error_string(err).decode()}")
    launches += 1
    return out


def _weight_grad(xp: torch.Tensor, dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """cuDNN's weight gradient of the VALID conv (HWIO), on the layouts
    ``layers.conv2d`` hands it."""
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    _, dw, _ = torch.ops.aten.convolution_backward(
        dy.permute(0, 3, 1, 2), xp.permute(0, 3, 1, 2), wc, None, [1, 1], [0, 0], [1, 1],
        False, [0, 0], 1, [False, True, False])
    return dw.permute(2, 3, 1, 0)


class Conv9x9Function(torch.autograd.Function):
    """The differentiable VALID 9x9 conv of :func:`conv9x9_valid`, (C, O) =
    (32, 3): ``Conv9x9Function.apply(xp, w, bias)``."""

    @staticmethod
    def forward(ctx, xp, w, bias):
        xp = xp.contiguous()
        ctx.save_for_backward(xp, w)
        return conv9x9_valid(xp, w, bias)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        xp, w = ctx.saved_tensors
        dy = dy.contiguous()
        dxp = dw = db = None
        if ctx.needs_input_grad[0]:
            dxp = conv9x9_valid(layers.zero_pad(dy, KSIZE - 1), rotated(w))
        if ctx.needs_input_grad[1]:
            dw = _weight_grad(xp, dy, w)
        if ctx.needs_input_grad[2]:
            db = dy.sum((0, 1, 2))
        return dxp, dw, db


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.library("conv9x9")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.stx_conv9x9_f32.argtypes = [p] * 4 + [i] * 6 + [p]
    lib.stx_conv9x9_f32.restype = i
    lib.stx_conv9x9_error_string.argtypes = [i]
    lib.stx_conv9x9_error_string.restype = ctypes.c_char_p
    return lib
