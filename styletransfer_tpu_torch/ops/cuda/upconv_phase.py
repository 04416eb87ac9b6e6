"""The decoder's upsample conv in phase form: ``nearest-upsample x2 ->
reflect-pad 1 -> conv3x3 + bias`` of the small grid, edge-padded by 1.

Not the port of a TPU kernel: the JAX package leaves these convs to XLA as
one 3x3 VALID conv of the phase kernel (``ops/layers.py::
upsample_phase_kernel``) and a ``depth_to_space``. ``csrc/upconv_phase.cu``
multiplies only each phase's 2x2 taps (``ops/layers.py::
upsample_phase_taps``, 4/9 of that conv's products) and adds the bias and
writes the reassembled [B, 2h, 2w, O] tensor in its epilogue, with the
ReLU where asked; its header says what bounds it on the card.

:func:`upconv_phase` launches the kernel on CUDA tensors and computes
:func:`upconv_phase_plain` on CPU tensors. ``launches`` counts the kernel's
launches: two per f32 serving forward of the transform net
(``models/transformer.py::apply``), three per AdaIN forward
(``models/adain.py::apply``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from styletransfer_tpu_torch.ops import layers
from styletransfer_tpu_torch.ops.cuda import _build, check_cuda_inputs

# Kernel launches since the counter was last set to 0.
launches = 0

# The kernel's input channels per chunk, and the output channels it is built
# for (up to 64 in one block, wider ones split over blocks of 64); the
# wrapper takes the input channels of the transform net's two convs (128 ->
# 64, 64 -> 32) and of AdaIN's decoder's three (256, 128 and 64, each to as
# many).
CHUNK = 8
OUT_CHANNELS = (32, 64, 128, 256)
IN_CHANNELS = (64, 128, 256)


def upconv_phase_plain(y: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor,
                       relu: bool = False) -> torch.Tensor:
    """Plain PyTorch version: one VALID conv of the 3x3 phase kernel on the
    small grid, + the bias of each phase, then ``depth_to_space`` (the JAX
    package's arithmetic, cuDNN's on the card), then the ReLU."""
    kp = layers.phase_taps_kernel(taps)
    out = layers.depth_to_space(layers.conv2d(y, kp, bias.repeat(4)), 2)
    return torch.relu(out) if relu else out


def _check(y, taps, bias) -> None:
    if y.dim() != 4 or y.shape[1] < 3 or y.shape[2] < 3:
        raise ValueError(f"y must be [B, h+2, w+2, C] with h, w >= 1, got {tuple(y.shape)}")
    C = y.shape[3]
    if C not in IN_CHANNELS:
        raise ValueError(f"y must have C in {IN_CHANNELS}, got {C}")
    if taps.dim() != 6 or tuple(taps.shape[:5]) != (2, 2, 2, 2, C) \
            or taps.shape[5] not in OUT_CHANNELS:
        raise ValueError(f"taps must be [2, 2, 2, 2, {C}, O] with O in {OUT_CHANNELS}, got "
                         f"{tuple(taps.shape)}")
    O = taps.shape[5]
    if tuple(bias.shape) != (O,):
        raise ValueError(f"bias must be [{O}], got {tuple(bias.shape)}")
    for name, t in (("y", y), ("taps", taps), ("bias", bias)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def upconv_phase(y: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor,
                 relu: bool = False) -> torch.Tensor:
    """``y`` [B, h+2, w+2, C] f32 (the small grid edge-padded by 1), ``taps``
    [2, 2, 2, 2, C, O] f32 (:func:`layers.upsample_phase_taps`), ``bias`` [O]
    f32 -> [B, 2h, 2w, O] f32: ``conv3x3(reflect_pad(upsample2(s), 1)) +
    bias``, then a ReLU with ``relu``. C is 64, 128 or 256 and O 32, 64, 128
    or 256; anything else raises. Forward only."""
    _check(y, taps, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (y, taps, bias)):
        raise NotImplementedError("upconv_phase has no backward; call it without gradients")
    if y.device.type == "cpu":
        return upconv_phase_plain(y, taps, bias, relu)
    global launches
    check_cuda_inputs(y, taps, bias)
    B, Hp, Wp, C = y.shape
    O = taps.shape[5]
    out = torch.empty((B, 2 * (Hp - 2), 2 * (Wp - 2), O), dtype=y.dtype, device=y.device)
    lib = _library()
    with torch.cuda.device(y.device):  # the library launches on the current device
        err = lib.stx_upconv_phase_f32(y.data_ptr(), taps.data_ptr(), bias.data_ptr(),
                                       out.data_ptr(), B, Hp, Wp, C, O, int(relu),
                                       torch.cuda.current_stream(y.device).cuda_stream)
    if err:
        raise RuntimeError(f"upconv_phase kernel launch failed for y {tuple(y.shape)} -> {O}: "
                           f"{lib.stx_upconv_phase_error_string(err).decode()}")
    launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.library("upconv_phase")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.stx_upconv_phase_f32.argtypes = [p] * 4 + [i] * 6 + [p]
    lib.stx_upconv_phase_f32.restype = i
    lib.stx_upconv_phase_error_string.argtypes = [i]
    lib.stx_upconv_phase_error_string.restype = ctypes.c_char_p
    return lib
