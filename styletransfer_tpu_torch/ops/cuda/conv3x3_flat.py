"""3x3 VALID conv + bias (+ReLU) with no statistics, and the zero-padded
3x3 conv (with its input gradient) that the VGG tower runs on it.

The port of ``styletransfer_tpu/ops/pallas/conv3x3.py::conv3x3_flat``
(``_flat_kernel``) and ``::conv3x3_im2col`` (``_im2col_kernel``): the same
function in two forms, ``x [B, H+2, W+2, C]`` (pre-padded NHWC, f32 or bf16),
``w [3, 3, C, O]`` in x's dtype and ``b [O]`` f32 give ``[B, H, W, O]`` in
x's dtype. The sums run in f32 and the bias is added in f32 before the one
rounding (the JAX kernels add it in the output dtype: a deliberate difference
in bf16).

- :func:`conv3x3_flat` launches ``csrc/conv3x3_flat.cu`` (per-tap products
  on a shared-memory span of shifted input rows);
- :func:`conv3x3_im2col` launches ``csrc/conv3x3_im2col.cu`` (one product of
  depth 9C on an im2col operand staged in shared memory);
- :func:`conv3x3_same` is the zero-padded stride-1 conv of VGG
  (:class:`Conv3x3Same`, a ``torch.autograd.Function``) whose input
  gradient is the same function
  again: the zero-padded output gradient convolved with the kernel flipped in
  space and its channels transposed. Both directions take ``conv3x3_im2col``
  below :data:`IM2COL_BELOW_C` input channels and ``conv3x3_flat`` otherwise.

The kernels' source headers say what bounds them on the card. On CUDA
tensors the wrappers launch the kernels or raise; on CPU tensors they compute
the plain versions beside them (:func:`conv3x3_flat_plain`,
:func:`conv3x3_im2col_plain`). ``flat_launches`` and ``im2col_launches``
count the kernels' launches.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from styletransfer_tpu_torch.ops.cuda import _build, check_cuda_inputs

# Kernel launches since the counters were last set to 0.
flat_launches = 0
im2col_launches = 0

# conv3x3_same's routing rule: below this many input channels a per-tap
# product is too shallow to feed the multiply units, and the conv runs as one
# product of depth 9C (conv3x3_im2col); from it on, conv3x3_flat.
IM2COL_BELOW_C = 32

_DTYPES = (torch.float32, torch.bfloat16)


def conv3x3_flat_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = False
) -> torch.Tensor:
    """Plain PyTorch version: an f32 VALID conv of the (f32-exact) inputs,
    + bias in f32, ReLU, then one cast to ``x.dtype``."""
    acc = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1))
    acc = acc.permute(0, 2, 3, 1) + b.float()
    if relu:
        acc = torch.relu(acc)
    return acc.to(x.dtype).contiguous()


def conv3x3_im2col_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = False
) -> torch.Tensor:
    """Plain PyTorch version as one product: the [B*H*W, 9C] im2col operand
    (column ``(dy*3 + dx)*C + c``) times ``w`` reshaped to [9C, O], in f32,
    + bias, ReLU, then one cast to ``x.dtype``."""
    B, Hp, Wp, C = x.shape
    H, W, O = Hp - 2, Wp - 2, w.shape[3]
    xf = x.float()
    cols = torch.cat([xf[:, dy:dy + H, dx:dx + W, :] for dy in range(3) for dx in range(3)],
                     dim=-1)
    acc = cols.reshape(B * H * W, 9 * C) @ w.float().reshape(9 * C, O) + b.float()
    if relu:
        acc = torch.relu(acc)
    return acc.reshape(B, H, W, O).to(x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H+2, W+2, C], got shape {tuple(x.shape)}")
    _, Hp, Wp, C = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, C):
        raise ValueError(f"w must be [3, 3, {C}, O], got {tuple(w.shape)}")
    O = w.shape[3]
    if w.dtype != x.dtype:
        raise TypeError(f"w must have x's dtype {x.dtype}, got {w.dtype}")
    if tuple(b.shape) != (O,) or b.dtype != torch.float32:
        raise ValueError(f"b must be float32 [{O}], got {b.dtype} {tuple(b.shape)}")
    if Hp < 3 or Wp < 3 or C < 1 or O < 1:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} give an empty 3x3 conv")


def conv3x3_flat(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = False
) -> torch.Tensor:
    """VALID 3x3 conv + bias (+ReLU) of a pre-padded NHWC input, the
    shift-slice kernel: ``x`` [B, H+2, W+2, C] f32 or bf16, ``w`` [3, 3, C, O]
    in x's dtype, ``b`` [O] f32; returns [B, H, W, O] in x's dtype."""
    global flat_launches
    _check(x, w, b)
    if x.device.type == "cpu":
        return conv3x3_flat_plain(x, w, b, relu)
    out = _launch("flat", x, w, b, relu)
    flat_launches += 1
    return out


def conv3x3_im2col(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = False
) -> torch.Tensor:
    """The same function as :func:`conv3x3_flat`, on the im2col kernel (one
    product of depth 9C)."""
    global im2col_launches
    _check(x, w, b)
    if x.device.type == "cpu":
        return conv3x3_im2col_plain(x, w, b, relu)
    out = _launch("im2col", x, w, b, relu)
    im2col_launches += 1
    return out


def uses_im2col(channels: int) -> bool:
    """Whether :func:`conv3x3_same` runs a conv of ``channels`` input
    channels on ``conv3x3_im2col`` (else ``conv3x3_flat``)."""
    return channels < IM2COL_BELOW_C


def _conv_valid(xp: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    fn = conv3x3_im2col if uses_im2col(xp.shape[-1]) else conv3x3_flat
    return fn(xp, w, b)


def _zero_pad(t: torch.Tensor) -> torch.Tensor:
    return F.pad(t, (0, 0, 1, 1, 1, 1)).contiguous()


class Conv3x3Same(torch.autograd.Function):
    """Zero-pad by 1, then the VALID conv; the backward gives the input
    gradient only (the kernel flipped in space, its channels transposed, on
    the zero-padded output gradient)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(w)
        return _conv_valid(_zero_pad(x), w, b)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        wt = w.flip(0, 1).transpose(2, 3).contiguous()
        zero_bias = torch.zeros(wt.shape[3], dtype=torch.float32, device=g.device)
        return _conv_valid(_zero_pad(g), wt, zero_bias), None, None


def conv3x3_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 conv with zero padding 1 (VGG's), differentiable in ``x``.

    ``x`` [B, H, W, C] f32 or bf16, ``w`` [3, 3, C, O] in x's dtype, ``b``
    [O] f32; returns [B, H, W, O] in x's dtype. Raises NotImplementedError if
    ``w`` or ``b`` would need a gradient: there is no weight-gradient kernel
    (the VGG weights are frozen wherever the port runs them)."""
    if torch.is_grad_enabled() and (w.requires_grad or b.requires_grad):
        raise NotImplementedError(
            "conv3x3_same computes the input gradient only; its weights and bias "
            "must not require a gradient")
    return Conv3x3Same.apply(x, w, b)


_FUNCTIONS: Dict[str, Tuple[Callable, Callable]] = {}


def _function(kind: str, dtype: torch.dtype) -> Tuple[Callable, Callable]:
    """The typed C entry point of one kernel and dtype, and its library's
    error-string function."""
    key = f"stx_conv3x3_{kind}_{'f32' if dtype == torch.float32 else 'bf16'}"
    if key not in _FUNCTIONS:
        lib = _build.library(f"conv3x3_{kind}")
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = getattr(lib, key)
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = i
        err_string = getattr(lib, f"stx_conv3x3_{kind}_error_string")
        err_string.argtypes = [i]
        err_string.restype = ctypes.c_char_p
        _FUNCTIONS[key] = (fn, err_string)
    return _FUNCTIONS[key]


def _launch(kind: str, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            relu: bool) -> torch.Tensor:
    check_cuda_inputs(x, w, b)
    fn, err_string = _function(kind, x.dtype)
    B, Hp, Wp, C = x.shape
    O = w.shape[3]
    out = torch.empty((B, Hp - 2, Wp - 2, O), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):  # the library launches on the current device
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), B, Hp, Wp, C, O,
                 int(relu), torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"conv3x3_{kind} kernel launch failed: {err_string(err).decode()}")
    return out
