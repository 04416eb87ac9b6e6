"""Instance norm (+residual) (+ReLU) that writes its output pre-padded.

The port of ``styletransfer_tpu/ops/pallas/instance_norm.py::
fused_instance_norm_padded``, with the two things the pad-early forward
(``_in_pad`` in ``styletransfer_tpu/models/transformer.py``) adds: edge
padding and statistics handed in by the conv3x3 kernel. The kernel is
``csrc/instance_norm.cu``, whose header says what bounds it on the card.
:func:`instance_norm_pad` launches it on CUDA tensors and computes
:func:`instance_norm_pad_plain` on CPU tensors. ``launches`` counts the
kernel's launches by this wrapper; :func:`launch` is shared with the
training forward (``fused_instance_norm.py``), which counts its own.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from styletransfer_tpu_torch.ops import layers
from styletransfer_tpu_torch.ops.cuda import _build, check_cuda_inputs

# Kernel launches since the counter was last set to 0.
launches = 0

_DTYPES = (torch.float32, torch.bfloat16)
# Elements of x that one block of the statistics pass reduces.
_ELEMS_PER_BLOCK = 16384
EPS = 1e-5  # nn.InstanceNorm2d's


def instance_norm_pad_plain(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
    res_pad: int = 0,
    relu: bool = False,
    pad: int = 0,
    mode: str = "reflect",
    stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Plain PyTorch version: s = x + residual interior (in x's dtype), the
    statistics (exact two-pass, or one-pass clamped from ``stats``), the
    affine and ReLU in f32, the padding, then the cast to ``x.dtype``."""
    s = x
    if residual is not None:
        h, w = x.shape[1], x.shape[2]
        s = x + residual[:, res_pad:res_pad + h, res_pad:res_pad + w, :].to(x.dtype)
    if stats is None:
        mean, inv = layers.instance_norm_stats(s, EPS, one_pass=False)
    else:
        n = x.shape[1] * x.shape[2]
        mean = stats[0][:, None, None, :] / n
        var = torch.clamp(stats[1][:, None, None, :] / n - mean * mean, min=0.0)
        inv = torch.rsqrt(var + EPS)
    out = (s.float() - mean) * inv * scale + bias
    if relu:
        out = torch.relu(out)
    out = layers.edge_pad(out, pad) if mode == "edge" else layers.reflect_pad(out, pad)
    return out.to(x.dtype)


def check(x, scale, bias, residual=None, res_pad=0, pad=0, mode="reflect", stats=None) -> None:
    """Raise on what the kernel does not take (shapes, dtypes, C % 4, C <= 1024)."""
    if x.dim() != 4:
        raise ValueError(f"x must be [N, H, W, C], got shape {tuple(x.shape)}")
    N, H, W, C = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("scale", scale), ("bias", bias)):
        if tuple(t.shape) != (C,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [{C}], got {t.dtype} {tuple(t.shape)}")
    if residual is not None:
        want = (N, H + 2 * res_pad, W + 2 * res_pad, C)
        if tuple(residual.shape) != want or residual.dtype != x.dtype:
            raise ValueError(
                f"residual must be {x.dtype} {want}, got {residual.dtype} "
                f"{tuple(residual.shape)}"
            )
    if mode not in ("reflect", "edge"):
        raise ValueError(f"mode must be 'reflect' or 'edge', got {mode!r}")
    if pad < 0 or (mode == "reflect" and pad >= min(H, W)):
        raise ValueError(f"reflect padding {pad} needs H and W > {pad}, got {H}x{W}")
    if stats is not None:
        for t in stats:
            if tuple(t.shape) != (N, C) or t.dtype != torch.float32:
                raise ValueError(f"stats must be float32 [{N}, {C}], got {tuple(t.shape)}")
    if C % 4 or C > 1024:
        raise ValueError(f"the kernel needs C % 4 == 0 and C <= 1024, got C={C}")


def instance_norm_pad(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
    res_pad: int = 0,
    relu: bool = False,
    pad: int = 0,
    mode: str = "reflect",
    stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """IN(x + residual interior)(+ReLU), written padded by ``pad``.

    ``x`` [N, H, W, C] f32 or bf16; ``residual`` [N, H+2r, W+2r, C] with
    ``r = res_pad`` (its interior is added); ``scale``/``bias`` [C] f32;
    ``mode`` "reflect" or "edge"; ``stats`` = (sums, sumsqs) [N, C] f32 of
    the input, as conv3x3 emits them, or None to compute the exact centered
    variance. Returns [N, H+2p, W+2p, C] in ``x.dtype``.
    """
    check(x, scale, bias, residual, res_pad, pad, mode, stats)
    if x.device.type == "cpu":
        return instance_norm_pad_plain(x, scale, bias, residual, res_pad, relu, pad, mode, stats)
    global launches
    out, _ = launch(x, scale, bias, residual, res_pad, False, relu, pad, mode, stats)
    launches += 1
    return out


def launch(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    residual: Optional[torch.Tensor],
    res_pad: int,
    res_f32: bool,
    relu: bool,
    pad: int,
    mode: str,
    stats: Optional[Tuple[torch.Tensor, torch.Tensor]],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on checked CUDA tensors; counts nothing.

    ``res_f32`` adds the residual in f32 instead of rounding the sum to
    ``x.dtype``. Returns ``(out, mean_inv)`` with ``mean_inv`` [2, N, C] f32:
    the statistics the output was normalized with."""
    extra = [] if residual is None else [residual]
    extra += [] if stats is None else list(stats)
    check_cuda_inputs(x, scale, bias, *extra)
    lib = _library()
    N, H, W, C = x.shape
    hw = H * W
    groups = max(1, min(hw, -(-(hw * C) // _ELEMS_PER_BLOCK)))
    chunk = -(-hw // groups)
    groups = -(-hw // chunk)
    dev = x.device
    out = torch.empty((N, H + 2 * pad, W + 2 * pad, C), dtype=x.dtype, device=dev)
    mean_inv = torch.empty((2, N, C), dtype=torch.float32, device=dev)
    part = None
    if stats is None:
        part = torch.empty((N, groups, C, 3), dtype=torch.float32, device=dev)
    fn = lib.stx_in_pad_f32 if x.dtype == torch.float32 else lib.stx_in_pad_bf16
    with torch.cuda.device(dev):  # the library launches on the current device
        err = fn(
            x.data_ptr(), None if residual is None else residual.data_ptr(), res_pad,
            int(res_f32),
            None if stats is None else stats[0].data_ptr(),
            None if stats is None else stats[1].data_ptr(),
            scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            mean_inv[0].data_ptr(), mean_inv[1].data_ptr(),
            N, H, W, C, pad, int(mode == "edge"), int(relu), EPS, groups, chunk,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(
            "instance-norm kernel launch failed: "
            f"{lib.stx_instance_norm_error_string(err).decode()}"
        )
    return out, mean_inv


def _library() -> ctypes.CDLL:
    lib = _build.library("instance_norm")
    if not getattr(lib, "_stx_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.stx_in_pad_f32, lib.stx_in_pad_bf16):
            fn.argtypes = [p, p, i, i, p, p, p, p, p, p, p, p,
                           i, i, i, i, i, i, i, ctypes.c_float, i, i, p]
            fn.restype = i
        lib.stx_instance_norm_error_string.argtypes = [i]
        lib.stx_instance_norm_error_string.restype = ctypes.c_char_p
        lib._stx_typed = True
    return lib
