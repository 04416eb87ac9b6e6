"""Instance norm (+residual) (+ReLU) with its gradient: the training norm.

The port of ``styletransfer_tpu/ops/pallas/instance_norm.py::
fused_instance_norm`` (``_fused``, its custom VJP ``_fused_fwd`` /
``_fused_bwd``, and the kernel ``_pallas_forward`` -> ``_kernel`` /
``_kernel_with_res``): ``nn.InstanceNorm2d(affine=True)`` of
``x + residual`` (added in f32), then an optional ReLU, output in x's dtype.

- Forward: ``csrc/instance_norm.cu`` at pad 0 with the residual added in f32
  (exact centered variance, as the TPU kernel's two passes); it returns the
  per-(image, channel) ``mean`` and ``inv = rsqrt(var + eps)`` as well.
- Backward: ``csrc/instance_norm_bwd.cu``, the closed form of the VJP (what
  ``jax.vjp`` of ``_xla_reference`` gives): with ``xhat = (s - mean) * inv``
  and ``gm`` the output gradient masked by the ReLU,
  ``dx = inv * scale * (gm - S1/HW - xhat * S2/HW)`` with
  ``S1 = sum_hw gm``, ``S2 = sum_hw gm * xhat``; ``dresidual = dx``;
  ``dscale = sum_n S2``, ``dbias = sum_n S1``. One cooperative launch per
  call on the grid that :func:`bwd_plan` names.

The affines are [C], or [N, C] for one row per image (multi-style
training, ``models/multistyle.py``): then each image normalizes with its own
row, and ``dscale`` / ``dbias`` are [N, C], image n's S2 and S1, with no sum
over the images (the gather of the rows from the styles' [S, C] parameters
adds them per style).

Both kernels are bound by bytes; their source headers say what the designs
do about it. :func:`fused_instance_norm` is the differentiable entry point
(a ``torch.autograd.Function``). On CPU tensors it computes the plain
versions beside it (:func:`forward_plain`, :func:`backward_plain`); on CUDA
tensors it launches the kernels or raises. ``fwd_launches`` and
``bwd_launches`` count the kernels' launches, ``fwd_per_image_launches``
and ``bwd_per_image_launches`` those among them with [N, C] affines.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from styletransfer_tpu_torch.ops.cuda import _build, check_cuda_inputs
from styletransfer_tpu_torch.ops.cuda import instance_norm as _in_pad

# Kernel launches since the counters were last set to 0; the per_image
# counters count the launches among them with [N, C] affines.
fwd_launches = 0
bwd_launches = 0
fwd_per_image_launches = 0
bwd_per_image_launches = 0

EPS = _in_pad.EPS
# The backward's chunks: at least this many elements of x per block, so that
# an image's G chunk partials (G * 2 * C floats, read by each of its G
# blocks) stay a few percent of the bytes a call moves.
BWD_MIN_ELEMS = 16384
# Threads of a block of the backward kernel (NT in csrc/instance_norm_bwd.cu).
BWD_THREADS = 512

Stats = Tuple[torch.Tensor, torch.Tensor]


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in f32, or wider if it is already (float64 for gradcheck)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _sum(x: torch.Tensor, residual: Optional[torch.Tensor]) -> torch.Tensor:
    s = _wide(x)
    return s if residual is None else s + _wide(residual)


class BwdPlan(NamedTuple):
    """How the backward kernel runs x [N, H, W, C]: ``blocks`` in its grid
    (the chunks' workers and one block that adds dscale and dbias), each
    image cut into ``image_chunks`` chunks of ``chunk`` pixels (chunk t of
    image n is item n * image_chunks + t; worker b takes items b, b +
    workers, ...), and the f32 ``scratch`` of the chunk partials, [N,
    image_chunks, 2, C]."""
    blocks: int
    image_chunks: int
    chunk: int
    scratch: Tuple[int, int, int, int]


@functools.lru_cache(maxsize=1024)  # a pure function, called on every launch
def bwd_plan(N: int, H: int, W: int, C: int, resident: int) -> BwdPlan:
    """The backward's grid for x [N, H, W, C] on a device that holds
    ``resident`` blocks of the kernel at once (the occupancy API; the
    cooperative launch is refused past it). One block adds dscale and
    dbias; of the ``resident - 1`` others, an image takes ``G = min((resident
    - 1) // N, ceil(H * W * C / BWD_MIN_ELEMS))`` (at least 1, at most one a
    pixel), each a chunk of ``ceil(H * W / G)`` pixels. The workers are one
    block per chunk, or ``resident - 1`` blocks that take several chunks
    each when the images outnumber them."""
    if resident < 2:
        raise ValueError(f"the device holds {resident} blocks of the backward kernel at once; "
                         "it needs 2")
    hw = H * W
    G = max(1, min((resident - 1) // N, math.ceil(hw * C / BWD_MIN_ELEMS), hw))
    chunk = math.ceil(hw / G)
    G = math.ceil(hw / chunk)
    return BwdPlan(min(N * G, resident - 1) + 1, G, chunk, (N, G, 2, C))


def _per_pixel(t: torch.Tensor) -> torch.Tensor:
    """A [C] affine as it is, an [N, C] one as [N, 1, 1, C]: either
    broadcasts over [N, H, W, C]."""
    return t if t.dim() == 1 else t[:, None, None, :]


def forward_plain(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
    relu: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch forward, ``_xla_reference``'s arithmetic: s = x +
    residual in f32, the exact centered variance, the affine ([C] or [N, C])
    and ReLU in f32, then the cast to ``x.dtype``. Returns ``(out, mean,
    inv)``, the statistics [N, C] f32."""
    s = _sum(x, residual)
    mean = s.mean(dim=(1, 2))
    var = (s - mean[:, None, None, :]).square().mean(dim=(1, 2))
    inv = torch.rsqrt(var + EPS)
    scale, bias = _per_pixel(scale), _per_pixel(bias)
    out = (s - mean[:, None, None, :]) * inv[:, None, None, :] * scale + bias
    if relu:
        out = torch.relu(out)
    return out.to(x.dtype), mean, inv


def backward_plain(
    g: torch.Tensor,
    x: torch.Tensor,
    residual: Optional[torch.Tensor],
    mean: torch.Tensor,
    inv: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    relu: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward, the closed form in the module docstring.
    Returns ``(dx, dscale, dbias)``: dx in ``x.dtype``, the others f32 and
    shaped as ``scale`` ([C]: summed over the images; [N, C]: per image)."""
    per_image = scale.dim() == 2
    mu, iv = mean[:, None, None, :], inv[:, None, None, :]
    scale, bias = _per_pixel(scale), _per_pixel(bias)
    xhat = (_sum(x, residual) - mu) * iv
    gm = _wide(g)
    if relu:
        gm = gm.masked_fill(~(xhat * scale + bias > 0), 0.0)
    s1 = gm.sum(dim=(1, 2))
    s2 = (gm * xhat).sum(dim=(1, 2))
    rhw = 1.0 / (x.shape[1] * x.shape[2])
    dx = iv * scale * (gm - s1[:, None, None, :] * rhw - xhat * (s2[:, None, None, :] * rhw))
    if per_image:
        return dx.to(x.dtype), s2, s1
    return dx.to(x.dtype), s2.sum(dim=0), s1.sum(dim=0)


def forward(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
    relu: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(out, mean, inv)``: the forward kernel on CUDA tensors, the plain
    version on CPU tensors. ``x`` [N, H, W, C] f32 or bf16, ``residual`` the
    same shape and dtype or None, ``scale``/``bias`` [C] or [N, C] f32."""
    _in_pad.check(x, scale, bias, residual)
    if x.device.type == "cpu":
        return forward_plain(x, scale, bias, residual, relu)
    global fwd_launches, fwd_per_image_launches
    out, mean_inv = _in_pad.launch(x, scale, bias, residual, 0, True, relu, 0, "reflect", None)
    fwd_launches += 1
    fwd_per_image_launches += scale.dim() == 2
    return out, mean_inv[0], mean_inv[1]


def backward(
    g: torch.Tensor,
    x: torch.Tensor,
    residual: Optional[torch.Tensor],
    mean: torch.Tensor,
    inv: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    relu: bool = False,
    need_dx: bool = True,
) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """``(dx, dscale, dbias)`` from the forward's saved inputs and
    statistics: the backward kernel on CUDA tensors, the plain version on
    CPU tensors. ``need_dx=False`` skips the dx pass (dx is None).
    ``dscale`` and ``dbias`` are shaped as ``scale``."""
    _in_pad.check(x, scale, bias, residual)
    N, H, W, C = x.shape
    if tuple(g.shape) != tuple(x.shape) or g.dtype != x.dtype:
        raise ValueError(f"g must be {x.dtype} {tuple(x.shape)}, got {g.dtype} {tuple(g.shape)}")
    for name, t in (("mean", mean), ("inv", inv)):
        if tuple(t.shape) != (N, C) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [{N}, {C}], got {t.dtype} {tuple(t.shape)}")
    if x.device.type == "cpu":
        dx, dscale, dbias = backward_plain(g, x, residual, mean, inv, scale, bias, relu)
        return (dx if need_dx else None), dscale, dbias
    extra = [] if residual is None else [residual]
    check_cuda_inputs(x, g, mean, inv, scale, bias, *extra)
    global bwd_launches, bwd_per_image_launches
    lib = _library()
    dev = x.device
    plan = bwd_plan(N, H, W, C, _resident(dev, x.dtype))
    stream = torch.cuda.current_stream(dev).cuda_stream
    part = _scratch(plan, dev, stream)
    dsb = torch.empty((2, *scale.shape), dtype=torch.float32, device=dev)
    dx = torch.empty_like(x) if need_dx else None
    fn = lib.stx_in_bwd_f32 if x.dtype == torch.float32 else lib.stx_in_bwd_bf16
    with torch.cuda.device(dev):  # the library launches on the current device
        err = fn(
            x.data_ptr(), None if residual is None else residual.data_ptr(), g.data_ptr(),
            mean.data_ptr(), inv.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            C if scale.dim() == 2 else 0, part,
            dsb[0].data_ptr(), dsb[1].data_ptr(), None if dx is None else dx.data_ptr(),
            N, H * W, C, int(relu), plan.blocks, plan.image_chunks, plan.chunk, stream,
        )
    if err:
        raise RuntimeError(
            f"instance-norm backward kernel launch failed ({plan}): "
            f"{lib.stx_instance_norm_bwd_error_string(err).decode()}"
        )
    bwd_launches += 1
    bwd_per_image_launches += scale.dim() == 2
    return dx, dsb[0], dsb[1]


# Per device and stream: the backward's chunk partials, grown to the
# largest plan so far. Launches on one stream run in order, so they share it;
# every launch writes all of its partials before it reads any.
_SCRATCH: Dict[Tuple[torch.device, int], torch.Tensor] = {}
# Per device index and dtype: the blocks of the backward kernel the device
# holds at once.
_RESIDENT: Dict[Tuple[int, torch.dtype], int] = {}


def _scratch(plan: BwdPlan, device: torch.device, stream: int) -> int:
    """Pointer to at least ``plan.scratch`` f32 partials on ``device``."""
    need = math.prod(plan.scratch)
    buf = _SCRATCH.get((device, stream))
    if buf is None or buf.numel() < need:
        buf = torch.empty(need, dtype=torch.float32, device=device)
        _SCRATCH[(device, stream)] = buf
    return buf.data_ptr()


def _resident(device: torch.device, dtype: torch.dtype) -> int:
    """The blocks of the backward kernel for ``dtype`` that ``device`` holds
    at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` times the
    SMs)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, dtype)
    if key not in _RESIDENT:
        lib = _library()
        fn = lib.stx_in_bwd_resident_f32 if dtype == torch.float32 else \
            lib.stx_in_bwd_resident_bf16
        found = ctypes.c_int(0)
        with torch.cuda.device(index):
            err = fn(ctypes.byref(found))
        if err:
            raise RuntimeError("instance-norm backward occupancy query failed: "
                               f"{lib.stx_instance_norm_bwd_error_string(err).decode()}")
        _RESIDENT[key] = found.value
    return _RESIDENT[key]


class _FusedInstanceNorm(torch.autograd.Function):
    """The forward and backward above as one differentiable op. It saves x
    and the residual (not their sum) and the statistics, as ``_fused_fwd``
    saves its inputs."""

    @staticmethod
    def forward(ctx, x, scale, bias, residual, relu):
        out, mean, inv = forward(x, scale, bias, residual, relu)
        ctx.save_for_backward(x, scale, bias, residual, mean, inv)
        ctx.relu = relu
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, residual, mean, inv = ctx.saved_tensors
        need_x, need_scale, need_bias, need_res, _ = ctx.needs_input_grad
        # A convolution's backward can hand back a permuted view.
        dx, dscale, dbias = backward(g.contiguous(), x, residual, mean, inv, scale, bias,
                                     ctx.relu, need_dx=need_x or need_res)
        return (dx if need_x else None, dscale if need_scale else None,
                dbias if need_bias else None, dx if need_res else None, None)


def fused_instance_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
    relu: bool = False,
) -> torch.Tensor:
    """Differentiable ``IN(x + residual)`` (+ReLU) over the spatial dims of
    NHWC ``x`` (f32 or bf16; ``residual`` the same shape and dtype),
    ``scale``/``bias`` [C] f32, or [N, C] f32 for an affine per image.
    Output in ``x.dtype``; gradients for x, residual (the same tensor as
    x's), scale and bias (shaped as they are)."""
    return _FusedInstanceNorm.apply(x, scale, bias, residual, relu)


def _library() -> ctypes.CDLL:
    lib = _build.library("instance_norm_bwd")
    if not getattr(lib, "_stx_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.stx_in_bwd_f32, lib.stx_in_bwd_bf16):
            fn.argtypes = [p] * 7 + [i] + [p] * 4 + [i] * 7 + [p]
            fn.restype = i
        for fn in (lib.stx_in_bwd_resident_f32, lib.stx_in_bwd_resident_bf16):
            fn.argtypes = [p]
            fn.restype = i
        lib.stx_instance_norm_bwd_error_string.argtypes = [i]
        lib.stx_instance_norm_bwd_error_string.restype = ctypes.c_char_p
        lib._stx_typed = True
    return lib
