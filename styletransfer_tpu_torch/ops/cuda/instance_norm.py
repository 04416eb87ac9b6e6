"""Instance norm (+residual) (+ReLU) that writes its output pre-padded.

The port of ``styletransfer_tpu/ops/pallas/instance_norm.py::
fused_instance_norm_padded``, with the two things the pad-early forward
(``_in_pad`` in ``styletransfer_tpu/models/transformer.py``) adds: edge
padding and statistics handed in by the conv3x3 kernel. The kernel is
``csrc/instance_norm.cu``, whose header says what bounds it on the card:
one launch per call, one image per thread-block cluster, on the route that
:func:`in_plan` names for the shape. :func:`instance_norm_pad` launches it
on CUDA tensors and computes :func:`instance_norm_pad_plain` on CPU
tensors. ``launches`` counts the kernel's launches by this wrapper;
:func:`launch` is shared with the training forward
(``fused_instance_norm.py``), which counts its own.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from styletransfer_tpu_torch.ops import layers
from styletransfer_tpu_torch.ops.cuda import _build, check_cuda_inputs

# Kernel launches since the counter was last set to 0.
launches = 0

_DTYPES = (torch.float32, torch.bfloat16)
EPS = 1e-5  # nn.InstanceNorm2d's

# Threads per block of csrc/instance_norm.cu, and its largest cluster (16 is
# past the portable 8: the kernel opts in).
THREADS = 256
MAX_CLUSTER = 16
# Streaming multiprocessors of an H100 SXM.
SMS = 132
# The routes, by the kernel's numbers for them.
ROUTES = {"sums": 0, "l2": 1}


class InPlan(NamedTuple):
    """How the IN kernel runs one shape: the route (``sums``: statistics
    given, no reduction; ``l2``: each block's band is read again from L2
    after the cluster's reduction), ``ctas`` blocks per
    image of ``rows`` image rows each, in clusters of ``cluster`` blocks,
    ``vec`` channels per 16- (or 8-) byte access, and the dynamic shared
    memory of a block in bytes."""
    route: str
    ctas: int
    cluster: int
    rows: int
    vec: int
    smem: int

    def __str__(self) -> str:
        return (f"{self.route}: {self.ctas} blocks of {self.rows} rows per image, cluster "
                f"{self.cluster}, vec {self.vec}, {self.smem} B shared")


@functools.lru_cache(maxsize=1024)  # a pure function, called on every launch
def in_plan(N: int, H: int, W: int, C: int, dtype: torch.dtype, has_stats: bool) -> InPlan:
    """The route and blocks of the IN kernel for x [N, H, W, C].

    ``has_stats``: (sums, sumsqs) are given, so there is no reduction and no
    cluster; the images' blocks of whole rows make about one wave of three
    blocks per SM. Otherwise an image is one cluster of the largest power
    of two of blocks up to :data:`MAX_CLUSTER` and H, each owning
    ``ceil(H / cluster)`` rows (the last blocks of a ragged H may own none),
    whose band is read again from L2 after the cluster's reduction
    (``l2``). Accesses are 16 bytes (``vec`` 4 in f32, 8 in bf16), 8 in
    bf16 where C % 8 != 0. Every shape the wrapper's check takes (C % 4 ==
    0, C <= 1024) has a plan, with or without a residual."""
    vec = 8 if dtype == torch.bfloat16 and C % 8 == 0 else 4
    channels = 4 * C * 4  # mean, inv * scale and the cluster partials
    if has_stats:  # about one wave of three blocks per SM
        ctas = min(H, max(1, 3 * SMS // N))
        rows = -(-H // ctas)
        return InPlan("sums", -(-H // rows), 1, rows, vec, channels)
    cluster = 1 << (min(MAX_CLUSTER, H).bit_length() - 1)
    rows = -(-H // cluster)
    return InPlan("l2", cluster, cluster, rows, vec, channels + THREADS * (1 + 2 * vec) * 4)


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
    ``x.dtype``. Runs :func:`in_plan`'s plan for the shape. Returns ``(out,
    mean_inv)`` with ``mean_inv`` [2, N, C] f32: the statistics the output
    was normalized with. Raises if the launch is refused (a cluster the
    device cannot place, an unaligned tensor)."""
    extra = [] if residual is None else [residual]
    extra += [] if stats is None else list(stats)
    check_cuda_inputs(x, scale, bias, *extra)
    N, H, W, C = x.shape
    plan = in_plan(N, H, W, C, x.dtype, stats is not None)
    dev = x.device
    out = torch.empty((N, H + 2 * pad, W + 2 * pad, C), dtype=x.dtype, device=dev)
    mean_inv = torch.empty((2, N, C), dtype=torch.float32, device=dev)
    ptrs = (x.data_ptr(), None if residual is None else residual.data_ptr(),
            None if stats is None else stats[0].data_ptr(),
            None if stats is None else stats[1].data_ptr(),
            scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            mean_inv[0].data_ptr(), mean_inv[1].data_ptr())
    _call(x.dtype, dev, ptrs, res_pad, res_f32, (N, H, W, C), pad, mode, relu, plan, None)
    return out, mean_inv


def max_active_clusters(x: torch.Tensor, plan: InPlan) -> int:
    """How many clusters of ``plan``'s kernel the device of ``x`` (a CUDA
    tensor of the call's shape and dtype) runs at once
    (``cudaOccupancyMaxActiveClusters``); launches nothing."""
    N, H, W, C = x.shape
    found = ctypes.c_int(0)
    ptrs = (x.data_ptr(), None, None, None, None, None, x.data_ptr(), None, None)
    if plan.route == "sums":  # the kernel checks that the route has its sums
        ptrs = ptrs[:2] + (x.data_ptr(), x.data_ptr()) + ptrs[4:]
    _call(x.dtype, x.device, ptrs, 0, False, (N, H, W, C), 0, "edge", False, plan,
          ctypes.byref(found))
    return found.value


def _call(dtype, dev, ptrs, res_pad, res_f32, shape, pad, mode, relu, plan, clusters) -> None:
    lib = _library()
    fn = lib.stx_in_pad_f32 if dtype == torch.float32 else lib.stx_in_pad_bf16
    N, H, W, C = shape
    with torch.cuda.device(dev):  # the library launches on the current device
        err = fn(ptrs[0], ptrs[1], res_pad, int(res_f32), *ptrs[2:], N, H, W, C, pad,
                 int(mode == "edge"), int(relu), EPS, ROUTES[plan.route], plan.ctas,
                 plan.cluster, plan.rows, plan.vec,
                 torch.cuda.current_stream(dev).cuda_stream, clusters)
    if err:
        raise RuntimeError(
            f"instance-norm kernel ({plan}) launch failed: "
            f"{lib.stx_instance_norm_error_string(err).decode()}"
        )


def _library() -> ctypes.CDLL:
    lib = _build.library("instance_norm")
    if not getattr(lib, "_stx_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.stx_in_pad_f32, lib.stx_in_pad_bf16):
            fn.argtypes = [p, p, i, i, p, p, p, p, p, p, p,
                           i, i, i, i, i, i, i, ctypes.c_float, i, i, i, i, i, p, p]
            fn.restype = i
        lib.stx_instance_norm_error_string.argtypes = [i]
        lib.stx_instance_norm_error_string.restype = ctypes.c_char_p
        lib._stx_typed = True
    return lib
