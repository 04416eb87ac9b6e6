"""3x3 VALID conv + bias (+ReLU) with per-image instance-norm sums.

The port of ``styletransfer_tpu/ops/pallas/conv3x3.py::conv3x3_valid``. Its
kernels, on the route that :func:`valid_plan` names for the shape:

- ``bf16_wgmma``: ``csrc/conv3x3_wgmma.cu`` (TMA ring, ``wgmma`` from shared
  memory), for bf16 at every width up to 256, a tile being
  ``floor(bm / W)`` whole rows of the image;
- ``bf16_mma``: ``csrc/conv3x3.cu``'s ``mma.sync`` kernel, for bf16 rows
  wider than 256 (images over 1,024 px);
- ``f32_fma``: ``csrc/conv3x3.cu``'s FMA kernel, for f32.

The sources' headers say what bounds each kernel on the card and how it is
built. :func:`conv3x3_valid` launches the planned kernel on CUDA tensors and
computes :func:`conv3x3_valid_plain`, the same function in plain PyTorch, on
CPU tensors. ``launches`` counts every launch, ``fma_launches``,
``mma_launches`` and ``wgmma_launches`` those of each route.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from styletransfer_tpu_torch.ops.cuda import _build, check_cuda_inputs

# Kernel launches since the counters were last set to 0: all, and per route.
launches = 0
fma_launches = 0
mma_launches = 0
wgmma_launches = 0

_DTYPES = (torch.float32, torch.bfloat16)

# Streaming multiprocessors of an H100 SXM: the wgmma route's persistent grid
# has at most one block on each.
SMS = 132
# Output positions per block of conv3x3.cu's two kernels.
BLOCK_M = 128
# The wgmma route's configurations (positions per tile, ring stages), in the
# order the plan prefers them on a tie. conv3x3_wgmma.cu builds exactly
# these.
WGMMA_CONFIGS = ((256, 3), (128, 4))
# Output channels per tile of every route.
BLOCK_N = 128


class ValidPlan(NamedTuple):
    """How conv3x3_valid runs one shape: the route, the tile of ``bm``
    output positions, the ring's ``stages`` (wgmma only, else 0), the tiles
    of one image (each writes its partial sums), and the blocks of the
    grid."""
    route: str
    bm: int
    stages: int
    image_tiles: int
    blocks: int

    def __str__(self) -> str:
        stages = f" stages {self.stages}" if self.stages else ""
        return f"{self.route} bm {self.bm}{stages} ({self.blocks} blocks)"


@functools.lru_cache(maxsize=1024)  # a pure function, called on every launch
def valid_plan(B: int, H: int, W: int, C: int, O: int, dtype: torch.dtype,
               route: Optional[str] = None) -> ValidPlan:
    """The route and tile of conv3x3_valid for ``[B, H+2, W+2, C] -> O``.

    bf16 takes the wgmma route wherever W <= 256: a tile is ``rows =
    bm // W >= 1`` whole output rows, ``rows * W <= bm`` positions. TMA's
    16-byte strides need C and O to be multiples of 8, which
    :func:`conv3x3_valid` requires of every route (C % 32, O % 8); the
    launch also needs 16-byte aligned tensors and raises without them. Of
    the configurations of :data:`WGMMA_CONFIGS` with ``bm >= W`` it takes
    the one with the largest ``rows * W / bm * min(1, tiles / SMS)`` (how
    full a tile is, times how much of the card the tiles fill), the earlier
    on a tie, on a persistent grid of at most one block per SM. At 75 wide
    (300 px) that is bm 256: 3 rows, 225 of 256 positions.
    Wider bf16 rows take ``bf16_mma``, f32 takes ``f32_fma``. ``route``
    asks for a given route's plan instead (``chip_smoke.py`` times the two
    bf16 routes side by side); it raises where that route cannot run."""
    n_tiles = math.ceil(O / BLOCK_N)
    fits = [c for c in WGMMA_CONFIGS if W <= min(256, c[0])]
    wgmma = dtype == torch.bfloat16 and bool(fits)
    default = "bf16_wgmma" if wgmma else "f32_fma" if dtype == torch.float32 else "bf16_mma"
    route = route or default
    if route != default and not (route == "bf16_mma" and dtype == torch.bfloat16):
        raise ValueError(f"route {route} cannot run {dtype} [{B}, {H + 2}, {W + 2}, {C}] -> {O}")
    if route == "bf16_wgmma":
        def tiles(bm):
            return B * math.ceil(H / (bm // W)) * n_tiles

        def score(config):
            bm = config[0]
            return (bm // W) * W / bm * min(1.0, tiles(bm) / SMS)

        bm, stages = max(fits, key=score)  # the first of equal scores
        return ValidPlan(route, bm, stages, math.ceil(H / (bm // W)), min(tiles(bm), SMS))
    image_tiles = math.ceil(H * W / BLOCK_M)
    return ValidPlan(route, BLOCK_M, 0, image_tiles, B * image_tiles * n_tiles)


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
    B, Hp, Wp, C = x.shape
    return _launch(x, w, b, relu, valid_plan(B, Hp - 2, Wp - 2, C, w.shape[3], x.dtype))


def launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool,
           plan: ValidPlan) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`conv3x3_valid` on a given plan's kernel, for CUDA tensors
    (``chip_smoke.py`` times the two bf16 routes side by side). Raises if
    the route does not take x's dtype or the launch fails."""
    _check(x, w, b)
    if plan.route.split("_")[0] != ("f32" if x.dtype == torch.float32 else "bf16"):
        raise ValueError(f"route {plan.route} does not take {x.dtype}")
    return _launch(x, w, b, relu, plan)


def _launch(x, w, b, relu, plan):
    """The kernel of ``plan`` on inputs that ``_check`` has passed."""
    check_cuda_inputs(x, w, b)
    global launches, fma_launches, mma_launches, wgmma_launches
    lib = _library()
    B, Hp, Wp, C = x.shape
    O = w.shape[3]
    out = torch.empty((B, Hp - 2, Wp - 2, O), dtype=x.dtype, device=x.device)
    partials = torch.empty((2, B, plan.image_tiles, O), dtype=torch.float32, device=x.device)
    sums = torch.empty((2, B, O), dtype=torch.float32, device=x.device)
    args = [x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
            partials[0].data_ptr(), partials[1].data_ptr(), sums[0].data_ptr(),
            sums[1].data_ptr(), B, Hp, Wp, C, O, int(relu)]
    with torch.cuda.device(x.device):  # the library launches on the current device
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if plan.route == "bf16_wgmma":
            err = lib.wgmma.stx_conv3x3_wgmma(*args, plan.bm, plan.stages, plan.blocks, stream)
            error_string = lib.wgmma.stx_conv3x3_wgmma_error_string
        else:
            general = lib.general
            fn = general.stx_conv3x3_f32 if plan.route == "f32_fma" else general.stx_conv3x3_bf16
            err = fn(*args, stream)
            error_string = lib.general.stx_conv3x3_error_string
    if err:
        raise RuntimeError(
            f"conv3x3 kernel ({plan.route}) launch failed: {error_string(err).decode()}")
    launches += 1
    if plan.route == "f32_fma":
        fma_launches += 1
    elif plan.route == "bf16_mma":
        mma_launches += 1
    else:
        wgmma_launches += 1
    return out, sums[0], sums[1]


class _Libraries(NamedTuple):
    general: ctypes.CDLL  # csrc/conv3x3.cu
    wgmma: ctypes.CDLL  # csrc/conv3x3_wgmma.cu


@functools.lru_cache(maxsize=None)
def _library() -> _Libraries:
    p, i = ctypes.c_void_p, ctypes.c_int
    general, wgmma = _build.library("conv3x3"), _build.library("conv3x3_wgmma")
    for fn in (general.stx_conv3x3_f32, general.stx_conv3x3_bf16):
        fn.argtypes = [p] * 8 + [i] * 6 + [p]
        fn.restype = i
    wgmma.stx_conv3x3_wgmma.argtypes = [p] * 8 + [i] * 9 + [p]
    wgmma.stx_conv3x3_wgmma.restype = i
    for fn in (general.stx_conv3x3_error_string, wgmma.stx_conv3x3_wgmma_error_string):
        fn.argtypes = [i]
        fn.restype = ctypes.c_char_p
    return _Libraries(general, wgmma)
