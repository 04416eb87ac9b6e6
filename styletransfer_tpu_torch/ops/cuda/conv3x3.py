"""3x3 VALID conv + bias (+ReLU) with per-image instance-norm sums.

The port of ``styletransfer_tpu/ops/pallas/conv3x3.py::conv3x3_valid``. Its
kernels, on the route that :func:`valid_plan` names for the shape:

- ``bf16_wgmma``: ``csrc/conv3x3_wgmma.cu`` (TMA ring, ``wgmma`` from shared
  memory), for bf16 at every width, a tile being ``floor(bm / seg)`` rows
  of ``seg`` columns: whole rows up to 256 wide, segments of wider rows;
- ``bf16_mma``: ``csrc/conv3x3.cu``'s ``mma.sync`` kernel, for bf16 where a
  caller asks for it (``route="bf16_mma"``);
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
# A TMA box dimension is at most 256: the wgmma route's segments of a row.
MAX_SEGMENT = 256
# Rows over MAX_SEGMENT wide are cut into at most this many segments.
MAX_SEGMENTS = 64
# The batch at which valid_plan scores the card's fill: the plan's tile, and
# so the order of each image's sums, is the same at every batch (the CLIs'
# default batch of training and of video convert-dir).
PLAN_BATCH = 4


class ValidPlan(NamedTuple):
    """How conv3x3_valid runs one shape: the route, the tile of ``bm``
    output positions, the ring's ``stages`` (wgmma only, else 0), the tiles
    of one image (each writes its partial sums), the blocks of the grid,
    and the wgmma route's ``segment``: the columns of a tile, W for tiles
    of whole rows (0 on the other routes)."""
    route: str
    bm: int
    stages: int
    image_tiles: int
    blocks: int
    segment: int = 0

    def __str__(self) -> str:
        stages = f" stages {self.stages}" if self.stages else ""
        tile = (f" tile {self.bm // self.segment}x{self.segment}" if self.segment else "")
        return f"{self.route} bm {self.bm}{stages}{tile} ({self.blocks} blocks)"


def wgmma_plan(B: int, H: int, W: int, O: int, bm: int, stages: int,
               segment: int) -> ValidPlan:
    """The wgmma route's plan for tiles of ``floor(bm / segment)`` rows of
    ``segment`` columns (``segment = W``: whole rows), on a persistent grid
    of at most one block per SM. ``chip_smoke.py`` times several segments of
    one shape with it."""
    if not (1 <= segment <= min(W, MAX_SEGMENT, bm)) or (bm, stages) not in WGMMA_CONFIGS:
        raise ValueError(f"no wgmma tile of {segment} columns at bm {bm}, stages {stages} for "
                         f"width {W}")
    image_tiles = math.ceil(H / (bm // segment)) * math.ceil(W / segment)
    tiles = B * image_tiles * math.ceil(O / BLOCK_N)
    return ValidPlan("bf16_wgmma", bm, stages, image_tiles, min(tiles, SMS), segment)


def _wgmma_score(plan: ValidPlan, B: int, W: int, O: int) -> float:
    """How much of its work a wgmma plan spends on the image: how full a
    tile is (``rows * segment / bm``), times the share of its columns that
    lie in the image (``W / (segs * segment)``, 1 for whole rows), times how
    much of the card the tiles fill (``min(1, tiles / SMS)``), times the
    halo tax ``segment / (segment + 2)``: a tile's three dx taps read
    windows that span two columns more than it writes. The tax is the same
    for every whole-row plan of a width; between segments it matches the
    side-by-side times at 260 wide (``chip_smoke.py``, ``PERF.md`` §6: 20
    segments of 13 columns, 96% full, were no faster than 10 of 26, 91%,
    and 52 of 5, 99.6% full, were slower than 5 of 52, 81%)."""
    rows = plan.bm // plan.segment
    segs = math.ceil(W / plan.segment)
    tiles = B * plan.image_tiles * math.ceil(O / BLOCK_N)
    return (rows * plan.segment / plan.bm * W / (segs * plan.segment)
            * min(1.0, tiles / SMS) * plan.segment / (plan.segment + 2))


@functools.lru_cache(maxsize=1024)  # a pure function, called on every launch
def valid_plan(B: int, H: int, W: int, C: int, O: int, dtype: torch.dtype,
               route: Optional[str] = None) -> ValidPlan:
    """The route and tile of conv3x3_valid for ``[B, H+2, W+2, C] -> O``.

    B sizes the grid and nothing else: the route, the tile (``bm``,
    ``stages``, ``segment``) and so ``image_tiles`` are functions of
    ``(H, W, C, O, dtype)`` alone. The wgmma tile is chosen by its score at
    a batch of :data:`PLAN_BATCH`, whatever B is, because an image's sums
    are added tile by tile: another tile would add them in another order,
    and an image's bits would depend on the batch it rides in.

    bf16 takes the wgmma route at every width; f32 takes ``f32_fma``. A
    wgmma tile is ``rows = bm // segment >= 1`` output rows of ``segment``
    columns, ``rows * segment <= bm`` positions (:func:`wgmma_plan`). TMA's
    16-byte strides need C and O to be multiples of 8, which
    :func:`conv3x3_valid` requires of every route (C % 32, O % 8); the
    launch also needs 16-byte aligned tensors and raises without them.

    Rows up to 256 wide take whole-row tiles (``segment = W``). A TMA box
    dimension is at most 256, so a wider row is cut into ``segs`` segments
    of ``segment = ceil(W / segs)`` columns, for every ``segs`` from
    ``ceil(W / 256)`` up to :data:`MAX_SEGMENTS`. Of those tiles, on each
    configuration of :data:`WGMMA_CONFIGS` that holds one, it takes the
    plan of the largest :func:`_wgmma_score` (tile fill, times the share of
    the segments' columns inside the image, times card fill, times a halo
    tax for narrow segments) at :data:`PLAN_BATCH`, the earlier on a tie:
    fewer, wider segments first, then the configurations in their order. At
    64 wide (256 px) that is bm 128, 4 stages, 2 whole rows; at 75 wide
    (300 px) bm 256, 3 whole rows (225 of 256 positions); at 260 wide
    (1040 px) 12 segments of 22 columns, 11 rows (242 of 256); at 1,008
    wide (a 4032 px photo) 4 segments of 252, one row. ``route`` asks for a
    given route's plan instead (``chip_smoke.py`` times the two bf16 routes
    side by side); it raises where that route cannot run."""
    n_tiles = math.ceil(O / BLOCK_N)
    default = "bf16_wgmma" if dtype == torch.bfloat16 else "f32_fma"
    route = route or default
    if route != default and not (route == "bf16_mma" and dtype == torch.bfloat16):
        raise ValueError(f"route {route} cannot run {dtype} [{B}, {H + 2}, {W + 2}, {C}] -> {O}")
    if route == "bf16_wgmma":
        if W <= MAX_SEGMENT:
            segments = [W]
        else:
            widths = (math.ceil(W / k) for k in range(math.ceil(W / MAX_SEGMENT),
                                                       MAX_SEGMENTS + 1))
            segments = sorted(set(widths), reverse=True)
        plans = [wgmma_plan(PLAN_BATCH, H, W, O, bm, stages, seg)
                 for seg in segments for bm, stages in WGMMA_CONFIGS if seg <= bm]
        best = max(plans, key=lambda p: _wgmma_score(p, PLAN_BATCH, W, O))  # the first of ties
        return wgmma_plan(B, H, W, O, best.bm, best.stages, best.segment)
    image_tiles = math.ceil(H * W / BLOCK_M)
    return ValidPlan(route, BLOCK_M, 0, image_tiles, B * image_tiles * n_tiles)


def conv3x3_valid_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, image by image (so that an image's result does
    not depend on the batch here either): f32 conv of the (f32-exact)
    inputs, + bias, ReLU, the sums of the f32 result, then the cast to
    ``x.dtype``."""
    wc = w.float().permute(3, 2, 0, 1)
    outs, sums, sumsqs = [], [], []
    for i in range(x.shape[0]):
        acc = F.conv2d(x[i:i + 1].float().permute(0, 3, 1, 2), wc)
        acc = acc.permute(0, 2, 3, 1) + b.float()
        if relu:
            acc = torch.relu(acc)
        outs.append(acc.to(x.dtype))
        sums.append(acc.sum(dim=(1, 2)))
        sumsqs.append((acc * acc).sum(dim=(1, 2)))
    return torch.cat(outs), torch.cat(sums), torch.cat(sumsqs)


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
            err = lib.wgmma.stx_conv3x3_wgmma(*args, plan.bm, plan.stages, plan.segment,
                                              plan.blocks, stream)
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
    wgmma.stx_conv3x3_wgmma.argtypes = [p] * 8 + [i] * 10 + [p]
    wgmma.stx_conv3x3_wgmma.restype = i
    for fn in (general.stx_conv3x3_error_string, wgmma.stx_conv3x3_wgmma_error_string):
        fn.argtypes = [i]
        fn.restype = ctypes.c_char_p
    return _Libraries(general, wgmma)
