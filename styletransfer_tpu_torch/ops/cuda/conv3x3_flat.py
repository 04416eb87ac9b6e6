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
  on a shared-memory span of shifted input rows) on the tile and channel
  split that :func:`flat_plan` picks for the shape;
- :func:`conv3x3_im2col` launches ``csrc/conv3x3_im2col.cu`` (one product of
  depth 9C) on the route that :func:`im2col_plan` names for the shape: the
  span of input pixels loaded once per tile on a persistent grid, or the
  operand gathered per block;
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
import functools
import math
from typing import Callable, Dict, NamedTuple, Tuple

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

# Streaming multiprocessors of an H100 SXM: a plan gives at least this many
# blocks wherever the shape has the work for it.
SMS = 132
# conv3x3_flat's routes: the f32 one on the CUDA cores (FMA), the bf16 one on
# the tensor cores (wgmma). Each has its (BM, BN) tiles for wide (O > 64),
# mid (4 or 8 < O <= 64) and narrow O, in the order the plan tries them;
# conv3x3_flat.cu builds exactly these.
FLAT_ROUTES = {
    torch.float32: ("f32_fma", 8, {"wide": ((128, 128),),
                                   "mid": ((256, 64), (128, 64)),
                                   "narrow": ((512, 4),)}),
    torch.bfloat16: ("bf16_wgmma", 16, {"wide": ((128, 128), (128, 64)),
                                        "mid": ((128, 64),),
                                        "narrow": ((128, 8),)}),
}
# The most blocks one tile's channel chunks are split over.
MAX_SPLIT = 8
# The batch at which flat_plan counts blocks: the tile and the split, and so
# the order of each output's sums, are the same at every batch (the CLIs'
# default batch of training and of video convert-dir). A split planned for
# one image would cost 12-55% at batch 4 and 64; planned for 4, a lone
# image (a Gatys closure) may fill only part of the card (PERF.md §6).
PLAN_BATCH = 4


class FlatPlan(NamedTuple):
    """How conv3x3_flat runs one shape: the route, the tile of ``bm``
    positions by ``bn`` output channels, the number of blocks the channel
    chunks are split over, and the blocks of the grid."""
    route: str
    bm: int
    bn: int
    split: int
    blocks: int

    def __str__(self) -> str:
        return f"{self.route} {self.bm}x{self.bn} split {self.split} ({self.blocks} blocks)"


@functools.lru_cache(maxsize=1024)  # a pure function, called on every launch
def flat_plan(B: int, H: int, W: int, C: int, O: int, dtype: torch.dtype) -> FlatPlan:
    """The tile and split of conv3x3_flat for ``[B, H+2, W+2, C] -> O``.

    B sizes the grid and nothing else: the tile and the split are chosen
    for a batch of :data:`PLAN_BATCH`, whatever B is, since a split adds an
    output's partial sums in another order, and an image's bits would
    otherwise depend on the batch it rides in. For that batch: the first
    tile of the route's list for O that gives at least :data:`SMS` blocks;
    if none does, the last (smallest) tile with its channel chunks split
    over the fewest blocks that reach :data:`SMS` (a divisor of the chunk
    count, at most :data:`MAX_SPLIT`; the largest such divisor if none
    reaches it)."""
    route, bk, tiles = FLAT_ROUTES[dtype]
    narrow = bk // 2  # 4 in f32, 8 in bf16: one float4 or one n8 tile
    group = tiles["wide"] if O > 64 else tiles["mid"] if O > narrow else tiles["narrow"]
    positions = H * (W + 2)  # the Wp-wide output grid

    def blocks(bm, bn, batch=PLAN_BATCH):
        return batch * math.ceil(positions / bm) * math.ceil(O / bn)

    for bm, bn in group:
        if blocks(bm, bn) >= SMS:
            return FlatPlan(route, bm, bn, 1, blocks(bm, bn, B))
    bm, bn = group[-1]
    chunks = math.ceil(C / bk)
    splits = [d for d in range(1, MAX_SPLIT + 1) if chunks % d == 0]
    split = next((d for d in splits if blocks(bm, bn) * d >= SMS), splits[-1])
    return FlatPlan(route, bm, bn, split, blocks(bm, bn, B) * split)


# conv3x3_im2col's routes (csrc/conv3x3_im2col.cu). "band": a tile of
# BAND_BM positions of the Wp-wide output grid by BAND_BN channels, whose
# span of input pixels comes in as one bulk copy, on a persistent grid of at
# most BAND_BLOCKS_PER_SM blocks an SM; it takes C <= BAND_MAX_C where its
# shared memory (BAND_SMEM_MAX) lets two blocks share an SM. "gather": the
# operand gathered per block of GATHER_BM pixels, any shape.
BAND_BM, BAND_BN, BAND_MAX_C, BAND_BLOCKS_PER_SM = 256, 64, 4, 2
BAND_SMEM_MAX = 113 * 1024
GATHER_BM = 128


class Im2colPlan(NamedTuple):
    """How conv3x3_im2col runs one shape: the route, the tile of ``bm``
    positions by ``bn`` output channels, the tiles and the blocks of the
    grid (on the band route each block walks tiles), and whether the band
    route's tiles go out by bulk stores from a staging tile."""
    route: str
    bm: int
    bn: int
    tiles: int
    blocks: int
    bulk_store: bool = False

    def __str__(self) -> str:
        bulk = " bulk stores" if self.bulk_store else ""
        return (f"{self.route} {self.bm}x{self.bn}{bulk} "
                f"({self.tiles} tiles on {self.blocks} blocks)")


def band_smem_bytes(W: int, C: int, O: int, dtype: torch.dtype, bulk_store: bool = False) -> int:
    """Dynamic shared memory of a band block (``band_smem_bytes`` in the
    kernel's source): two mbarriers, two stages of the span (16 bytes of
    lead, 128-byte aligned), the weights (bf16: packed in pairs along k, rows
    padded by 8 words), the bias and the staging tile (bf16; f32 with bulk
    stores)."""
    elt = 2 if dtype == torch.bfloat16 else 4
    chunks = math.ceil(O / BAND_BN)
    stage = math.ceil(((BAND_BM + 2 * (W + 2) + 2) * C * elt + 16) / 128) * 128
    if elt == 2:
        weights = math.ceil(9 * C / 16) * 8 * (chunks * BAND_BN + 8) * 4
        staging = BAND_BM * (BAND_BN + 8) * 2
    else:
        weights = 9 * C * chunks * BAND_BN * 4
        staging = BAND_BM * O * 4 if bulk_store else 0
    return 128 + 2 * stage + weights + chunks * BAND_BN * 4 + staging


@functools.lru_cache(maxsize=1024)  # a pure function, called on every launch
def im2col_plan(B: int, H: int, W: int, C: int, O: int, dtype: torch.dtype) -> Im2colPlan:
    """The route and grid of conv3x3_im2col for ``[B, H+2, W+2, C] -> O``:
    the band route where it takes the shape (every VGG conv1_1, C = 3), the
    gather route otherwise (its BN by O, as the kernel picks it).

    In f32 the band route stores from the registers where each block has one
    tile, and through a staging tile by bulk stores, left in flight while
    the block computes its next tile, where blocks walk more than one (and
    a pixel's O <= 64 channels are a 16-byte multiple): at conv1_1 the
    staging made batch 4 and 16 faster and batch 1 slower (PERF.md §6)."""
    if C <= BAND_MAX_C and band_smem_bytes(W, C, O, dtype) <= BAND_SMEM_MAX:
        tiles = B * math.ceil(H * (W + 2) / BAND_BM) * math.ceil(O / BAND_BN)
        blocks = min(tiles, BAND_BLOCKS_PER_SM * SMS)
        bulk = (dtype == torch.float32 and tiles > blocks and O <= BAND_BN and O % 4 == 0
                and band_smem_bytes(W, C, O, dtype, True) <= BAND_SMEM_MAX)
        return Im2colPlan("band", BAND_BM, BAND_BN, tiles, blocks, bulk)
    bn = 128 if O > 64 else 64 if O > 32 else 32 if O > 16 or dtype == torch.bfloat16 else 16
    tiles = B * math.ceil(H * W / GATHER_BM) * math.ceil(O / bn)
    return Im2colPlan("gather", GATHER_BM, bn, tiles, tiles)


def conv3x3_flat_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = False
) -> torch.Tensor:
    """Plain PyTorch version, image by image (so that an image's result does
    not depend on the batch here either): an f32 VALID conv of the
    (f32-exact) inputs, + bias in f32, ReLU, then one cast to ``x.dtype``."""
    wc = w.float().permute(3, 2, 0, 1)
    outs = []
    for i in range(x.shape[0]):
        acc = F.conv2d(x[i:i + 1].float().permute(0, 3, 1, 2), wc)
        acc = acc.permute(0, 2, 3, 1) + b.float()
        if relu:
            acc = torch.relu(acc)
        outs.append(acc.to(x.dtype))
    return torch.cat(outs).contiguous()


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
    B, Hp, Wp, C = x.shape
    plan = flat_plan(B, Hp - 2, Wp - 2, C, w.shape[3], x.dtype)
    out = _launch("flat", x, w, b, relu, plan)
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
    B, Hp, Wp, C = x.shape
    plan = im2col_plan(B, Hp - 2, Wp - 2, C, w.shape[3], x.dtype)
    out = _launch("im2col", x, w, b, relu, plan)
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
# Per device and stream: the f32 workspace of split plans and the zeroed
# counters (one int32 per tile) that conv3x3_flat's kernels leave at zero
# after each launch. Launches on one stream run in order, so they share them.
_SPLIT_BUFFERS: Dict[Tuple[torch.device, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _function(kind: str, dtype: torch.dtype) -> Tuple[Callable, Callable]:
    """The typed C entry point of one kernel and dtype, and its library's
    error-string function."""
    key = f"stx_conv3x3_{kind}_{'f32' if dtype == torch.float32 else 'bf16'}"
    if key not in _FUNCTIONS:
        lib = _build.library(f"conv3x3_{kind}")
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = getattr(lib, key)
        # flat also takes its plan: bm, bn, split, the workspace and counters;
        # im2col its route (0 gather, 1 band, 2 band with bulk stores) and blocks.
        fn.argtypes = ([p, p, p, p] + [i] * 6 + ([i, i, i, p, p] if kind == "flat" else [i, i])
                       + [p])
        fn.restype = i
        err_string = getattr(lib, f"stx_conv3x3_{kind}_error_string")
        err_string.argtypes = [i]
        err_string.restype = ctypes.c_char_p
        _FUNCTIONS[key] = (fn, err_string)
    return _FUNCTIONS[key]


def _split_buffers(plan: FlatPlan, device: torch.device, stream: int) -> Tuple[int, int]:
    """Pointers to a split plan's f32 workspace (``split`` partial tiles per
    tile) and to the per-tile counters; 0 and 0 without a split."""
    if plan.split == 1:
        return 0, 0
    ws, counters = _SPLIT_BUFFERS.get((device, stream), (None, None))
    if ws is None or ws.numel() < plan.blocks * plan.bm * plan.bn:
        ws = torch.empty(plan.blocks * plan.bm * plan.bn, dtype=torch.float32, device=device)
    if counters is None or counters.numel() < plan.blocks // plan.split:
        counters = torch.zeros(plan.blocks // plan.split, dtype=torch.int32, device=device)
    _SPLIT_BUFFERS[(device, stream)] = ws, counters
    return ws.data_ptr(), counters.data_ptr()


def _launch(kind: str, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            relu: bool, plan: "FlatPlan | Im2colPlan") -> torch.Tensor:
    check_cuda_inputs(x, w, b)
    fn, err_string = _function(kind, x.dtype)
    B, Hp, Wp, C = x.shape
    O = w.shape[3]
    out = torch.empty((B, Hp - 2, Wp - 2, O), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):  # the library launches on the current device
        args = [x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), B, Hp, Wp, C, O,
                int(relu)]
        if kind == "flat":
            args += [plan.bm, plan.bn, plan.split, *_split_buffers(plan, x.device, stream)]
        else:
            args += [0 if plan.route == "gather" else 2 if plan.bulk_store else 1, plan.blocks]
        err = fn(*args, stream)
    if err:
        raise RuntimeError(f"conv3x3_{kind} kernel launch failed: {err_string(err).decode()}")
    return out
