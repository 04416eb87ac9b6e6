"""Gatys optimization-based style transfer.

The port of ``styletransfer_tpu/engines/gatys.py``: the pixels of the
content image are optimized
against VGG19 Gram (style) and feature (content) losses. Each closure runs
the VGG tower to ``conv3_1`` forward and backward on the stat-free 3x3 conv
kernels (``models/vgg.py``): ``conv3x3_im2col`` for ``conv1_1``,
``conv3x3_flat`` for the other four convs and for all five input gradients.

Three optimizers:
- ``lbfgs`` (default): the torch-contract L-BFGS (``ops/lbfgs.py``): each
  step is one ``torch.optim.LBFGS.step(closure)`` with the reference's
  defaults (up to 20 fixed-step inner iterations, persistent history), so
  the CLI's ``-s 300`` makes the reference's ~6,000 closure evaluations;
- ``lbfgs-zoom``: ``optax.lbfgs()`` (a memory of 10 and the zoom line
  search, ``ops/linesearch.py``; ``lbfgs.lbfgs_zoom``): one line-searched
  update per step, each costing as many closures as its line search takes;
- ``adam``: Adam over the pixels (optax ``adam``'s arithmetic).

A batch of N content images is N independent problems: with ``lbfgs`` and
``lbfgs-zoom`` each lane has its own history, step size and breaks (or line
search); its closure returns each
lane's own single-image loss and gradient (the per-lane losses are summed
for the backward, never averaged). The reported loss history is the mean
over lanes, as in the JAX engine. ``adam`` minimizes the batch's loss, the
mean over lanes, as the JAX engine does.

The serving daemon (``gatys_st --serve``, :func:`serve_loop`) runs one
optimization per request; with ``batch > 1`` a group of requests runs as
independent lanes, each against its own Gram targets (``make_loss_fn``
takes targets of shape [N, C, C]) and each with its own loss history
(:func:`_run_serve_batched`), the group's lanes split over the devices
(:func:`_run_serve_placed`). The devices take their shares one after the
other: under L-BFGS each inner iteration (each line-search iteration under
``lbfgs-zoom``) reads back from the device.
"""

from __future__ import annotations

import math
import os
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from styletransfer_tpu_torch import constants
from styletransfer_tpu_torch.models import vgg
from styletransfer_tpu_torch.ops import layers, losses, lbfgs
from styletransfer_tpu_torch.utils.logging import get_logger

OPTIMIZERS = ("adam", "lbfgs", "lbfgs-zoom")

# Closure evaluations (loss and pixel gradient of every lane) since the
# counter was last set to 0.
closure_evals = 0


def make_loss_fn(
    vgg_params: vgg.Params,
    content_image: torch.Tensor,
    style_grams: Mapping[str, torch.Tensor],
    style_weight: float = 100_000.0,
    content_weight: float = 1.0,
    compute_dtype: Optional[torch.dtype] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The pixel objective of each lane: ``loss_fn(pixels [N, H, W, 3]) ->
    [N]``, weighted style (Gram MSE) plus content (feature MSE), each lane
    against its own content image ``content_image[i]``. Lane i's value is the
    JAX ``make_loss_fn`` of that image alone.

    The content targets are computed here, once (XLA hoists the same
    loop-invariant computation out of the JAX optimizer)."""
    content_layers = vgg.CONTENT_LAYERS
    taps = tuple(sorted(set(tuple(style_grams) + tuple(content_layers))))
    with torch.no_grad():
        targets = vgg.extract_features(vgg_params, content_image, content_layers, compute_dtype)
    grams = {name: (g.float() if g.dim() == 3 else g.float()[None])
             for name, g in style_grams.items()}

    def loss_fn(pixels: torch.Tensor) -> torch.Tensor:
        feats = vgg.extract_features(vgg_params, pixels, taps, compute_dtype)
        s_loss = sum((losses.gram_matrix(feats[name]) - tgt).square().mean(dim=(1, 2))
                     for name, tgt in grams.items())
        c_loss = sum((feats[name].float() - targets[name].float()).square().mean(dim=(1, 2, 3))
                     for name in content_layers)
        return style_weight * s_loss + content_weight * c_loss

    return loss_fn


def _run_adam(
    vgg_params: vgg.Params,
    content_image: torch.Tensor,
    style_grams: Mapping[str, torch.Tensor],
    steps: int,
    style_weight: float,
    content_weight: float,
    learning_rate: float,
    compute_dtype: Optional[torch.dtype] = None,
    init_pixels: Optional[torch.Tensor] = None,
    per_lane: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Adam over the pixels from the content image (or ``init_pixels``);
    returns ``(pixels, losses [steps])``, the loss before each update.

    ``per_lane``: each image is its own problem (the lanes' losses are
    summed, so each lane's gradient is its own loss's, and Adam is
    elementwise), and the losses are ``[N, steps]``, one row per lane."""
    loss_fn = make_loss_fn(vgg_params, content_image, style_grams, style_weight,
                           content_weight, compute_dtype)
    start = content_image if init_pixels is None else init_pixels
    pixels = start.detach().float().clone().requires_grad_()
    opt = torch.optim.Adam([pixels], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    history = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        lane_losses = loss_fn(pixels)
        (lane_losses.sum() if per_lane else lane_losses.mean()).backward()
        opt.step()
        history.append(lane_losses.detach() if per_lane else lane_losses.detach().mean())
    if not history:
        return pixels.detach(), pixels.new_zeros((start.shape[0], 0) if per_lane else 0)
    return pixels.detach(), torch.stack(history, dim=-1)


def _lane_closure(loss_fn: Callable[[torch.Tensor], torch.Tensor], shape) -> Callable:
    """The L-BFGS closure over lanes: flat pixels [N, H * W * 3] -> (each
    lane's loss [N], each lane's own gradient [N, H * W * 3]; the lanes'
    losses are summed for the backward, never averaged)."""

    def loss_and_grad(x_flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        global closure_evals
        x = x_flat.detach().reshape(shape).requires_grad_()
        with torch.enable_grad():
            lane_losses = loss_fn(x)
            (grad,) = torch.autograd.grad(lane_losses.sum(), x)
        closure_evals += 1
        return lane_losses.detach(), grad.reshape(shape[0], -1)

    return loss_and_grad


def _run_lbfgs_torch(
    vgg_params: vgg.Params,
    content_image: torch.Tensor,
    style_grams: Mapping[str, torch.Tensor],
    steps: int,
    style_weight: float,
    content_weight: float,
    compute_dtype: Optional[torch.dtype] = None,
    max_iter: int = 20,
    history_size: int = 100,
    history_math: str = "compact",
    init_pixels: Optional[torch.Tensor] = None,
    per_lane: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``steps`` torch-LBFGS ``.step(closure)`` calls over the pixels, one
    independent optimizer per image of ``content_image`` [N, H, W, 3].
    Returns ``(pixels, losses [steps])``, the losses averaged over lanes
    (``per_lane``: ``[N, steps]``, each lane's own)."""
    shape = content_image.shape
    n_lanes = shape[0]
    loss_fn = make_loss_fn(vgg_params, content_image, style_grams, style_weight,
                           content_weight, compute_dtype)
    start = content_image if init_pixels is None else init_pixels
    x, history = lbfgs.lbfgs_torch(
        _lane_closure(loss_fn, shape), start.detach().float().reshape(n_lanes, -1), steps,
        max_iter=max_iter, history_size=history_size, history_math=history_math)
    return x.reshape(shape), history if per_lane else history.mean(dim=0)


def _run_lbfgs(
    vgg_params: vgg.Params,
    content_image: torch.Tensor,
    style_grams: Mapping[str, torch.Tensor],
    steps: int,
    style_weight: float,
    content_weight: float,
    compute_dtype: Optional[torch.dtype] = None,
    init_pixels: Optional[torch.Tensor] = None,
    per_lane: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``steps`` updates of ``optax.lbfgs()`` over the pixels (memory 10,
    the zoom line search; ``lbfgs.lbfgs_zoom``), one independent optimizer
    per image of ``content_image`` [N, H, W, 3]. Returns ``(pixels, losses
    [steps])``, the losses averaged over lanes (``per_lane``: ``[N,
    steps]``, each lane's own)."""
    shape = content_image.shape
    loss_fn = make_loss_fn(vgg_params, content_image, style_grams, style_weight,
                           content_weight, compute_dtype)
    start = content_image if init_pixels is None else init_pixels
    x, history = lbfgs.lbfgs_zoom(_lane_closure(loss_fn, shape),
                                  start.detach().float().reshape(shape[0], -1), steps)
    return x.reshape(shape), history if per_lane else history.mean(dim=0)


def _run_optimizer(
    optimizer: str,
    vgg_params: vgg.Params,
    content_image: torch.Tensor,
    style_grams: Mapping[str, torch.Tensor],
    steps: int,
    style_weight: float,
    content_weight: float,
    learning_rate: float = 0.05,
    compute_dtype: Optional[torch.dtype] = None,
    history_size: int = 100,
    history_math: str = "compact",
    init_pixels: Optional[torch.Tensor] = None,
    per_lane: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one optimizer-name dispatch of ``train_gatys`` and the daemon."""
    if optimizer == "adam":
        return _run_adam(vgg_params, content_image, style_grams, steps, float(style_weight),
                         float(content_weight), float(learning_rate),
                         compute_dtype=compute_dtype, init_pixels=init_pixels,
                         per_lane=per_lane)
    if optimizer == "lbfgs":
        return _run_lbfgs_torch(vgg_params, content_image, style_grams, steps,
                                float(style_weight), float(content_weight),
                                compute_dtype=compute_dtype, history_size=history_size,
                                history_math=history_math, init_pixels=init_pixels,
                                per_lane=per_lane)
    if optimizer == "lbfgs-zoom":
        return _run_lbfgs(vgg_params, content_image, style_grams, steps, float(style_weight),
                          float(content_weight), compute_dtype=compute_dtype,
                          init_pixels=init_pixels, per_lane=per_lane)
    raise ValueError(f"unknown optimizer {optimizer!r}; use one of {', '.join(OPTIMIZERS)}")


def resize(images: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize of NHWC images with antialiasing when shrinking and
    half-pixel centres (``jax.image.resize(method="linear")``)."""
    out = F.interpolate(images.permute(0, 3, 1, 2), size=(height, width), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1).contiguous()


def train_gatys(
    vgg_params: vgg.Params,
    style_image: Optional[torch.Tensor],
    content_image: torch.Tensor,
    steps: int = 550,
    style_weight: float = 100_000.0,
    content_weight: float = 1.0,
    optimizer: str = "lbfgs",
    learning_rate: float = 0.05,
    log_every: Optional[int] = 50,
    precision: str = "f32",
    history_size: int = 100,
    history_math: str = "compact",
    coarse_steps: int = 0,
    coarse_scale: float = 0.5,
    style_grams: Optional[Mapping[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, np.ndarray]:
    """Stylize ``content_image`` [N, H, W, 3] (normalized, on the VGG
    parameters' device) with the style of ``style_image`` [1, H, W, 3], or
    with ``style_grams`` (a blend or precomputed targets; ``style_image`` is
    then ignored). Returns ``(image, loss_history)``: NHWC in normalized
    space, one loss per optimizer step.

    The defaults are the reference method's (550 L-BFGS steps; the CLI
    passes 300). ``precision="bf16"`` runs the VGG tower's activations in
    bf16; pixels, Grams and the optimizer state stay f32. ``coarse_steps >
    0`` first optimizes that many steps at ``coarse_scale`` x the resolution
    (sides rounded down to a multiple of 8, at least 32), then warm-starts
    the full-resolution run from the bilinearly upsampled result; the
    content target stays the full-resolution content image."""
    logger = get_logger()
    layers.disable_tf32()
    if style_grams is None:
        style_grams = vgg.style_gram_targets(vgg_params, style_image)
    compute_dtype = torch.bfloat16 if precision == "bf16" else None

    init_pixels = None
    if coarse_steps > 0:
        n, h, w, _ = content_image.shape
        ch = max(32, int(h * coarse_scale) // 8 * 8)
        cw = max(32, int(w * coarse_scale) // 8 * 8)
        coarse_px, coarse_losses = _run_optimizer(
            optimizer, vgg_params, resize(content_image, ch, cw), style_grams, coarse_steps,
            style_weight, content_weight, learning_rate, compute_dtype=compute_dtype,
            history_size=history_size, history_math=history_math)
        init_pixels = resize(coarse_px, h, w).to(content_image.dtype)
        if log_every:
            logger.info("Gatys coarse stage (%dx%d, %d steps) final loss: %.6f",
                        ch, cw, coarse_steps, float(coarse_losses[-1]))

    pixels, history = _run_optimizer(
        optimizer, vgg_params, content_image, style_grams, steps, style_weight,
        content_weight, learning_rate, compute_dtype=compute_dtype,
        history_size=history_size, history_math=history_math, init_pixels=init_pixels)
    history = history.cpu().numpy()
    if log_every:
        for i in range(0, steps, log_every):
            logger.info("Gatys step %d  loss: %.6f", i, float(history[i]))
        logger.info("Gatys final loss: %.6f", float(history[-1]))
    return pixels, history


def parse_style_spec(spec: str, root: Optional[str] = None) -> Tuple[List[str], List[float]]:
    """STYLE spec -> (paths, normalized weights).

    ``a.png`` is one style; ``a.png,b.png[:0.3,0.7]`` asks for a blend, the
    weighted average of the styles' Gram targets (equal weights when
    omitted; normalized here). A spec that names an existing file (commas
    and colons are legal in file names; relative to ``root`` when given) is
    taken literally. Raises ValueError on a malformed spec."""
    if "," in spec or ":" in spec:
        literal = os.path.join(root, spec) if root else spec
        if os.path.isfile(literal):
            return [spec], [1.0]
    paths_part, sep, w_part = spec.partition(":")
    paths = [p for p in paths_part.split(",") if p]
    if not paths:
        raise ValueError(f"empty STYLE spec {spec!r}")
    if not sep and len(paths) == 1:
        return paths, [1.0]
    if w_part:
        try:
            ws = [float(x) for x in w_part.split(",")]
        except ValueError:
            raise ValueError(f"bad blend weights {w_part!r} (want e.g. 0.3,0.7)")
        if len(ws) != len(paths):
            raise ValueError(f"{len(paths)} style paths but {len(ws)} weights")
        total = sum(ws)
        # NaN compares False against every bound, so it is refused by name.
        if not all(map(math.isfinite, ws)) or total <= 0 or any(w < 0 for w in ws):
            raise ValueError(
                f"blend weights must be finite and >= 0 with a positive sum, got {w_part!r}")
        ws = [w / total for w in ws]
    else:
        ws = [1.0 / len(paths)] * len(paths)
    return paths, ws


def blend_grams(gram_list: Sequence[Mapping[str, torch.Tensor]],
                weights: Sequence[float]) -> Dict[str, torch.Tensor]:
    """Weighted average of per-style Gram targets (dicts by tap name)."""
    if len(gram_list) == 1 and weights[0] == 1.0:
        return dict(gram_list[0])
    return {name: sum(w * g[name] for w, g in zip(weights, gram_list)) for name in gram_list[0]}


def _run_serve_batched(
    vgg_params: vgg.Params,
    contents: torch.Tensor,
    grams: Mapping[str, torch.Tensor],
    steps: int,
    style_weight: float,
    content_weight: float,
    learning_rate: float,
    optimizer: str,
    compute_dtype: Optional[torch.dtype] = None,
    history_size: int = 100,
    history_math: str = "compact",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mixed-style batched Gatys for the daemon: lane ``i`` optimizes
    ``contents[i]`` against its OWN Gram targets ``grams[name][i]`` ([N, C,
    C] per tap), as an independent problem. Returns ``(pixels [N, H, W, 3],
    per-lane losses [N, steps])``: each response carries its own final
    loss, not the mean."""
    return _run_optimizer(optimizer, vgg_params, contents, grams, steps, style_weight,
                          content_weight, learning_rate, compute_dtype=compute_dtype,
                          history_size=history_size, history_math=history_math, per_lane=True)


def _run_serve_placed(placement, contents: torch.Tensor, grams: Mapping[str, torch.Tensor],
                      *args, **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_run_serve_batched` with the lanes split over the devices of
    ``placement`` (whose parameters are VGG's): each device optimizes its
    lanes, against their own Gram targets, with its replica. With one
    device it is :func:`_run_serve_batched` itself; with more the pixels
    and losses come back on the host."""
    if len(placement.devices) == 1:
        return _run_serve_batched(placement.params, contents, grams, *args, **kwargs)
    keys = list(grams)
    parts = [_run_serve_batched(vgg_params, lanes, dict(zip(keys, targets)), *args, **kwargs)
             for vgg_params, lanes, *targets in placement.split(contents, *grams.values())]
    return (torch.cat([p.cpu() for p, _ in parts]),
            torch.cat([losses.cpu() for _, losses in parts]))


def serve_loop(
    steps: int = 300,
    style_weight: float = 100_000.0,
    content_weight: float = 1.0,
    optimizer: str = "lbfgs",
    learning_rate: float = 0.05,
    history_size: int = 100,
    history_math: str = "compact",
    precision: str = "f32",
    size: Optional[int] = None,
    out_dir: str = "results/",
    batch: int = 1,
    vgg_params: Optional[vgg.Params] = None,
    stdin=None,
    stdout=None,
    device=constants.DEFAULT_DEVICE,
    devices: Optional[Sequence] = None,
) -> int:
    """Warm-process Gatys daemon (``gatys_st --serve``): one optimization per
    request, with the JAX daemon's protocol (``engines/daemon.py``). The
    history options apply to ``lbfgs`` only (``lbfgs-zoom`` keeps optax's
    memory of 10).

    Each request line is ``CONTENT\\tSTYLE[\\tOUTPUT]``; empty OUTPUT means
    ``{out_dir}/gatys_{content_stem}_{style_stem}.png``. STYLE may be a
    blend spec ``a.png,b.png[:0.3,0.7]`` (:func:`parse_style_spec`): the
    targets are the weighted average of the styles' Grams. Style Grams are
    LRU-cached by (path, mtime). Responses: ``READY`` once the closure has
    run at one lane and at ``batch`` lanes (which builds the kernels), then
    per request ``OK <out_path> loss=<final_loss>`` or ``ERR <input>:
    <reason>``. ``RELOAD`` and ``RESET`` answer an explanatory ``ERR``: the
    requests are stateless. The optimizer, steps and weights are fixed per
    daemon.

    ``batch > 1`` batches dynamically: the requests already queued run as
    independent lanes of one optimization (:func:`_run_serve_batched`), each
    with its own Gram targets, so a group may mix styles; each response
    carries its lane's own final loss. A lone surviving lane runs as one
    lane, and a ragged group of 2 or more runs at its own size (the JAX
    daemon pads it to its one compiled shape): under the torch-contract
    L-BFGS a padded lane costs as much as a real one. A group's lanes are
    split over ``devices`` (``mesh.serving_placement``), each device
    optimizing its own lanes with its replica of VGG
    (:func:`_run_serve_placed`)."""
    import sys
    from collections import OrderedDict

    from styletransfer_tpu_torch.engines import daemon
    from styletransfer_tpu_torch.parallel import mesh, prefetch
    from styletransfer_tpu_torch.utils import images as img_utils

    logger = get_logger()
    stdout = stdout if stdout is not None else sys.stdout
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {optimizer!r}; use one of {', '.join(OPTIMIZERS)}")
    dev = constants.resolve_device(device)
    if vgg_params is None:
        vgg_params = vgg.load_params(device=dev)
    layers.disable_tf32()
    compute_dtype = torch.bfloat16 if precision == "bf16" else None
    sz = size or constants.IMSIZE
    out_dir = os.path.join(constants.PROJECT_ROOT_PATH, out_dir)
    os.makedirs(out_dir, exist_ok=True)

    # Style Grams are pure functions of (path, mtime): a daemon serving a few
    # styles skips their VGG pass.
    gram_cache: "OrderedDict" = OrderedDict()

    def load(path):
        return prefetch.to_device(img_utils.load_image(path, size=sz), dev)

    def style_grams_cached(style_path: str):
        full = os.path.join(constants.PROJECT_ROOT_PATH, style_path)
        key = (full, os.path.getmtime(full))
        if key in gram_cache:
            gram_cache.move_to_end(key)
            return gram_cache[key]
        grams = vgg.style_gram_targets(vgg_params, load(full))
        gram_cache[key] = grams
        while len(gram_cache) > 16:
            gram_cache.popitem(last=False)
        return grams

    def style_grams_for_spec(spec: str):
        paths, ws = parse_style_spec(spec, root=constants.PROJECT_ROOT_PATH)
        return blend_grams([style_grams_cached(p) for p in paths], ws)

    def style_stem(spec: str) -> str:
        paths, ws = parse_style_spec(spec, root=constants.PROJECT_ROOT_PATH)
        stem = "+".join(os.path.splitext(os.path.basename(p))[0] for p in paths)
        if len(paths) > 1:
            # Distinct blends of the same styles must not share a default
            # output name; normalized weights collapse equivalent specs.
            stem += "_" + "_".join(f"{w:g}" for w in ws)
        return stem

    # Warm-up: the Gram pass and one step of the optimization at one lane and
    # at ``batch`` lanes, so that every kernel is built and every plan taken
    # before READY.
    t0 = time.time()
    warm = torch.zeros((1, sz, sz, 3), dtype=torch.float32, device=dev)
    warm_grams = vgg.style_gram_targets(vgg_params, warm)
    _run_optimizer(optimizer, vgg_params, warm, warm_grams, 1, style_weight, content_weight,
                   learning_rate, compute_dtype=compute_dtype, history_size=history_size,
                   history_math=history_math)[0].cpu()
    placement = mesh.serving_placement(batch, vgg_params, devices, dev)
    if batch > 1:
        _run_serve_placed(placement, warm.expand(batch, -1, -1, -1).contiguous(),
                          {k: g.expand(batch, -1, -1).contiguous()
                           for k, g in warm_grams.items()}, 1, style_weight, content_weight,
                          learning_rate, optimizer, compute_dtype=compute_dtype,
                          history_size=history_size, history_math=history_math)[0].cpu()
    logger.info("gatys serve: warmed %dpx %s %s (steps=%d, batch=%d) in %.1fs; ready", sz,
                precision, optimizer, steps, batch, time.time() - t0)
    print("READY", file=stdout, flush=True)

    def parse_and_load(fields):
        """A request line -> (content_path, style spec, explicit_out, content
        [1, H, W, 3] on the device, grams). Raises on a malformed line or an
        unreadable file."""
        if fields[0] in ("RELOAD", "RESET"):
            raise ValueError(f"the gatys daemon has no {fields[0]}: requests are stateless and "
                             "there is no checkpoint; start a new daemon to change "
                             "configuration")
        if not 2 <= len(fields) <= 3 or not fields[1]:
            raise ValueError("expected CONTENT\\tSTYLE[\\tOUTPUT]")
        content_path, style_path = fields[0], fields[1]
        content = load(os.path.join(constants.PROJECT_ROOT_PATH, content_path))
        return (content_path, style_path, fields[2] if len(fields) > 2 else "", content,
                style_grams_for_spec(style_path))

    def save_one(content_path, style_path, explicit_out, pixels, final):
        cstem = os.path.splitext(os.path.basename(content_path))[0]
        out_file = daemon.resolve_out_path(explicit_out, out_dir,
                                           f"gatys_{cstem}_{style_stem(style_path)}.png")
        img_utils.save_image(pixels, out_file)
        return f"{out_file} loss={float(final):.4f}"

    def run_one(lane):
        content_path, style_path, explicit_out, content, grams = lane
        pixels, losses = _run_optimizer(
            optimizer, vgg_params, content, grams, steps, style_weight, content_weight,
            learning_rate, compute_dtype=compute_dtype, history_size=history_size,
            history_math=history_math)
        return save_one(content_path, style_path, explicit_out, pixels.cpu().numpy(),
                        losses[-1])

    if batch == 1:
        return daemon.run_request_loop(lambda *fields: run_one(parse_and_load(fields)),
                                       stdin=stdin, stdout=stdout, name="gatys serve",
                                       device=dev)

    def handle_batch(requests):
        results: list = [None] * len(requests)
        lanes = []  # (request index, content_path, style, out, content, grams)
        for i, fields in enumerate(requests):
            try:
                lanes.append((i,) + parse_and_load(fields))
            except Exception as exc:  # noqa: BLE001 - answered per request
                results[i] = exc
        if len(lanes) == 1:
            # A lone surviving lane (a lone request, or the rest of its group
            # failed) runs as one lane.
            try:
                results[lanes[0][0]] = run_one(lanes[0][1:])
            except Exception as exc:  # noqa: BLE001 - answered per request
                results[lanes[0][0]] = exc
            return results
        if not lanes:
            return results
        try:
            pixels, losses = _run_serve_placed(
                placement, torch.cat([lane[4] for lane in lanes]),
                {k: torch.cat([lane[5][k] for lane in lanes]) for k in lanes[0][5]}, steps,
                style_weight, content_weight, learning_rate, optimizer,
                compute_dtype=compute_dtype, history_size=history_size,
                history_math=history_math)
            pixels, finals = pixels.cpu().numpy(), losses[:, -1].cpu().numpy()
        except Exception as exc:  # noqa: BLE001 - keep the parse-specific ERRs
            for lane in lanes:
                results[lane[0]] = exc
            return results
        for k, (i, content_path, style_path, explicit_out, _, _) in enumerate(lanes):
            try:
                results[i] = save_one(content_path, style_path, explicit_out,
                                      pixels[k:k + 1], finals[k])
            except Exception as exc:  # noqa: BLE001
                results[i] = exc
        return results

    return daemon.run_batched_request_loop(handle_batch, batch, stdin=stdin, stdout=stdout,
                                           name="gatys serve", device=dev)
