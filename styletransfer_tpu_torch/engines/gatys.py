"""Gatys optimization-based style transfer.

The port of ``styletransfer_tpu/engines/gatys.py`` (everything but the
serving daemon): the pixels of the content image are optimized against VGG19
Gram (style) and feature (content) losses. Each closure runs the VGG tower to
``conv3_1`` forward and backward on the stat-free 3x3 conv kernels
(``models/vgg.py``): ``conv3x3_im2col`` for ``conv1_1``, ``conv3x3_flat`` for
the other four convs and for all five input gradients.

Two optimizers:
- ``lbfgs`` (default): the torch-contract L-BFGS (``ops/lbfgs.py``): each
  step is one ``torch.optim.LBFGS.step(closure)`` with the reference's
  defaults (up to 20 fixed-step inner iterations, persistent history), so
  the CLI's ``-s 300`` makes the reference's ~6,000 closure evaluations;
- ``adam``: Adam over the pixels (optax ``adam``'s arithmetic).

A batch of N content images is N independent problems: with ``lbfgs`` each
lane has its own history, step size and breaks; its closure returns each
lane's own single-image loss and gradient (the per-lane losses are summed
for the backward, never averaged). The reported loss history is the mean
over lanes, as in the JAX engine. ``adam`` minimizes the batch's loss, the
mean over lanes, as the JAX engine does.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from styletransfer_tpu_torch.models import vgg
from styletransfer_tpu_torch.ops import layers, losses, lbfgs
from styletransfer_tpu_torch.utils.logging import get_logger

OPTIMIZERS = ("adam", "lbfgs")

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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Adam over the pixels from the content image (or ``init_pixels``);
    returns ``(pixels, losses [steps])``, the loss before each update."""
    loss_fn = make_loss_fn(vgg_params, content_image, style_grams, style_weight,
                           content_weight, compute_dtype)
    start = content_image if init_pixels is None else init_pixels
    pixels = start.detach().float().clone().requires_grad_()
    opt = torch.optim.Adam([pixels], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    history = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(pixels).mean()
        loss.backward()
        opt.step()
        history.append(loss.detach())
    return pixels.detach(), torch.stack(history) if history else pixels.new_zeros(0)


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``steps`` torch-LBFGS ``.step(closure)`` calls over the pixels, one
    independent optimizer per image of ``content_image`` [N, H, W, 3].
    Returns ``(pixels, losses [steps])``, the losses averaged over lanes."""
    shape = content_image.shape
    n_lanes = shape[0]
    loss_fn = make_loss_fn(vgg_params, content_image, style_grams, style_weight,
                           content_weight, compute_dtype)

    def loss_and_grad(x_flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        global closure_evals
        x = x_flat.detach().reshape(shape).requires_grad_()
        with torch.enable_grad():
            lane_losses = loss_fn(x)
            (grad,) = torch.autograd.grad(lane_losses.sum(), x)
        closure_evals += 1
        return lane_losses.detach(), grad.reshape(n_lanes, -1)

    start = content_image if init_pixels is None else init_pixels
    x, history = lbfgs.lbfgs_torch(
        loss_and_grad, start.detach().float().reshape(n_lanes, -1), steps,
        max_iter=max_iter, history_size=history_size, history_math=history_math)
    return x.reshape(shape), history.mean(dim=0)


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one optimizer-name dispatch of ``train_gatys``."""
    if optimizer == "adam":
        return _run_adam(vgg_params, content_image, style_grams, steps, float(style_weight),
                         float(content_weight), float(learning_rate),
                         compute_dtype=compute_dtype, init_pixels=init_pixels)
    if optimizer == "lbfgs":
        return _run_lbfgs_torch(vgg_params, content_image, style_grams, steps,
                                float(style_weight), float(content_weight),
                                compute_dtype=compute_dtype, history_size=history_size,
                                history_math=history_math, init_pixels=init_pixels)
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
