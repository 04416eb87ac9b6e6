"""Multi-style fast transfer: one net, S styles.

The port of ``styletransfer_tpu/engines/multistyle.py``.

Training (``train``, the work of ``fast_st train-multi``): each image of a
batch draws a style index, ``np.random.default_rng(seed).integers(0, S, B)``
per batch as the JAX trainer draws them, and the style loss holds each
image's Grams to its own style's targets. The forward is the stacked one
with each image's affines gathered from the [S, C] parameters
(``models/multistyle.py``), so every instance norm runs on the fused-IN
kernels with [B, C] affines and returns [B, C] dscale and dbias, which the
gather adds into each style's rows. The loop, Adam, checkpoints and step
states are ``engines/fast.py``'s (``train_loop``), under the model name
``fast_multi_st``; checkpoints hold every affine as [S, C], the JAX layout.
Distributed, every rank draws the global batch's indices from the one seed
and takes its slice's rows, so the global batch trains the schedule of one
process; the [S, C] affines' gradients go through the step's one
all-reduce with the rest.

Inference: ``stylize`` (a style index per image), ``stylize_blend``
(per-image convex blends of the styles) and the request parser
``_make_style_parser``, :func:`process_image` (``convert-image-multi``) and
:func:`serve_loop` (``serve-multi``). Both forwards are
``models/multistyle.py`` on the serving kernels, the per-image affines going
to the IN-pad kernel as they are.
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from styletransfer_tpu_torch import ckpt, constants
from styletransfer_tpu_torch.data import coco
from styletransfer_tpu_torch.engines import daemon, fast
from styletransfer_tpu_torch.engines.fast import _compute_dtype
from styletransfer_tpu_torch.models import multistyle, transformer, vgg
from styletransfer_tpu_torch.ops import layers, losses
from styletransfer_tpu_torch.parallel import distributed
from styletransfer_tpu_torch.parallel import mesh as mesh_lib
from styletransfer_tpu_torch.utils import images as img_utils
from styletransfer_tpu_torch.utils import tb
from styletransfer_tpu_torch.utils.logging import get_logger

MODEL_NAME = "fast_multi_st"


def stack_style_grams(vgg_params: vgg.Params, style_images: torch.Tensor,
                      compute_dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """Per-tap Gram targets of a stack of style images [S, H, W, 3] (normalized):
    {tap: [S, C, C]}."""
    return vgg.style_gram_targets(vgg_params, style_images, compute_dtype=compute_dtype)


def _targets(style_grams: Mapping[str, torch.Tensor], idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Each image's own style's Gram targets: {tap: [B, C, C]}."""
    return {name: g[idx] for name, g in style_grams.items()}


def multistyle_loss(
    params: transformer.TransformerNet,
    batch: torch.Tensor,
    style_idx,
    vgg_params: vgg.Params,
    style_grams: Mapping[str, torch.Tensor],
    style_weight: float,
    content_weight: float,
    compute_dtype: Optional[torch.dtype] = None,
    shards: Optional[distributed.GlobalBatch] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The perceptual objective with a style index per image [B]: style
    (each image against its style's Grams) + content + total variation.
    Returns ``(total, {"total", "style", "content", "tv"})``; with
    ``shards``, this rank's share of the global batch's (``fast.loss_fn``)."""
    batch = img_utils.maybe_normalize_on_device(batch)
    idx = multistyle.style_index(style_idx, batch.device)
    transformed = multistyle.apply_stacked(params, batch, idx, compute_dtype)
    perceptual, comps = vgg.perceptual_loss(
        vgg_params, transformed, batch, _targets(style_grams, idx),
        style_weight=style_weight, content_weight=content_weight,
        compute_dtype=compute_dtype,
    )
    tv = losses.total_variation_loss(transformed)
    if shards is not None:
        tv = tv * shards.world  # a sum over the batch (fast.loss_fn)
    total = perceptual + tv
    return total, {"total": total, "style": comps["style"], "content": comps["content"],
                   "tv": tv}


def make_train_step(
    vgg_params: vgg.Params,
    style_grams: Mapping[str, torch.Tensor],
    style_weight: float = 100_000.0,
    content_weight: float = 1.0,
    compute_dtype: Optional[torch.dtype] = None,
    remat: bool = False,
    shards: Optional[distributed.GlobalBatch] = None,
) -> Callable:
    """``train_step(params, optimizer, batch, style_idx) -> metrics``: one
    forward, backward and Adam update of :func:`multistyle_loss`
    (``fast.make_step``, with its ``shards``)."""
    def objective(params, batch, style_idx):
        return multistyle_loss(params, batch, style_idx, vgg_params, style_grams, style_weight,
                               content_weight, compute_dtype, shards)

    return fast.make_step(objective, remat, shards)


def make_eval_step(
    vgg_params: vgg.Params,
    style_grams: Mapping[str, torch.Tensor],
    style_weight: float = 100_000.0,
    feature_weight: float = 1.0,
    compute_dtype: Optional[torch.dtype] = None,
    shards: Optional[distributed.GlobalBatch] = None,
) -> Callable:
    """``eval_step(params, batch, style_idx) -> loss``: style + feature loss
    of the clamped stylized batch (``fast.eval_loss``, with its ``shards``),
    each image against its own style's Grams."""
    layers.disable_tf32()

    @torch.no_grad()
    def eval_step(params: transformer.TransformerNet, batch: torch.Tensor,
                  style_idx) -> torch.Tensor:
        batch = img_utils.maybe_normalize_on_device(batch)
        idx = multistyle.style_index(style_idx, batch.device)
        transformed = multistyle.apply_stacked(params, batch, idx, compute_dtype)
        return fast.eval_loss(vgg_params, transformed, batch, _targets(style_grams, idx),
                              style_weight, feature_weight, compute_dtype, shards)

    return eval_step


def train(
    style_images,
    style_name: str = "multi",
    epochs: int = 50,
    batch_size: int = 4,
    style_weight: float = 100_000.0,
    content_weight: float = 1.0,
    vgg_params: Optional[vgg.Params] = None,
    params: Optional[transformer.TransformerNet] = None,
    train_loader=None,
    test_loader=None,
    seed: int = 0,
    log_cadence: Tuple[int, int, int] = (20, 50, 150),
    runs_dir: Optional[str] = None,
    models_path: Optional[str] = None,
    max_steps_per_epoch: Optional[int] = None,
    step_checkpoint_every: Optional[int] = None,
    precision: str = "f32",
    device=constants.DEFAULT_DEVICE,
) -> transformer.TransformerNet:
    """Train one net on a stack of styles ``style_images`` [S, H, W, 3]
    (normalized; numpy or tensor) and return the trained parameters.

    Each image of a batch draws a uniform style index per step from
    ``np.random.default_rng(seed)``, as the JAX trainer does, so one seed
    trains the same schedule in both packages. The eval holds image b to
    style ``b % S``; the preview stylizes with style ``iteration % S`` on the
    serving forward. Epochs, checkpoints (``fast_multi_st_{style_name}``),
    step states and resume are ``fast.train_loop``'s. Distributed,
    ``batch_size`` is the global batch (``fast.static_train``)."""
    logger = get_logger()
    dev = constants.resolve_device(device)
    rank, world = distributed.process_info()
    shards = distributed.global_batch()
    mesh_lib.warn_single_process_training(dev, world)
    compute_dtype = _compute_dtype(precision)
    writer = tb.get_tensorboard_writer(runs_dir or os.path.join(
        constants.PROJECT_ROOT_PATH, constants.RUNS_PATH,
        f"fast-image-style-transfer-multi_{style_name}"))

    if vgg_params is None:
        vgg_params = vgg.load_params(device=dev)
    styles = torch.as_tensor(style_images, dtype=torch.float32).to(dev)
    n_styles = styles.shape[0]
    grams = stack_style_grams(vgg_params, styles)
    if params is None:
        params = multistyle.init_params(seed, num_styles=n_styles, device=dev)
    step = make_train_step(vgg_params, grams, style_weight, content_weight, compute_dtype,
                           shards=shards)
    eval_step = make_eval_step(vgg_params, grams, style_weight, compute_dtype=compute_dtype,
                               shards=shards)
    if train_loader is None or test_loader is None:
        test_loader, train_loader = coco.get_coco_loader(
            batch_size=distributed.local_batch_size(batch_size), test_split=0.10,
            test_limit=20, seed=seed, shard_index=rank, shard_count=world)
    logger.info("Training fast_multi_st (%d styles) with Adam on %s (%s, %d process(es))",
                n_styles, dev, precision, world)
    rng = np.random.default_rng(seed)

    def train_step(params, optimizer, batch):
        # The global batch's draw, of which this rank's slice holds rows
        # [rank * b, (rank + 1) * b).
        b = batch.shape[0]
        idx = rng.integers(0, n_styles, b * world)[rank * b:(rank + 1) * b]
        # On the batch's device, so that the step's CUDA graph takes it.
        return step(params, optimizer, batch, multistyle.style_index(idx, batch.device))

    def eval_step_rr(params, batch):
        # Round robin over the global batch, so that every style is
        # evaluated on each pass.
        b = batch.shape[0]
        return eval_step(params, batch, np.arange(rank * b, (rank + 1) * b) % n_styles)

    def preview(params, batch, iteration):
        preview_in = img_utils.maybe_normalize_on_device(batch[:1])
        return stylize(params, preview_in, [iteration % n_styles], compute_dtype), preview_in

    return fast.train_loop(
        params, train_step,
        lambda p: fast.static_test(p, test_loader, eval_step_rr, dev, shards),
        preview, lambda tree: multistyle.params_from_jax(tree, device=dev), MODEL_NAME,
        style_name, train_loader, writer, epochs, batch_size, log_cadence, models_path,
        max_steps_per_epoch, step_checkpoint_every, dev,
        start_message=f"Starting multi-style epoch %d ({n_styles} styles)")


def stylize(params: transformer.TransformerNet, images: torch.Tensor, style_idx: torch.Tensor,
            compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Stylize a batch with a hard style choice per image."""
    return multistyle.apply(params, images, style_idx, compute_dtype)


def stylize_blend(params: transformer.TransformerNet, images: torch.Tensor,
                  weights: torch.Tensor,
                  compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Stylize a batch with per-image convex style blends [B, S]."""
    return multistyle.apply_blend(params, images, weights, compute_dtype)


def _blend_weights(spec: str, num_styles: int) -> np.ndarray:
    """Comma-separated blend weights -> [num_styles] convex weights. They
    must be finite, non-negative, ``num_styles`` of them, with a positive
    sum; they are normalized. Raises ValueError."""
    w = np.asarray([float(v) for v in spec.split(",")], np.float32)
    if w.shape[0] != num_styles:
        raise ValueError(f"expected {num_styles} blend weights, got {w.shape[0]}")
    # NaN compares False against everything: 'nan,1' would pass the other
    # two checks and serve an all-NaN blend.
    if not np.isfinite(w).all() or w.min() < 0 or w.sum() <= 0:
        raise ValueError("blend weights must be finite and non-negative with a positive sum")
    return w / w.sum()


def _make_style_parser(num_styles: int) -> Callable[[Optional[str]], Tuple[np.ndarray, str]]:
    """A STYLE spec (an index, or comma-separated blend weights) ->
    ([num_styles] convex weights, filename tag): the weights as
    :func:`_blend_weights` takes them; an index must lie in [0,
    num_styles). Raises ValueError."""

    def parse_style(style_spec):
        style_spec = style_spec or "0"
        if "," in style_spec:
            w = _blend_weights(style_spec, num_styles)
            return w, "blend_" + "_".join(f"{v:g}" for v in w)
        idx = int(style_spec)
        if not 0 <= idx < num_styles:
            raise ValueError(f"style index {idx} out of range [0, {num_styles})")
        w = np.zeros((num_styles,), np.float32)
        w[idx] = 1.0
        return w, f"style{idx}"

    return parse_style


def load_params(name: str, num_styles: int, models_path: Optional[str] = None,
                device=constants.DEFAULT_DEVICE) -> transformer.TransformerNet:
    """The latest ``fast_multi_st_{name}`` checkpoint (one the JAX or the
    port's trainer wrote), held to a ``num_styles`` template."""
    template = multistyle.init_params(0, num_styles, device="cpu")
    params, _ = ckpt.load_latest_transformer(MODEL_NAME, name, models_path, device=device,
                                             template=template)
    return params


def process_image(
    image_path: str,
    name: str,
    num_styles: int,
    style_index: int = 0,
    blend: Optional[str] = None,
    out_dir: str = "results/",
    params: Optional[transformer.TransformerNet] = None,
    models_path: Optional[str] = None,
    precision: str = "f32",
    device=constants.DEFAULT_DEVICE,
) -> str:
    """Stylize one image with the latest multi-style weights of ``name``,
    by ``style_index`` or by ``blend`` (comma-separated weights, normalized;
    it overrides the index), as ``convert-image-multi`` does. Writes and
    returns ``{out_dir}/converted_fast_multi_st_{name}_{tag}.png`` (tag
    ``style{i}`` or ``blend``). Raises ValueError on an index out of range
    or weights that :func:`_blend_weights` refuses."""
    dev = constants.resolve_device(device)
    if params is None:
        params = load_params(name, num_styles, models_path, dev)
    if multistyle.num_styles(params) != num_styles:
        raise ValueError(f"the parameters hold {multistyle.num_styles(params)} styles, "
                         f"not {num_styles}")
    layers.disable_tf32()
    img = torch.from_numpy(img_utils.load_image(
        os.path.join(constants.PROJECT_ROOT_PATH, image_path))).to(dev)
    cd = _compute_dtype(precision)
    if blend:
        w = _blend_weights(blend, num_styles)
        out = stylize_blend(params, img, torch.from_numpy(w)[None].to(dev), cd)
        tag = "blend"
    else:
        _make_style_parser(num_styles)(str(style_index))
        out = stylize(params, img, torch.tensor([style_index], device=dev), cd)
        tag = f"style{style_index}"
    out_dir = os.path.join(constants.PROJECT_ROOT_PATH, out_dir)
    os.makedirs(out_dir, exist_ok=True)
    out_file = os.path.join(out_dir, f"converted_fast_multi_st_{name}_{tag}.png")
    img_utils.save_image(out.float().cpu().numpy(), out_file)
    get_logger().info("Saved stylized image to %s", out_file)
    return out_file


def serve_loop(
    name: str,
    num_styles: int,
    out_dir: str = "results/",
    params: Optional[transformer.TransformerNet] = None,
    models_path: Optional[str] = None,
    size: Optional[int] = None,
    precision: str = "f32",
    batch_size: int = 1,
    sizes: Optional[Sequence[int]] = None,
    stdin=None,
    stdout=None,
    device=constants.DEFAULT_DEVICE,
    devices: Optional[Sequence] = None,
) -> int:
    """Warm-process multi-style serving (``fast_st serve-multi``): every
    request picks its own style, an index or a blend, as data.

    The protocol is ``fast.serve_loop``'s with one more field:
    ``INPUT[\\tOUTPUT[\\tSTYLE[\\tSIZE]]]``, STYLE an index (``2``) or
    comma-separated blend weights (``0.3,0.7``, normalized; absent: style 0),
    checked by :func:`_make_style_parser`; the default OUTPUT is
    ``{out_dir}/converted_fast_multi_st_{name}_{stem}_{tag}.png``. Each
    style travels as a row of [B, S] blend weights (an index is its one-hot
    row) through ``apply_blend``, so a batched group that mixes indices and
    blends is one device call per bucket, split with its images over
    ``devices`` (``mesh.serving_placement``; ``RELOAD`` replaces every
    replica). Returns the number served."""
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    dev = constants.resolve_device(device)
    stdout = stdout if stdout is not None else sys.stdout
    if params is None:
        params = load_params(name, num_styles, models_path, dev)
    if multistyle.num_styles(params) != num_styles:
        raise ValueError(f"the parameters hold {multistyle.num_styles(params)} styles, "
                         f"not {num_styles}")
    cd = _compute_dtype(precision)
    layers.disable_tf32()

    def serve_fn(params, batch_u8, weights):
        x = img_utils.maybe_normalize_on_device(batch_u8)
        return img_utils.to_uint8_on_device(multistyle.apply_blend(params, x, weights, cd))

    buckets = daemon.normalize_buckets(sizes, size or constants.IMSIZE)
    out_dir = os.path.join(constants.PROJECT_ROOT_PATH, out_dir)
    os.makedirs(out_dir, exist_ok=True)
    placement = mesh_lib.serving_placement(batch_size, params, devices, dev)
    warm_w = torch.zeros((batch_size, num_styles), device=dev)
    warm_w[:, 0] = 1.0
    fast.warm_buckets(lambda b: placement.run(serve_fn, b, warm_w), buckets, batch_size,
                      dev, "multi serve")
    print("READY", file=stdout, flush=True)
    resolve_bucket = fast.bucket_resolver(buckets, 3, "INPUT[\\tOUTPUT[\\tSTYLE[\\tSIZE]]]")
    parse_style = _make_style_parser(num_styles)

    def reload():
        new, epoch = ckpt.load_latest_transformer(MODEL_NAME, name, models_path, device=dev,
                                                  template=placement.params)
        placement.place_params(new)
        return f"RELOAD epoch={epoch}"

    def save_one(in_path, explicit_out, tag, img):
        stem = os.path.splitext(os.path.basename(in_path))[0]
        out_file = daemon.resolve_out_path(
            explicit_out, out_dir, f"converted_fast_multi_st_{name}_{stem}_{tag}.png")
        img_utils.save_uint8(img, out_file)
        return out_file

    def load(in_path, bucket):
        return img_utils.load_image_uint8(
            os.path.join(constants.PROJECT_ROOT_PATH, in_path), size=bucket)

    if batch_size == 1:
        def handle(*fields):
            bucket = resolve_bucket(fields)
            w, tag = parse_style(fields[2] if len(fields) > 2 else "0")
            in_u8 = torch.from_numpy(np.array(load(fields[0], bucket))).to(dev)
            out_u8 = serve_fn(placement.params, in_u8,
                              torch.from_numpy(w)[None].to(dev)).cpu().numpy()[0]
            return save_one(fields[0], fields[1] if len(fields) > 1 else "", tag, out_u8)

        return daemon.run_request_loop(handle, stdin=stdin, stdout=stdout, name="multi serve",
                                       commands={"RELOAD": reload}, device=dev)

    def decode(i, fields):
        try:
            bucket = resolve_bucket(fields)
            w, tag = parse_style(fields[2] if len(fields) > 2 else "0")
            meta = (i, fields[0], fields[1] if len(fields) > 1 else "", tag, w,
                    load(fields[0], bucket)[0])
            return i, bucket, meta, None
        except Exception as exc:  # noqa: BLE001 - answered per request
            return i, None, None, exc

    def launch(bucket, metas):
        return placement.run(serve_fn, fast.pad_group([m[5] for m in metas], batch_size),
                             fast.pad_group([m[4] for m in metas], batch_size))

    def save(meta, img):
        return save_one(meta[1], meta[2], meta[3], img)

    submit_segment = daemon.make_pooled_segment_submit(decode, launch, save)
    return daemon.run_batched_request_loop(
        None, batch_size, stdin=stdin, stdout=stdout, name="multi serve",
        submit_batch=daemon.segmented_submit_batch(submit_segment, {"RELOAD": reload}),
        device=dev)
