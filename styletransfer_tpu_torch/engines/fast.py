"""Fast (feed-forward) style transfer: training, eval and inference.

The port of ``styletransfer_tpu/engines/fast.py``.

Training (``static_train``): the transform net's stacked forward
(``transformer.apply_stacked``, every instance norm on the fused-IN kernels
and their backward), the VGG perceptual loss and total variation, autograd,
and ``torch.optim.Adam`` (optax ``adam``'s arithmetic). Params, gradients
and Adam state stay f32 under ``precision="bf16"``, which runs only the
activations in bf16. Host work per step is feeding the next batch (decoded
on threads, copied ahead by ``parallel.prefetch``) and reading the loss back
on the logging cadence. The reference's cadences and TensorBoard tags are
kept: the loss every 20 steps (``data/fst_train_loss``), a preview every 50
(``data/fst_images``), the eval every 150 (``data/fst_test_loss``).

Inference: ``make_serve_fn`` (uint8 in, uint8 out, the normalize and
denormalize steps on the device, the pad-early forward on the serving
kernels), ``process_image`` and ``process_dir``. Inputs are decoded on the
host with PIL and moved to the device as uint8.
"""

from __future__ import annotations

import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.utils import checkpoint as torch_checkpoint

from styletransfer_tpu_torch import ckpt, constants
from styletransfer_tpu_torch.data import coco
from styletransfer_tpu_torch.models import transformer, vgg
from styletransfer_tpu_torch.ops import layers, losses
from styletransfer_tpu_torch.parallel import prefetch
from styletransfer_tpu_torch.utils import images as img_utils
from styletransfer_tpu_torch.utils import tb
from styletransfer_tpu_torch.utils.logging import get_logger

MODEL_NAME = "fast_st"

# torch Adam's defaults, which the reference uses: lr 1e-3, betas
# (0.9, 0.999), eps 1e-8 (added outside the square root, after the bias
# correction of both moments, as in optax's adam).
ADAM_LR = 1e-3

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")

# Decoded batches in flight or buffered at once in process_dir.
PREFETCH_BATCHES = 4

_PRECISIONS = {"f32": None, "bf16": torch.bfloat16}


def _compute_dtype(precision: str) -> Optional[torch.dtype]:
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be 'f32' or 'bf16', got {precision!r}")
    return _PRECISIONS[precision]


def make_optimizer(params: transformer.TransformerNet,
                   learning_rate: float = ADAM_LR) -> torch.optim.Adam:
    return torch.optim.Adam(params.parameters(), lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8)


def loss_fn(
    params: transformer.TransformerNet,
    batch: torch.Tensor,
    vgg_params: vgg.Params,
    style_grams: Mapping[str, torch.Tensor],
    style_weight: float,
    content_weight: float,
    compute_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The perceptual training objective: style + content + total variation
    of the stylized batch. Returns ``(total, {"total", "style", "content",
    "tv"})``."""
    batch = img_utils.maybe_normalize_on_device(batch)
    transformed = transformer.apply_stacked(params, batch, compute_dtype)
    perceptual, comps = vgg.perceptual_loss(
        vgg_params, transformed, batch, style_grams,
        style_weight=style_weight, content_weight=content_weight,
        compute_dtype=compute_dtype,
    )
    tv = losses.total_variation_loss(transformed)
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
) -> Callable:
    """``train_step(params, optimizer, batch) -> metrics``: one forward,
    backward and Adam update, in place on ``params``. The metrics are
    detached 0-d tensors on the device (reading one waits for the step).

    ``remat=True`` checkpoints the loss (``torch.utils.checkpoint``): the
    backward recomputes the forward's activations instead of keeping them,
    about a third more work for much less memory. The recomputation runs the
    instance-norm forward kernels a second time."""
    layers.disable_tf32()

    def objective(params, batch):
        return loss_fn(params, batch, vgg_params, style_grams, style_weight, content_weight,
                       compute_dtype)

    def train_step(params: transformer.TransformerNet, optimizer: torch.optim.Optimizer,
                   batch: torch.Tensor) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        if remat:
            total, metrics = torch_checkpoint.checkpoint(objective, params, batch,
                                                         use_reentrant=False)
        else:
            total, metrics = objective(params, batch)
        total.backward()
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_eval_step(
    vgg_params: vgg.Params,
    style_grams: Mapping[str, torch.Tensor],
    style_weight: float = 100_000.0,
    feature_weight: float = 1.0,
    compute_dtype: Optional[torch.dtype] = None,
) -> Callable:
    """``eval_step(params, batch) -> loss``: style + feature loss of the
    stylized batch, with the reference's quirk of clamping the
    ImageNet-normalized output to [0, 255] (which only removes negatives)
    before the losses."""
    layers.disable_tf32()

    @torch.no_grad()
    def eval_step(params: transformer.TransformerNet, batch: torch.Tensor) -> torch.Tensor:
        batch = img_utils.maybe_normalize_on_device(batch)
        transformed = transformer.apply_stacked(params, batch, compute_dtype)
        clamped = torch.clamp(transformed, 0.0, 255.0)
        feats = vgg.extract_features(vgg_params, clamped, tuple(style_grams), compute_dtype)
        s_loss = sum(losses.style_loss(feats[name], tgt) for name, tgt in style_grams.items())
        f_loss = vgg.feature_loss(vgg_params, clamped, batch, compute_dtype=compute_dtype)
        return style_weight * s_loss + feature_weight * f_loss

    return eval_step


def static_test(params: transformer.TransformerNet, test_loader, eval_step: Callable,
                device) -> float:
    """Mean eval loss over the test loader."""
    total = [float(eval_step(params, prefetch.to_device(batch, torch.device(device))))
             for batch in test_loader]
    avg = float(np.mean(total)) if total else float("nan")
    get_logger().info("Average test loss: %.8f", avg)
    return avg


def static_train(
    style_image,
    style_name: str = "nsp",
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
    """Train the fast transform net on ``style_image`` ([1, H, W, 3],
    normalized; numpy or tensor) and return the trained parameters.

    Keeps the reference's epoch-checkpoint contract: an epoch whose
    checkpoint exists is skipped and its weights loaded (the Adam state
    starts anew, as in the JAX trainer). With ``step_checkpoint_every`` a
    step state (params, Adam state, epoch and batch position) is also saved
    every N steps and after each epoch; a restart resumes from it with the
    loader fast-forwarded, so no trained batch is replayed.
    ``precision="bf16"`` runs the activations of the transform net and VGG
    in bf16; params, gradients, Adam state and loss reductions stay f32."""
    logger = get_logger()
    dev = constants.resolve_device(device)
    compute_dtype = _compute_dtype(precision)
    scalar_every, image_every, eval_every = log_cadence
    writer = tb.get_tensorboard_writer(runs_dir or os.path.join(
        constants.PROJECT_ROOT_PATH, constants.RUNS_PATH,
        f"fast-image-style-transfer-still-image_{style_name}"))

    if vgg_params is None:
        vgg_params = vgg.load_params(device=dev)
    style = torch.as_tensor(style_image, dtype=torch.float32).to(dev)
    style_grams = vgg.style_gram_targets(vgg_params, style)
    if params is None:
        params = transformer.init_params(seed, device=dev)
    optimizer = make_optimizer(params)
    train_step = make_train_step(vgg_params, style_grams, style_weight, content_weight,
                                 compute_dtype)
    eval_step = make_eval_step(vgg_params, style_grams, style_weight,
                               compute_dtype=compute_dtype)
    if train_loader is None or test_loader is None:
        test_loader, train_loader = coco.get_coco_loader(
            batch_size=batch_size, test_split=0.10, test_limit=20, seed=seed)
    logger.info("Training fast_st with Adam on %s (%s)", dev, precision)

    iteration = 0
    start_epoch = 0
    resume_batches = 0
    if step_checkpoint_every:
        state = ckpt.load_step_state(MODEL_NAME, style_name, models_path,
                                     extra_keys=("batch_in_epoch",))
        if state is not None:
            params = transformer.params_from_jax(state["params"], device=dev)
            optimizer = make_optimizer(params)
            ckpt.adam_state_from_tree(params, optimizer, state["opt_state"])
            start_epoch = state["epoch"]
            iteration = state["iteration"]
            resume_batches = state["extra"]["batch_in_epoch"]
            if resume_batches:
                # Fast-forward the loader to where the stopped run was.
                train_loader.set_position(start_epoch, resume_batches)
            if start_epoch >= epochs:
                logger.warning(
                    "Step state is at epoch %d >= requested epochs %d: nothing to train. "
                    "Delete %s to retrain from scratch.", start_epoch, epochs,
                    ckpt.step_state_path(MODEL_NAME, style_name, models_path))

    for epoch in range(start_epoch, epochs):
        done = ckpt.existing_checkpoint_path(MODEL_NAME, style_name, epoch, models_path)
        if done is not None:
            # This epoch's own file: the latest overall could be a later one.
            params = transformer.params_from_jax(ckpt.load(done), device=dev)
            optimizer = make_optimizer(params)
            logger.info("Epoch %d checkpoint exists; skipping", epoch)
            continue

        logger.info("Starting epoch %d", epoch)
        t0 = time.time()
        n_in_epoch = 0
        epoch_offset = resume_batches if epoch == start_epoch else 0
        resume_batches = 0
        batches = prefetch.prefetch_to_device(train_loader, dev)
        try:
            for batch in batches:
                metrics = train_step(params, optimizer, batch)
                if iteration % scalar_every == 0:
                    total = float(metrics["total"])
                    writer.add_scalar("data/fst_train_loss", total, iteration)
                    logger.info("Batch Loss: %.8f", total)
                if iteration % eval_every == 0:
                    avg = static_test(params, test_loader, eval_step, dev)
                    writer.add_scalar("data/fst_test_loss", avg, iteration)
                if iteration % image_every == 0:
                    with torch.no_grad():
                        preview_in = img_utils.maybe_normalize_on_device(batch[:1])
                        preview = transformer.apply_stacked(params, preview_in, compute_dtype)
                    pair = img_utils.concat_images(
                        img_utils.to_uint8(preview.float().cpu().numpy()),
                        img_utils.to_uint8(preview_in.float().cpu().numpy()),
                        axis=1,
                    )
                    writer.add_image("data/fst_images", pair, iteration)
                iteration += 1
                n_in_epoch += 1
                if step_checkpoint_every and iteration % step_checkpoint_every == 0:
                    ckpt.save_step_state(
                        params, ckpt.adam_state_to_tree(params, optimizer), epoch, iteration,
                        MODEL_NAME, style_name, models_path,
                        extra={"batch_in_epoch": epoch_offset + n_in_epoch})
                if max_steps_per_epoch and n_in_epoch >= max_steps_per_epoch:
                    break
        finally:
            batches.close()

        dt = time.time() - t0
        if n_in_epoch:
            logger.info("Epoch %d: %d steps in %.1fs (%.2f img/s)",
                        epoch, n_in_epoch, dt, n_in_epoch * batch_size / dt)
        ckpt.save_epoch(params, MODEL_NAME, style_name, epoch, models_path)
        if step_checkpoint_every:
            # Keep the step state ahead of the epoch checkpoint, so a restart
            # right after an epoch resumes with the current Adam moments.
            ckpt.save_step_state(
                params, ckpt.adam_state_to_tree(params, optimizer), epoch + 1, iteration,
                MODEL_NAME, style_name, models_path, extra={"batch_in_epoch": 0})

    writer.close()
    return params


def make_serve_fn(precision: str = "f32", pad_mode: str = "reflect") -> Callable:
    """The uint8-in / uint8-out serving forward: ``serve_fn(params, batch_u8)``
    with ``batch_u8`` [B, H, W, 3] uint8 on the params' device.

    f32 runs in full f32: TF32 is switched off for cuDNN convs and matmuls
    (both default differently), so the output stays within 1/255 of the
    f32 reference. ``pad_mode="zeros"`` serves checkpoints that the original
    reference trained (see ``transformer.apply``)."""
    compute_dtype = _compute_dtype(precision)
    if pad_mode not in ("reflect", "zeros"):
        raise ValueError(f"pad_mode must be 'reflect' or 'zeros', got {pad_mode!r}")
    layers.disable_tf32()

    def serve_fn(params: transformer.TransformerNet, batch_u8: torch.Tensor) -> torch.Tensor:
        x = img_utils.maybe_normalize_on_device(batch_u8)
        y = transformer.apply(params, x, compute_dtype=compute_dtype, pad_mode=pad_mode)
        return img_utils.to_uint8_on_device(y)

    return serve_fn


def _load_params(params, style_name, models_path, device):
    if params is None:
        params, _ = ckpt.load_latest_transformer(MODEL_NAME, style_name, models_path, device)
    return params


def process_image(
    image_path: str,
    style_name: str = "nsp",
    out_dir: str = "results/",
    params: Optional[transformer.TransformerNet] = None,
    models_path: Optional[str] = None,
    size: Optional[int] = None,
    precision: str = "f32",
    pad_mode: str = "reflect",
    device=constants.DEFAULT_DEVICE,
) -> str:
    """Stylize one image with the latest trained weights for ``style_name``
    (or ``params``). Returns the output path
    (``{out_dir}/converted_fast_st_{style}.png``)."""
    dev = constants.resolve_device(device)
    params = _load_params(params, style_name, models_path, dev)
    input_u8 = img_utils.load_image_uint8(
        os.path.join(constants.PROJECT_ROOT_PATH, image_path),
        size=size or constants.IMSIZE,
    )
    serve_fn = make_serve_fn(precision, pad_mode)
    out_u8 = serve_fn(params, torch.from_numpy(np.array(input_u8)).to(dev)).cpu().numpy()[0]

    out_dir = os.path.join(constants.PROJECT_ROOT_PATH, out_dir)
    os.makedirs(out_dir, exist_ok=True)
    out_file = os.path.join(out_dir, f"converted_fast_st_{style_name}.png")
    img_utils.save_uint8(out_u8, out_file)
    get_logger().info("Saved stylized image to %s", out_file)
    return out_file


def process_dir(
    input_dir: str,
    style_name: str,
    out_dir: str = "results/",
    batch_size: int = 64,
    params: Optional[transformer.TransformerNet] = None,
    models_path: Optional[str] = None,
    size: Optional[int] = None,
    precision: str = "f32",
    pad_mode: str = "reflect",
    device=constants.DEFAULT_DEVICE,
) -> List[str]:
    """Stylize every image in a directory with batched inference.

    One checkpoint load, threaded host decode of up to ``PREFETCH_BATCHES``
    batches ahead of the device, uint8 both ways. Unreadable files are
    skipped with a warning. Outputs are
    ``{out_dir}/converted_fast_st_{style}_{stem}.png``; returns their paths.
    """
    dev = constants.resolve_device(device)
    logger = get_logger()
    in_dir = os.path.join(constants.PROJECT_ROOT_PATH, input_dir)
    files = sorted(f for f in os.listdir(in_dir) if f.lower().endswith(IMAGE_EXTS))
    if not files:
        raise FileNotFoundError(f"No images ({'/'.join(IMAGE_EXTS)}) in {in_dir}")
    params = _load_params(params, style_name, models_path, dev)
    serve_fn = make_serve_fn(precision, pad_mode)
    sz = size or constants.IMSIZE
    out_dir = os.path.join(constants.PROJECT_ROOT_PATH, out_dir)
    os.makedirs(out_dir, exist_ok=True)

    def decode(name):
        try:
            return name, img_utils.load_image_uint8(os.path.join(in_dir, name), size=sz)[0]
        except Exception as exc:  # noqa: BLE001 - skip-and-continue contract
            logger.warning("Skipping unreadable image %s (%s)", name, exc)
            return name, None

    def decode_batch(chunk):
        return [decode(n) for n in chunk]

    batches = [files[i:i + batch_size] for i in range(0, len(files), batch_size)]
    out_paths: List[str] = []
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=8) as pool:
        pending = deque(pool.submit(decode_batch, b) for b in batches[:PREFETCH_BATCHES])
        next_idx = len(pending)
        while pending:
            chunk = pending.popleft().result()
            if next_idx < len(batches):
                pending.append(pool.submit(decode_batch, batches[next_idx]))
                next_idx += 1
            good = [(n, a) for n, a in chunk if a is not None]
            if not good:
                continue
            batch = torch.from_numpy(np.stack([a for _, a in good])).to(dev)
            out = serve_fn(params, batch).cpu().numpy()
            for (name, _), img in zip(good, out):
                stem = os.path.splitext(name)[0]
                path = os.path.join(out_dir, f"converted_fast_st_{style_name}_{stem}.png")
                img_utils.save_uint8(img, path)
                out_paths.append(path)
    dt = time.time() - t0
    logger.info(
        "Stylized %d images in %.1fs (%.1f img/s incl. IO) -> %s",
        len(out_paths), dt, len(out_paths) / dt if dt else 0.0, out_dir,
    )
    return out_paths
