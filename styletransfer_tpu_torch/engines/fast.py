"""Fast (feed-forward) style transfer: training, eval and inference.

The port of ``styletransfer_tpu/engines/fast.py``.

Training (``static_train``): the transform net's stacked forward
(``transformer.apply_stacked``, every instance norm on the fused-IN kernels
and their backward), the VGG perceptual loss and total variation, autograd,
and ``torch.optim.Adam`` (optax ``adam``'s arithmetic). Params, gradients
and Adam state stay f32 under ``precision="bf16"``, which runs only the
activations in bf16. On CUDA the forward, loss and backward replay from
one CUDA graph (``make_step``) and Adam runs eagerly after it. Host work
per step is feeding the next batch (decoded on threads, copied ahead by
``parallel.prefetch``), launching the graph and Adam, and reading the loss
back on the logging cadence. The reference's cadences and TensorBoard tags are
kept: the loss every 20 steps (``data/fst_train_loss``), a preview every 50
(``data/fst_images``), the eval every 150 (``data/fst_test_loss``).

Data-parallel training over ``torch.distributed`` (one process per GPU,
``parallel/distributed.py``): each rank trains on its shard of the corpus
and its slice of the global batch, the step averages the gradients and
metrics over the ranks in one all-reduce, the loops run in ``lockstep``,
resume positions are agreed by every rank, and the eval's mean is the
global batch's. Previews are skipped with more than one rank.

Inference: ``make_serve_fn`` (uint8 in, uint8 out, the normalize and
denormalize steps on the device, the pad-early forward on the serving
kernels), ``process_image``, ``process_dir`` and the stdin daemon
``serve_loop`` (``fast_st serve``, on ``engines/daemon.py``). Inputs are
decoded on the host with PIL and moved to the device as uint8. The batched
paths take a list of ``devices`` (default: every visible GPU for ``"cuda"``,
else ``device`` alone): one replica of the parameters on each, every batch
split over them (``parallel/mesh.py``); with one device the code path is
the single-device one.
"""

from __future__ import annotations

import os
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import checkpoint as torch_checkpoint

from styletransfer_tpu_torch import ckpt, constants
from styletransfer_tpu_torch.data import coco
from styletransfer_tpu_torch.engines import daemon
from styletransfer_tpu_torch.models import transformer, vgg
from styletransfer_tpu_torch.ops import layers, losses
from styletransfer_tpu_torch.parallel import distributed, prefetch
from styletransfer_tpu_torch.parallel import mesh as mesh_lib
from styletransfer_tpu_torch.utils import aot, profiling, tb
from styletransfer_tpu_torch.utils import images as img_utils
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
    shards: Optional[distributed.GlobalBatch] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The perceptual training objective: style + content + total variation
    of the stylized batch. Returns ``(total, {"total", "style", "content",
    "tv"})``. With ``shards`` the batch is this rank's slice of a global
    batch, and the mean over the ranks of the result is the global batch's
    (see ``parallel/distributed.py``). The transform net's forward is the
    span ``train.forward``, the rest ``train.loss``."""
    with profiling.span("train.forward"):
        batch = img_utils.maybe_normalize_on_device(batch)
        transformed = transformer.apply_stacked(params, batch, compute_dtype)
    with profiling.span("train.loss"):
        perceptual, comps = vgg.perceptual_loss(
            vgg_params, transformed, batch, style_grams,
            style_weight=style_weight, content_weight=content_weight,
            compute_dtype=compute_dtype,
        )
        tv = losses.total_variation_loss(transformed)
        if shards is not None:
            # A sum over the batch: its share of the ranks' mean is world
            # times this rank's sum.
            tv = tv * shards.world
        total = perceptual + tv
    return total, {"total": total, "style": comps["style"], "content": comps["content"],
                   "tv": tv}


def make_step(objective: Callable, remat: bool = False,
              shards: Optional[distributed.GlobalBatch] = None) -> Callable:
    """``train_step(params, optimizer, *inputs) -> metrics`` for
    ``objective(params, *inputs) -> (total, metrics)``: one forward,
    backward and Adam update, in place on ``params``. The metrics are
    detached 0-d tensors on the device (reading one waits for the step).
    With ``shards`` the gradients and metrics are averaged over the ranks
    (one all-reduce) between the backward and the update, so every rank
    takes the same step.

    ``remat=True`` checkpoints the objective (``torch.utils.checkpoint``):
    the backward recomputes the forward's activations instead of keeping
    them, about a third more work for much less memory. The recomputation
    runs the instance-norm forward kernels a second time.

    A step is the span ``train.step``, which holds ``train.backward`` and
    ``train.optimizer`` (Adam) besides the objective's own.

    On CUDA the forward, loss and backward replay from a CUDA graph
    (``utils/aot.py::GradGraphs``: one per device, shape and dtype of the
    inputs and identity of ``params``), so a step costs the host one graph
    launch and Adam's eager update instead of some 800 launches. The step
    runs eagerly instead where an input is not a CUDA tensor, with
    ``shards`` (its all-reduce runs in the step, at any world size), with
    ``remat``, while ``profiling.record_spans()`` records (so that the
    spans time the eager step), and where a capture failed."""
    layers.disable_tf32()

    def gradients(params: transformer.TransformerNet, *inputs) -> Dict[str, torch.Tensor]:
        params.zero_grad(set_to_none=True)
        total, metrics = objective(params, *inputs)
        total.backward()
        return {k: v.detach() for k, v in metrics.items()}

    graphs = None if remat or shards is not None else aot.GradGraphs(gradients, "train step")

    def train_step(params: transformer.TransformerNet, optimizer: torch.optim.Optimizer,
                   *inputs) -> Dict[str, torch.Tensor]:
        if graphs is not None and not profiling.recording():
            metrics = graphs(params, *inputs)
            if metrics is not None:
                optimizer.step()
                return metrics
        with profiling.span("train.step"):
            optimizer.zero_grad(set_to_none=True)
            if remat:
                total, metrics = torch_checkpoint.checkpoint(objective, params, *inputs,
                                                             use_reentrant=False)
            else:
                total, metrics = objective(params, *inputs)
            with profiling.span("train.backward"):
                total.backward()
            metrics = {k: v.detach() for k, v in metrics.items()}
            if shards is not None:
                metrics = shards.average(params, metrics)
            with profiling.span("train.optimizer"):
                optimizer.step()
            return metrics

    return train_step


def make_train_step(
    vgg_params: vgg.Params,
    style_grams: Mapping[str, torch.Tensor],
    style_weight: float = 100_000.0,
    content_weight: float = 1.0,
    compute_dtype: Optional[torch.dtype] = None,
    remat: bool = False,
    shards: Optional[distributed.GlobalBatch] = None,
) -> Callable:
    """``train_step(params, optimizer, batch) -> metrics`` on :func:`loss_fn`
    (:func:`make_step`, with its ``remat`` and ``shards``)."""
    def objective(params, batch):
        return loss_fn(params, batch, vgg_params, style_grams, style_weight, content_weight,
                       compute_dtype, shards)

    return make_step(objective, remat, shards)


def eval_loss(
    vgg_params: vgg.Params,
    transformed: torch.Tensor,
    batch: torch.Tensor,
    style_grams: Mapping[str, torch.Tensor],
    style_weight: float,
    feature_weight: float,
    compute_dtype: Optional[torch.dtype] = None,
    shards: Optional[distributed.GlobalBatch] = None,
) -> torch.Tensor:
    """The eval objective of a stylized batch: style + feature loss, with
    the reference's quirk of clamping the ImageNet-normalized output to [0,
    255] (which only removes negatives) first. ``style_grams`` are [1, C, C]
    or per image [B, C, C]. With ``shards`` the mean over the ranks of the
    result is the global batch's."""
    clamped = torch.clamp(transformed, 0.0, 255.0)
    feats = vgg.extract_features(vgg_params, clamped, tuple(style_grams), compute_dtype)
    s_loss = sum(losses.style_loss(feats[name], tgt) for name, tgt in style_grams.items())
    f_loss = vgg.feature_loss(vgg_params, clamped, batch, compute_dtype=compute_dtype,
                              shards=shards)
    return style_weight * s_loss + feature_weight * f_loss


def make_eval_step(
    vgg_params: vgg.Params,
    style_grams: Mapping[str, torch.Tensor],
    style_weight: float = 100_000.0,
    feature_weight: float = 1.0,
    compute_dtype: Optional[torch.dtype] = None,
    shards: Optional[distributed.GlobalBatch] = None,
) -> Callable:
    """``eval_step(params, batch) -> loss``: :func:`eval_loss` of the
    stylized batch (with ``shards``, this rank's share of the ranks'
    mean)."""
    layers.disable_tf32()

    @torch.no_grad()
    def eval_step(params: transformer.TransformerNet, batch: torch.Tensor) -> torch.Tensor:
        batch = img_utils.maybe_normalize_on_device(batch)
        transformed = transformer.apply_stacked(params, batch, compute_dtype)
        return eval_loss(vgg_params, transformed, batch, style_grams, style_weight,
                         feature_weight, compute_dtype, shards)

    return eval_step


def static_test(params: transformer.TransformerNet, test_loader, eval_step: Callable,
                device, shards: Optional[distributed.GlobalBatch] = None) -> float:
    """Mean eval loss over the test loader. With ``shards`` the ranks
    evaluate their shards of the test split in lockstep (each eval step
    holds a collective), and the mean is the global batches'."""
    total = [float(eval_step(params, prefetch.to_device(batch, torch.device(device))))
             for batch in distributed.lockstep(test_loader)]
    avg = float(np.mean(total)) if total else float("nan")
    if shards is not None:
        avg = shards.mean_float(avg)
    get_logger().info("Average test loss: %.8f", avg)
    return avg


def train_loop(
    params: transformer.TransformerNet,
    train_step: Callable,
    test: Callable,
    preview: Callable,
    from_tree: Callable,
    model_name: str,
    style_name: str,
    train_loader,
    writer,
    epochs: int,
    batch_size: int,
    log_cadence: Tuple[int, int, int],
    models_path: Optional[str],
    max_steps_per_epoch: Optional[int],
    step_checkpoint_every: Optional[int],
    device: torch.device,
    start_message: str = "Starting epoch %d",
) -> transformer.TransformerNet:
    """The epoch loop that ``static_train`` and the multi-style ``train``
    share; returns the trained parameters.

    ``train_step(params, optimizer, batch) -> metrics``, ``test(params) ->
    mean eval loss`` and ``preview(params, batch) -> (stylized, input)``
    (normalized [1, H, W, 3] images) run at the cadences of ``log_cadence``
    (loss, preview, eval: TensorBoard's ``data/fst_train_loss``,
    ``data/fst_images``, ``data/fst_test_loss``); ``from_tree`` builds the
    parameters from a saved tree. The reference's epoch-checkpoint contract:
    an epoch whose checkpoint exists is skipped and its weights loaded (the
    Adam state starts anew, as in the JAX trainers). With
    ``step_checkpoint_every`` a step state (params, Adam state, epoch and
    batch position) is also saved every N steps and after each epoch; a
    restart resumes from it with the loader fast-forwarded, so no trained
    batch is replayed.

    In a distributed run every rank runs this loop on its loader's shard:
    the batches go in ``lockstep``, a loaded step state is kept only if
    every rank loaded the same position, every rank writes the checkpoints
    (the same bytes; ``ckpt.save`` is atomic) and no preview is made."""
    logger = get_logger()
    world = distributed.process_info()[1]
    scalar_every, image_every, eval_every = log_cadence
    optimizer = make_optimizer(params)
    iteration = 0
    start_epoch = 0
    resume_batches = 0
    if step_checkpoint_every:
        state = ckpt.load_step_state(model_name, style_name, models_path,
                                     extra_keys=("batch_in_epoch",))
        state = distributed.agree_resume_state(state)
        if state is not None:
            params = from_tree(state["params"])
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
                    ckpt.step_state_path(model_name, style_name, models_path))

    for epoch in range(start_epoch, epochs):
        done = ckpt.existing_checkpoint_path(model_name, style_name, epoch, models_path)
        if done is not None:
            # This epoch's own file: the latest overall could be a later one.
            params = from_tree(ckpt.load(done))
            optimizer = make_optimizer(params)
            logger.info("Epoch %d checkpoint exists; skipping", epoch)
            continue

        logger.info(start_message, epoch)
        t0 = time.time()
        n_in_epoch = 0
        epoch_offset = resume_batches if epoch == start_epoch else 0
        resume_batches = 0
        batches = prefetch.prefetch_to_device(train_loader, device)
        try:
            for batch in distributed.lockstep(batches):
                metrics = train_step(params, optimizer, batch)
                if iteration % scalar_every == 0:
                    total = float(metrics["total"])
                    writer.add_scalar("data/fst_train_loss", total, iteration)
                    logger.info("Batch Loss: %.8f", total)
                if iteration % eval_every == 0:
                    writer.add_scalar("data/fst_test_loss", test(params), iteration)
                if iteration % image_every == 0 and world == 1:
                    with torch.no_grad():
                        stylized, preview_in = preview(params, batch, iteration)
                    pair = img_utils.concat_images(
                        img_utils.to_uint8(stylized.float().cpu().numpy()),
                        img_utils.to_uint8(preview_in.float().cpu().numpy()),
                        axis=1,
                    )
                    writer.add_image("data/fst_images", pair, iteration)
                iteration += 1
                n_in_epoch += 1
                if step_checkpoint_every and iteration % step_checkpoint_every == 0:
                    ckpt.save_step_state(
                        params, ckpt.adam_state_to_tree(params, optimizer), epoch, iteration,
                        model_name, style_name, models_path,
                        extra={"batch_in_epoch": epoch_offset + n_in_epoch})
                if max_steps_per_epoch and n_in_epoch >= max_steps_per_epoch:
                    break
        finally:
            batches.close()

        dt = time.time() - t0
        if n_in_epoch:
            logger.info("Epoch %d: %d steps in %.1fs (%.2f img/s)",
                        epoch, n_in_epoch, dt, n_in_epoch * batch_size / dt)
        ckpt.save_epoch(params, model_name, style_name, epoch, models_path)
        if step_checkpoint_every:
            # Keep the step state ahead of the epoch checkpoint, so a restart
            # right after an epoch resumes with the current Adam moments.
            ckpt.save_step_state(
                params, ckpt.adam_state_to_tree(params, optimizer), epoch + 1, iteration,
                model_name, style_name, models_path, extra={"batch_in_epoch": 0})

    writer.close()
    return params


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

    The epochs, checkpoints, step states and their resume are
    :func:`train_loop`'s. ``precision="bf16"`` runs the activations of the
    transform net and VGG in bf16; params, gradients, Adam state and loss
    reductions stay f32. In a distributed run (``parallel.distributed.
    initialize`` first) ``batch_size`` is the global batch, and each rank
    loads its shard of the corpus and its slice of every batch."""
    dev = constants.resolve_device(device)
    rank, world = distributed.process_info()
    shards = distributed.global_batch()
    mesh_lib.warn_single_process_training(dev, world)
    compute_dtype = _compute_dtype(precision)
    writer = tb.get_tensorboard_writer(runs_dir or os.path.join(
        constants.PROJECT_ROOT_PATH, constants.RUNS_PATH,
        f"fast-image-style-transfer-still-image_{style_name}"))

    if vgg_params is None:
        vgg_params = vgg.load_params(device=dev)
    style = torch.as_tensor(style_image, dtype=torch.float32).to(dev)
    style_grams = vgg.style_gram_targets(vgg_params, style)
    if params is None:
        params = transformer.init_params(seed, device=dev)
    train_step = make_train_step(vgg_params, style_grams, style_weight, content_weight,
                                 compute_dtype, shards=shards)
    eval_step = make_eval_step(vgg_params, style_grams, style_weight,
                               compute_dtype=compute_dtype, shards=shards)
    if train_loader is None or test_loader is None:
        test_loader, train_loader = coco.get_coco_loader(
            batch_size=distributed.local_batch_size(batch_size), test_split=0.10,
            test_limit=20, seed=seed, shard_index=rank, shard_count=world)
    get_logger().info("Training fast_st with Adam on %s (%s, %d process(es))", dev, precision,
                      world)

    def preview(params, batch, iteration):
        preview_in = img_utils.maybe_normalize_on_device(batch[:1])
        return transformer.apply_stacked(params, preview_in, compute_dtype), preview_in

    return train_loop(
        params, train_step, lambda p: static_test(p, test_loader, eval_step, dev, shards),
        preview,
        lambda tree: transformer.params_from_jax(tree, device=dev), MODEL_NAME, style_name,
        train_loader, writer, epochs, batch_size, log_cadence, models_path,
        max_steps_per_epoch, step_checkpoint_every, dev)


def make_serve_fn(precision: str = "f32", pad_mode: str = "reflect") -> Callable:
    """The uint8-in / uint8-out serving forward: ``serve_fn(params, batch_u8)``
    with ``batch_u8`` [B, H, W, 3] uint8 on the params' device.

    f32 runs in full f32: TF32 is switched off for cuDNN convs and matmuls
    (both default differently), so the output stays within 1/255 of the
    f32 reference. ``pad_mode="zeros"`` serves checkpoints that the original
    reference trained (see ``transformer.apply``). A call is the span
    ``serve.forward``."""
    compute_dtype = _compute_dtype(precision)
    if pad_mode not in ("reflect", "zeros"):
        raise ValueError(f"pad_mode must be 'reflect' or 'zeros', got {pad_mode!r}")
    layers.disable_tf32()

    def serve_fn(params: transformer.TransformerNet, batch_u8: torch.Tensor) -> torch.Tensor:
        with profiling.span("serve.forward"):
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
    (``{out_dir}/converted_fast_st_{style}.png``). Under ``STX_AOT_CACHE=1``
    the forward runs from a CUDA graph (``utils/aot.py``)."""
    dev = constants.resolve_device(device)
    params = _load_params(params, style_name, models_path, dev)
    input_u8 = img_utils.load_image_uint8(
        os.path.join(constants.PROJECT_ROOT_PATH, image_path),
        size=size or constants.IMSIZE,
    )
    serve_fn = make_serve_fn(precision, pad_mode)
    # A CUDA graph of the forward at this shape under STX_AOT_CACHE=1.
    batch = torch.from_numpy(np.array(input_u8)).to(dev)
    serve = aot.cached_compile(serve_fn, (params, batch), "fast_serve")
    out_u8 = serve(params, batch).cpu().numpy()[0]

    out_dir = os.path.join(constants.PROJECT_ROOT_PATH, out_dir)
    os.makedirs(out_dir, exist_ok=True)
    out_file = os.path.join(out_dir, f"converted_fast_st_{style_name}.png")
    img_utils.save_uint8(out_u8, out_file)
    get_logger().info("Saved stylized image to %s", out_file)
    return out_file


def image_files(in_dir: str) -> List[str]:
    """The image files of ``in_dir`` (``IMAGE_EXTS``), sorted; raises if
    there are none."""
    files = sorted(f for f in os.listdir(in_dir) if f.lower().endswith(IMAGE_EXTS))
    if not files:
        raise FileNotFoundError(f"No images ({'/'.join(IMAGE_EXTS)}) in {in_dir}")
    return files


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
    devices: Optional[Sequence] = None,
) -> List[str]:
    """Stylize every image in a directory with batched inference.

    One checkpoint load, threaded host decode of up to ``PREFETCH_BATCHES``
    batches ahead of the device, uint8 both ways, each batch split over
    ``devices`` (``mesh.serving_placement``). Unreadable files are skipped
    with a warning. Outputs are
    ``{out_dir}/converted_fast_st_{style}_{stem}.png``; returns their paths.
    Under ``STX_AOT_CACHE=1`` each batch shape runs from a CUDA graph
    (``utils/aot.py``).
    """
    dev = constants.resolve_device(device)
    in_dir = os.path.join(constants.PROJECT_ROOT_PATH, input_dir)
    files = image_files(in_dir)
    params = _load_params(params, style_name, models_path, dev)
    placement = mesh_lib.serving_placement(min(batch_size, len(files)), params, devices, dev)
    # Under STX_AOT_CACHE=1, a CUDA graph of the forward for each replica and
    # batch shape (a ragged last batch gets its own).
    serve_fn = aot.cached_compile(make_serve_fn(precision, pad_mode), placement.replicas,
                                  "fast_serve")
    return stylize_files(
        in_dir, files, batch_size, size or constants.IMSIZE,
        lambda batch: placement.run(serve_fn, batch).cpu().numpy(),
        os.path.join(constants.PROJECT_ROOT_PATH, out_dir),
        lambda stem: f"converted_fast_st_{style_name}_{stem}.png")


def stylize_files(in_dir: str, files: Sequence[str], batch_size: int, size: int,
                  run: Callable[[np.ndarray], np.ndarray], out_dir: str,
                  out_name: Callable[[str], str]) -> List[str]:
    """The batched directory path that ``convert-dir`` and
    ``convert-adain`` share: ``files`` of ``in_dir`` decoded on host threads
    (cropped and resized to ``size``, uint8) up to ``PREFETCH_BATCHES``
    batches ahead, ``run`` on each stacked batch ([B, size, size, 3] uint8
    in, the same out), each image saved as ``out_dir/out_name(stem)``.
    Unreadable files are skipped with a warning; returns the saved paths."""
    logger = get_logger()
    os.makedirs(out_dir, exist_ok=True)

    def decode(name):
        try:
            return name, img_utils.load_image_uint8(os.path.join(in_dir, name), size=size)[0]
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
            out = run(np.stack([a for _, a in good]))
            for (name, _), img in zip(good, out):
                path = os.path.join(out_dir, out_name(os.path.splitext(name)[0]))
                img_utils.save_uint8(img, path)
                out_paths.append(path)
    dt = time.time() - t0
    logger.info(
        "Stylized %d images in %.1fs (%.1f img/s incl. IO) -> %s",
        len(out_paths), dt, len(out_paths) / dt if dt else 0.0, out_dir,
    )
    return out_paths


def warm_buckets(serve: Callable, buckets: Sequence[int], batch_size: int, device,
                 label: str) -> None:
    """Run ``serve(batch_u8)`` once at every bucket's shape before READY, so
    that the first request finds the kernels built and loaded."""
    for s in buckets:
        t0 = time.time()
        serve(torch.zeros((batch_size, s, s, 3), dtype=torch.uint8, device=device)).cpu()
        get_logger().info("%s: warmed the %dpx b%d forward in %.1fs", label, s, batch_size,
                          time.time() - t0)
    get_logger().info("%s: ready (buckets: %s)", label, list(buckets))


def bucket_resolver(buckets: Sequence[int], size_field: int, shape: str) -> Callable:
    """``resolve(fields) -> size``: the field-count contract (at most
    ``size_field + 1`` fields, named by ``shape`` in the refusal) and the
    optional SIZE field's bucket (absent or empty: the first bucket)."""
    def resolve(fields) -> int:
        if len(fields) > size_field + 1:
            raise ValueError(f"expected {shape}, got {len(fields)} fields")
        if len(fields) == size_field + 1 and fields[size_field]:
            try:
                s = int(fields[size_field])
            except ValueError:
                raise ValueError(f"SIZE must be an integer, got {fields[size_field]!r}")
            if s not in buckets:
                raise ValueError(f"size {s} not in serving buckets {list(buckets)}")
            return s
        return buckets[0]

    return resolve


def pad_group(arrays: List[np.ndarray], batch_size: int) -> np.ndarray:
    """Stack a group's per-request arrays and pad it to ``batch_size`` with
    copies of the last one: every device call has the warmed shape."""
    out = np.stack(arrays)
    pad = batch_size - len(arrays)
    return np.concatenate([out, np.repeat(out[-1:], pad, axis=0)]) if pad else out


def serve_loop(
    style_name: str,
    out_dir: str = "results/",
    params: Optional[transformer.TransformerNet] = None,
    models_path: Optional[str] = None,
    size: Optional[int] = None,
    precision: str = "f32",
    pad_mode: str = "reflect",
    batch_size: int = 1,
    sizes: Optional[Sequence[int]] = None,
    stdin=None,
    stdout=None,
    device=constants.DEFAULT_DEVICE,
    devices: Optional[Sequence] = None,
) -> int:
    """Warm-process serving: the line-oriented stylization daemon of
    ``fast_st serve``, with the JAX daemon's protocol (``engines/daemon.py``).

    One request per line on ``stdin``, ``INPUT[\\tOUTPUT[\\tSIZE]]``:
    stylize INPUT to OUTPUT (empty or absent:
    ``{out_dir}/converted_fast_st_{style}_{stem}.png``) at the SIZE bucket
    (absent: the first of ``sizes``, or ``size``, or 256). ``RELOAD`` swaps
    in the latest checkpoint (``OK RELOAD epoch=<n>``; on failure ``ERR
    RELOAD: <reason>`` and the old parameters keep serving); ``STATS``
    answers the latency summary and ``device_rtt_ms``; a blank line or EOF
    shuts down. ``READY`` is printed once every bucket's forward has run
    once (which builds the kernels); then each request answers ``OK
    <out_path>`` or ``ERR <input>: <reason>``, in request order. Returns the
    number of requests served.

    ``batch_size > 1`` batches dynamically: the requests already queued (up
    to ``batch_size``) run as one device call per bucket present, padded to
    ``batch_size``; a lone request keeps single-request latency. The group
    is split over ``devices`` (``mesh.serving_placement``); ``RELOAD``
    replaces every device's replica.
    """
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    dev = constants.resolve_device(device)
    stdout = stdout if stdout is not None else sys.stdout
    params = _load_params(params, style_name, models_path, dev)
    # The served parameters live in the placement, so that RELOAD can swap them.
    placement = mesh_lib.serving_placement(batch_size, params, devices, dev)
    serve_fn = make_serve_fn(precision, pad_mode)
    buckets = daemon.normalize_buckets(sizes, size or constants.IMSIZE)
    out_dir = os.path.join(constants.PROJECT_ROOT_PATH, out_dir)
    os.makedirs(out_dir, exist_ok=True)
    warm_buckets(lambda b: placement.run(serve_fn, b), buckets, batch_size, dev, "serve")
    print("READY", file=stdout, flush=True)
    resolve_bucket = bucket_resolver(buckets, 2, "INPUT[\\tOUTPUT[\\tSIZE]]")

    def reload():
        new, epoch = ckpt.load_latest_transformer(MODEL_NAME, style_name, models_path,
                                                  device=dev, template=placement.params)
        placement.place_params(new)
        return f"RELOAD epoch={epoch}"

    def save_one(in_path, explicit_out, img):
        stem = os.path.splitext(os.path.basename(in_path))[0]
        out_file = daemon.resolve_out_path(
            explicit_out, out_dir, f"converted_fast_st_{style_name}_{stem}.png")
        img_utils.save_uint8(img, out_file)
        return out_file

    def load(in_path, bucket):
        return img_utils.load_image_uint8(
            os.path.join(constants.PROJECT_ROOT_PATH, in_path), size=bucket)

    if batch_size == 1:
        def handle(*fields):
            bucket = resolve_bucket(fields)
            in_u8 = torch.from_numpy(np.array(load(fields[0], bucket))).to(dev)
            out_u8 = serve_fn(placement.params, in_u8).cpu().numpy()[0]
            return save_one(fields[0], fields[1] if len(fields) > 1 else "", out_u8)

        return daemon.run_request_loop(handle, stdin=stdin, stdout=stdout, name="serve",
                                       commands={"RELOAD": reload}, device=dev)

    def decode(i, fields):
        try:
            bucket = resolve_bucket(fields)
            meta = (i, fields[0], fields[1] if len(fields) > 1 else "",
                    load(fields[0], bucket)[0])
            return i, bucket, meta, None
        except Exception as exc:  # noqa: BLE001 - answered per request
            return i, None, None, exc

    def launch(bucket, metas):
        return placement.run(serve_fn, pad_group([m[3] for m in metas], batch_size))

    def save(meta, img):
        return save_one(meta[1], meta[2], img)

    submit_segment = daemon.make_pooled_segment_submit(decode, launch, save)
    return daemon.run_batched_request_loop(
        None, batch_size, stdin=stdin, stdout=stdout, name="serve",
        submit_batch=daemon.segmented_submit_batch(submit_segment, {"RELOAD": reload}),
        device=dev)
