"""Video style transfer: temporally consistent training and inference.

The port of ``styletransfer_tpu/engines/video.py``. The model is the
6-channel transform net fed [current frame, previous stylized frame] on
channels.

Training is the reference's recurrence: one Adam step per frame, the
previous (content, stylized) pair as the carry, detached so that no gradient
crosses frames. The JAX package runs a chunk of frames as one ``lax.scan``;
here :func:`make_scan_train_step` keeps that contract with a loop over the
chunk's frames. The loss runs the stacked forward (``apply_stacked``), so
every instance norm is on the fused-IN kernels and the VGG tower on the
stat-free conv kernels, as in fast_st training. The warm-start freeze (only
``conv1`` trains in epoch 0 when starting from fast_st weights) multiplies
the gradients by a {0, 1} mask: the frozen parameters still take their Adam
step with zero gradients, so every parameter's step count stays optax's.

Distributed training (``parallel/distributed.py``, one process per GPU):
each rank trains its shard of the clips in its slice of the video batch;
the frame step averages the gradients and metrics over the ranks, the
temporal loss takes the global batch's norms, the video batches and chunks
go in ``lockstep`` and a chunk steps only the frames that every rank has.
Each rank keeps its carry rows in a sidecar (``ckpt.save_carry_shards``),
and a mid-batch resume needs every rank's: the ranks decide it together.

Inference (:func:`stylize_clip`, :func:`process_video`,
:func:`process_video_dir`) runs the serving forward (``transformer.apply``:
the conv3x3_valid and IN-pad kernels, or with ``pad_mode="zeros"`` the
conv3x3_flat and fused-IN kernels) frame by frame, each output fed back as
the next frame's carry. Output videos are mp4 where imageio has an encoder,
GIF (through Pillow) otherwise. The streaming daemon
(:func:`serve_stream_loop`, ``video_st serve``) steps frames as they arrive,
each stream's carry held on the device in a slot table.
"""

from __future__ import annotations

import os
import shutil
import time
from collections import OrderedDict
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

from styletransfer_tpu_torch import ckpt, constants
from styletransfer_tpu_torch.data import video as video_data
from styletransfer_tpu_torch.engines import fast
from styletransfer_tpu_torch.models import transformer, vgg
from styletransfer_tpu_torch.ops import layers, losses
from styletransfer_tpu_torch.parallel import distributed
from styletransfer_tpu_torch.parallel import mesh as mesh_lib
from styletransfer_tpu_torch.utils import images as img_utils
from styletransfer_tpu_torch.utils import tb
from styletransfer_tpu_torch.utils.logging import get_logger

MODEL_NAME = "video_st"
VIDEO_EXTS = (".gif", ".mp4", ".avi", ".mov", ".webm", ".mkv")
_METRIC_KEYS = ("total", "style", "content", "tv", "temporal")


def frame_loss_fn(
    params: transformer.TransformerNet,
    frame: torch.Tensor,
    old_content: torch.Tensor,
    old_stylized: torch.Tensor,
    vgg_params: vgg.Params,
    style_grams: Mapping[str, torch.Tensor],
    style_weight: float,
    content_weight: float,
    temporal_weight: float,
    compute_dtype: Optional[torch.dtype] = None,
    shards: Optional[distributed.GlobalBatch] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """The per-frame objective: style + content + total variation +
    temporal. Returns ``(total, (transformed, metrics))``; with ``shards``,
    this rank's share of the global batch's (``fast.loss_fn``; the
    temporal term is the global batch's on every rank)."""
    frame = img_utils.maybe_normalize_on_device(frame)
    net_input = torch.cat([frame, old_stylized], dim=-1)
    transformed = transformer.apply_stacked(params, net_input, compute_dtype)
    perceptual, comps = vgg.perceptual_loss(
        vgg_params, transformed, frame, style_grams,
        style_weight=style_weight, content_weight=content_weight,
        compute_dtype=compute_dtype,
    )
    tv = losses.total_variation_loss(transformed)
    if shards is not None:
        tv = tv * shards.world  # a sum over the batch (fast.loss_fn)
    temporal = losses.temporal_loss(old_content, old_stylized, frame, transformed,
                                    temporal_weight, shards)
    total = perceptual + tv + temporal
    metrics = {"total": total, "style": comps["style"], "content": comps["content"],
               "tv": tv, "temporal": temporal}
    return total, (transformed, metrics)


def make_scan_train_step(
    vgg_params: vgg.Params,
    style_grams: Mapping[str, torch.Tensor],
    style_weight: float = 100_000.0,
    content_weight: float = 1.0,
    temporal_weight: float = 0.8,
    compute_dtype: Optional[torch.dtype] = None,
    shards: Optional[distributed.GlobalBatch] = None,
):
    """Build the chunked train step. Returns ``(opt, scan_step)``: ``opt``
    makes the optimizer (Adam) of a parameter module, and

    ``scan_step(params, opt_state, frames[T,B,H,W,3], valid[T], old_content,
    old_stylized, grad_mask) -> (params, opt_state, old_content,
    old_stylized, metrics)``

    takes one Adam step per valid frame, in place on ``params`` and
    ``opt_state`` (the optimizer). The carry's stylized frame is detached,
    like the reference's ``old_images``. ``grad_mask`` (:func:`freeze_mask`)
    multiplies each parameter's gradient. A frame whose ``valid`` is False
    (a padded tail) takes no step, leaves the carry as it is and reports 0.0
    metrics. ``metrics`` maps each of total, style, content, tv and temporal
    to a [T] f32 tensor on the frames' device. With ``shards`` each frame's
    gradients and metrics are averaged over the ranks before the update
    (``fast.make_step``)."""
    layers.disable_tf32()

    def scan_step(params, opt_state, frames, valid, old_content, old_stylized, grad_mask):
        metrics: Dict[str, List[torch.Tensor]] = {k: [] for k in _METRIC_KEYS}
        zero = torch.zeros((), dtype=torch.float32, device=frames.device)
        for t, is_valid in enumerate(torch.as_tensor(valid).tolist()):
            if not is_valid:
                for k in _METRIC_KEYS:
                    metrics[k].append(zero)
                continue
            # Normalize first, so that the carry holds float frames.
            frame = img_utils.maybe_normalize_on_device(frames[t])
            opt_state.zero_grad(set_to_none=True)
            total, (transformed, m) = frame_loss_fn(
                params, frame, old_content, old_stylized, vgg_params, style_grams,
                style_weight, content_weight, temporal_weight, compute_dtype, shards)
            total.backward()
            if shards is not None:
                m = shards.average(params, {k: m[k].detach() for k in _METRIC_KEYS})
            for name, p in params.named_parameters():
                if grad_mask[name] != 1.0:
                    p.grad.mul_(grad_mask[name])
            opt_state.step()
            old_content, old_stylized = frame, transformed.detach()
            for k in _METRIC_KEYS:
                metrics[k].append(m[k].detach().float())
        return (params, opt_state, old_content, old_stylized,
                {k: torch.stack(v) for k, v in metrics.items()})

    return fast.make_optimizer, scan_step


def freeze_mask(params: torch.nn.Module, freeze_all_but_first: bool) -> Dict[str, float]:
    """The warm-start schedule's gradient mask, by parameter name: with
    ``freeze_all_but_first`` only ``conv1`` trains (the reference keeps the
    parameters named ``0.*`` trainable: the first conv, not the first
    instance norm, which the warm start copied)."""
    return {name: 1.0 if not freeze_all_but_first or name.split(".")[0] == "conv1" else 0.0
            for name, _ in params.named_parameters()}


def _chunk_frames(
    frame_iter: Iterator[np.ndarray], chunk: int, pad_tail: bool = False
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Group per-frame [B,H,W,3] arrays into ``(frames[T,B,H,W,3], valid[T])``.

    With ``pad_tail`` the ragged last group is padded to ``chunk`` frames by
    repeating its last frame, ``valid`` False for the padding (which takes
    no step and writes no output)."""
    buf = []
    for f in frame_iter:
        buf.append(f)
        if len(buf) == chunk:
            yield np.stack(buf), np.ones(chunk, dtype=bool)
            buf = []
    if buf:
        n_real = len(buf)
        if pad_tail:
            buf.extend([buf[-1]] * (chunk - n_real))
        valid = np.zeros(len(buf), dtype=bool)
        valid[:n_real] = True
        yield np.stack(buf), valid


def _all_processes_agree(flag: bool) -> bool:
    """True iff ``flag`` is true on every rank (``flag`` in one process):
    for resume decisions that change how many collectives a rank joins."""
    return distributed.agree_min(int(bool(flag))) == 1


def video_train(
    style_image,
    style_name: str = "nsp",
    epochs: int = 50,
    batch_size: int = 4,
    temporal_weight: float = 0.8,
    style_weight: float = 100_000.0,
    content_weight: float = 1.0,
    use_pretrained_fast_st: bool = False,
    vgg_params: Optional[vgg.Params] = None,
    params: Optional[transformer.TransformerNet] = None,
    video_loader=None,
    seed: int = 0,
    chunk_size: int = 16,
    max_frames: int = video_data.MAX_FRAMES_DEFAULT,
    runs_dir: Optional[str] = None,
    models_path: Optional[str] = None,
    precision: str = "f32",
    step_checkpoint_every: Optional[int] = None,
    device=constants.DEFAULT_DEVICE,
) -> transformer.TransformerNet:
    """Train the video transform net on ``style_image`` ([1, H, W, 3],
    normalized; numpy or tensor) and return the trained parameters.

    Keeps the reference's per-epoch checkpoint and resume (an epoch whose
    checkpoint exists is skipped and its weights loaded, the Adam state
    starting anew), the freeze of epoch 0 when warm-starting from fast_st
    weights, the loss weights, and the TensorBoard cadences and tags (the
    loss every 20 frames, a preview every 50). ``step_checkpoint_every``
    also saves a step state every >= N frame updates, at chunk boundaries:
    params, Adam state, the (video batch, chunk) position and the recurrent
    carry, so that a restart replays no trained frame and ends with the
    parameters of an uninterrupted run (the chunks trained before the stop
    are decoded again, to move the readers, but take no step). The file
    layout is the JAX trainer's: either package resumes the other's state.

    Distributed (``parallel.distributed.initialize`` first), ``batch_size``
    is the global video batch and each rank trains its shard of the clips;
    the carry goes to one sidecar per rank, and a mid-batch resume needs
    every rank's sidecar, else every rank restarts the video batch."""
    logger = get_logger()
    dev = constants.resolve_device(device)
    rank, world = distributed.process_info()
    shards = distributed.global_batch()
    mesh_lib.warn_single_process_training(dev, world)
    compute_dtype = fast._compute_dtype(precision)
    writer = tb.get_tensorboard_writer(runs_dir or os.path.join(
        constants.PROJECT_ROOT_PATH, constants.RUNS_PATH,
        f"video-style-transfer_{style_name}"))

    if vgg_params is None:
        vgg_params = vgg.load_params(device=dev)
    style = torch.as_tensor(style_image, dtype=torch.float32).to(dev)
    style_grams = vgg.style_gram_targets(vgg_params, style)

    has_external_weights = False
    if params is None:
        fast_params = None
        if use_pretrained_fast_st:
            try:
                fast_params, _ = ckpt.load_latest_transformer(fast.MODEL_NAME, style_name,
                                                              models_path, device=dev)
                has_external_weights = True
                logger.info("Warm-starting video net from fast_st weights")
            except FileNotFoundError:
                logger.warning("Couldn't load pretrained fast_st weights")
        params = transformer.init_video_params(seed, fast_params, device=dev)

    opt, scan_step = make_scan_train_step(vgg_params, style_grams, style_weight,
                                          content_weight, temporal_weight,
                                          compute_dtype=compute_dtype, shards=shards)
    optimizer = opt(params)
    if video_loader is None:
        video_loader = video_data.VideoDataset(
            batch_size=distributed.local_batch_size(batch_size), shard_index=rank,
            shard_count=world)
    logger.info("Training video_st with Adam on %s (%s, %d process(es))", dev, precision,
                world)

    iteration = 0
    start_epoch = 0
    last_step_save = 0
    resume_batches = resume_chunks = 0
    resume_carry = None
    if step_checkpoint_every:
        state = ckpt.load_step_state(
            MODEL_NAME, style_name, models_path,
            extra_keys=("has_external_weights", "batch_in_epoch", "chunk_in_batch"),
            array_keys=("old_content", "old_stylized"))
        state = distributed.agree_resume_state(
            state, extra_keys=("batch_in_epoch", "chunk_in_batch"))
        if state is not None:
            params = transformer.params_from_jax(state["params"], device=dev)
            optimizer = opt(params)
            ckpt.adam_state_from_tree(params, optimizer, state["opt_state"])
            start_epoch = state["epoch"]
            iteration = last_step_save = state["iteration"]
            # The freeze schedule must not change across a resume.
            has_external_weights = bool(state["extra"]["has_external_weights"])
            resume_batches = state["extra"]["batch_in_epoch"]
            resume_chunks = state["extra"]["chunk_in_batch"]
            if resume_chunks and world > 1:
                # Each rank's carry rows are in its sidecar; the mid-batch
                # resume needs every rank's, or no rank takes it.
                shard_arrays = ckpt.load_carry_shards(
                    iteration, MODEL_NAME, style_name, models_path,
                    array_keys=("old_content", "old_stylized"))
                if _all_processes_agree(shard_arrays is not None):
                    resume_carry = (shard_arrays["old_content"], shard_arrays["old_stylized"])
                else:
                    logger.warning(
                        "Step state has a mid-batch position but at least one process's "
                        "carry sidecar is absent or stale (this process: %s); all processes "
                        "resume from the start of video batch %d.",
                        "present" if shard_arrays is not None else "missing", resume_batches)
                    resume_chunks = 0
            elif resume_chunks and {"old_content", "old_stylized"} <= set(state["arrays"]):
                resume_carry = (state["arrays"]["old_content"], state["arrays"]["old_stylized"])
            elif resume_chunks:
                logger.warning("Step state has a mid-batch position but no carry frames; "
                               "resuming from the start of video batch %d.", resume_batches)
                resume_chunks = 0
            if start_epoch >= epochs:
                logger.warning(
                    "Step state is at epoch %d >= requested epochs %d: nothing to train. "
                    "Delete %s to retrain from scratch.", start_epoch, epochs,
                    ckpt.step_state_path(MODEL_NAME, style_name, models_path))

    step_extra = {"has_external_weights": int(has_external_weights)}

    for epoch in range(start_epoch, epochs):
        done = ckpt.existing_checkpoint_path(MODEL_NAME, style_name, epoch, models_path)
        if done is not None:
            # This epoch's own file: the latest overall could be a later one.
            params = transformer.params_from_jax(ckpt.load(done), device=dev)
            optimizer = opt(params)
            logger.info("Epoch %d checkpoint exists; skipping", epoch)
            continue

        frozen = epoch == 0 and has_external_weights
        if frozen:
            logger.info("Freezing fast-transfer weights for the first epoch")
        mask = freeze_mask(params, frozen)
        skip_batches = resume_batches if epoch == start_epoch else 0
        skip_chunks = resume_chunks if epoch == start_epoch else 0
        carry_restore = resume_carry if epoch == start_epoch else None
        resume_batches = resume_chunks = 0
        resume_carry = None

        logger.info("Starting epoch %d", epoch)
        t0 = time.time()
        frames_in_epoch = 0
        for batch_idx, readers in enumerate(distributed.lockstep(video_loader)):
            if batch_idx < skip_batches:  # trained before the stop
                for r in readers:
                    r.close()
                continue
            frame_iter = video_data.iterate_on_video_batches(readers, max_frames)
            # The first frame of each video batch is its own carry (old =
            # [frame, frame]); it is also the first frame trained on.
            old_content = old_stylized = None
            chunks_done = 0
            for chunk, valid in distributed.lockstep(_chunk_frames(frame_iter, chunk_size)):
                if world > 1:
                    # A rank's shortest clip ends its chunks: the last
                    # chunk steps the frames that every rank has.
                    valid = np.arange(len(valid)) < distributed.agree_min(int(valid.sum()))
                if batch_idx == skip_batches and chunks_done < skip_chunks:
                    # Trained before the stop: decoded (the readers move on),
                    # no step.
                    chunks_done += 1
                    continue
                frames = torch.from_numpy(chunk).to(dev)
                if old_content is None:
                    if carry_restore is not None and batch_idx == skip_batches:
                        # A mid-batch resume: the carry stored with the state.
                        old_content, old_stylized = (torch.from_numpy(np.array(a)).to(dev)
                                                     for a in carry_restore)
                        carry_restore = None
                    else:
                        old_content = img_utils.maybe_normalize_on_device(frames[0])
                        old_stylized = old_content
                params, optimizer, old_content, old_stylized, metrics = scan_step(
                    params, optimizer, frames, valid, old_content, old_stylized, mask)
                # The losses come back once per chunk; padded frames (a
                # suffix) took no step and are not counted.
                totals = metrics["total"][:int(valid.sum())].cpu().numpy()
                for i, total in enumerate(totals):
                    if (iteration + i) % 20 == 0:
                        writer.add_scalar("data/fst_train_loss", float(total), iteration + i)
                        logger.info("Epoch: %d\tBatch Loss: %.4f", epoch, float(total))
                image_steps = [iteration + i for i in range(len(totals))
                               if (iteration + i) % 50 == 0]
                if image_steps and world == 1:
                    # The carry pair of lane 2 (the reference's batch[2]),
                    # clamped to the batch.
                    b = min(2, chunk.shape[1] - 1)
                    with torch.no_grad():
                        preview_in = torch.cat([old_content[b:b + 1], old_stylized[b:b + 1]],
                                               dim=-1)
                        preview = transformer.apply_stacked(params, preview_in)
                    pair = img_utils.concat_images(
                        img_utils.to_uint8(preview.float().cpu().numpy()),
                        img_utils.to_uint8(old_content[b:b + 1].float().cpu().numpy()),
                        axis=1)
                    writer.add_image("data/fst_images", pair, image_steps[0])
                iteration += len(totals)
                frames_in_epoch += len(totals)
                chunks_done += 1
                if step_checkpoint_every and iteration - last_step_save >= step_checkpoint_every:
                    carry = {"old_content": old_content, "old_stylized": old_stylized}
                    if world > 1:
                        # This rank's rows, stamped before the step state:
                        # a stop between the two writes leaves a sidecar of
                        # another iteration, which the resume rejects.
                        ckpt.save_carry_shards(carry, iteration, MODEL_NAME, style_name,
                                               models_path)
                    ckpt.save_step_state(
                        params, ckpt.adam_state_to_tree(params, optimizer), epoch, iteration,
                        MODEL_NAME, style_name, models_path,
                        extra={**step_extra, "batch_in_epoch": batch_idx,
                               "chunk_in_batch": chunks_done},
                        arrays=carry if world == 1 else None)
                    last_step_save = iteration

        dt = time.time() - t0
        if frames_in_epoch:
            logger.info("Epoch %d: %d frame steps in %.1fs (%.1f ms per frame step)",
                        epoch, frames_in_epoch, dt, dt * 1e3 / frames_in_epoch)
        ckpt.save_epoch(params, MODEL_NAME, style_name, epoch, models_path)
        if step_checkpoint_every:
            # Keep the step state ahead of the epoch checkpoint, so that a
            # restart right after an epoch keeps the Adam moments.
            ckpt.save_step_state(
                params, ckpt.adam_state_to_tree(params, optimizer), epoch + 1, iteration,
                MODEL_NAME, style_name, models_path,
                extra={**step_extra, "batch_in_epoch": 0, "chunk_in_batch": 0})
            last_step_save = iteration

    writer.close()
    return params


# ---------------------------------------------------------------------------
# Inference.
# ---------------------------------------------------------------------------


@torch.no_grad()
def _stylize_chunk(params: transformer.TransformerNet, frames: torch.Tensor,
                   old_stylized: torch.Tensor, compute_dtype: Optional[torch.dtype] = None,
                   pad_mode: str = "reflect") -> torch.Tensor:
    """Stylize a [T,B,H,W,3] chunk (uint8 or model-space frames) frame by
    frame, each output the next frame's carry. Returns [T,B,H,W,3] f32.

    The forward runs with ``fixed_order=True``: every op sums in an order
    that does not depend on the batch, so each lane is bit for bit the clip
    stylized alone (the recurrence would carry any difference on)."""
    outs = []
    for t in range(frames.shape[0]):
        frame = img_utils.maybe_normalize_on_device(frames[t])
        old_stylized = transformer.apply(params, torch.cat([frame, old_stylized], dim=-1),
                                         compute_dtype=compute_dtype, pad_mode=pad_mode,
                                         fixed_order=True)
        outs.append(old_stylized)
    return torch.stack(outs)


def stylize_clip(params: transformer.TransformerNet, frames: np.ndarray,
                 precision: str = "f32", pad_mode: str = "reflect") -> np.ndarray:
    """Stylize a whole clip [T,H,W,3] (or [T,B,H,W,3]) on the params'
    device. The first frame pairs with itself."""
    squeeze = frames.ndim == 4
    if squeeze:
        frames = frames[:, None]
    layers.disable_tf32()
    x = torch.from_numpy(np.ascontiguousarray(frames)).to(next(params.parameters()).device)
    # The carry is model-space: a uint8 first frame is normalized here too.
    outs = _stylize_chunk(params, x, img_utils.maybe_normalize_on_device(x[0]),
                          fast._compute_dtype(precision), pad_mode).cpu().numpy()
    return outs[:, 0] if squeeze else outs


class GifWriter:
    """An animated GIF written by Pillow: frames (HWC uint8) appended one at
    a time, the file written on :meth:`close`. As every GIF encoder of
    Pillow does, a frame identical to the one before it is merged into it."""

    def __init__(self, path: str, duration: float, loop: int = 0):
        self.path, self.duration, self.loop = path, duration, loop
        self._frames: List[Image.Image] = []

    def append_data(self, frame: np.ndarray) -> None:
        self._frames.append(Image.fromarray(np.asarray(frame)))

    def close(self) -> None:
        if self._frames:
            first, *rest = self._frames
            first.save(self.path, save_all=True, append_images=rest, duration=self.duration,
                       loop=self.loop)
        self._frames = []


def _open_video_writer(base_path: str, fps: float, logger):
    """An mp4 writer where imageio has an encoder, else a GIF one. Returns
    (writer, path)."""
    try:
        import imageio

        return imageio.get_writer(base_path + ".mp4", fps=fps), base_path + ".mp4"
    except (ValueError, ImportError):
        path = base_path + ".gif"
        logger.warning("No mp4 encoder backend available; writing GIF instead: %s", path)
        return GifWriter(path, duration=1000.0 / fps, loop=0), path


def process_video(
    video_path: str,
    style_name: str = "nsp",
    working_dir: str = "workdir/",
    out_dir: str = "results/",
    fps: float = 24.0,
    params: Optional[transformer.TransformerNet] = None,
    models_path: Optional[str] = None,
    chunk_size: int = 24,
    save_frames: bool = False,
    max_frames: int = video_data.MAX_FRAMES_DEFAULT,
    precision: str = "f32",
    pad_mode: str = "reflect",
    device=constants.DEFAULT_DEVICE,
) -> str:
    """Stylize one video with the latest ``video_st`` weights for
    ``style_name`` (or ``params``): frames are decoded as uint8, stylized a
    chunk at a time, moved back as uint8 once per chunk and written to
    ``{out_dir}/video_st_{style}.mp4`` (or ``.gif``), whose path is
    returned. ``save_frames`` also writes each frame as ``{i}.png`` into
    ``working_dir``, emptied first. A clip with no decodable frame raises."""
    logger = get_logger()
    dev = constants.resolve_device(device)
    compute_dtype = fast._compute_dtype(precision)
    if params is None:
        params, _ = ckpt.load_latest_transformer(MODEL_NAME, style_name, models_path, device=dev)
    layers.disable_tf32()
    video_path = os.path.join(constants.PROJECT_ROOT_PATH, video_path)
    out_dir = os.path.join(constants.PROJECT_ROOT_PATH, out_dir)
    os.makedirs(out_dir, exist_ok=True)
    if save_frames:
        working_dir = os.path.join(constants.PROJECT_ROOT_PATH, working_dir)
        shutil.rmtree(working_dir, ignore_errors=True)
        os.makedirs(working_dir, exist_ok=True)

    reader = video_data.ImageioFrameReader(video_path, normalized=False)
    video_writer, final_path = _open_video_writer(
        os.path.join(out_dir, f"video_st_{style_name}"), fps, logger)

    def frame_stream():
        for _ in range(max_frames):
            f = reader.next_frame()
            if f is None:
                return
            yield f

    logger.info("Starting to process video into stylized frames")
    old_stylized = None
    frame_idx = 0
    try:
        for chunk, _ in _chunk_frames(frame_stream(), chunk_size):
            frames = torch.from_numpy(chunk).to(dev)  # [T, 1, H, W, 3] uint8
            if old_stylized is None:
                old_stylized = img_utils.maybe_normalize_on_device(frames[0])
            outs = _stylize_chunk(params, frames, old_stylized, compute_dtype, pad_mode)
            old_stylized = outs[-1]
            outs_u8 = img_utils.to_uint8_on_device(outs).cpu().numpy()
            for t in range(outs_u8.shape[0]):
                video_writer.append_data(outs_u8[t, 0])
                if save_frames:
                    img_utils.save_uint8(outs_u8[t, 0],
                                         os.path.join(working_dir, f"{frame_idx}.png"))
                frame_idx += 1
            if frame_idx % 50 < chunk_size:
                logger.info(".. processing, currently frame %d", frame_idx)
    finally:
        reader.close()
        video_writer.close()
    if frame_idx == 0:
        if os.path.exists(final_path):
            os.remove(final_path)
        raise ValueError(f"No frames decoded from {video_path}")
    logger.info("Done! Final stylized video can be found in: %s", final_path)
    return final_path


def process_video_dir(
    input_dir: str,
    style_name: str = "nsp",
    out_dir: str = "results/",
    batch_size: int = 4,
    fps: float = 24.0,
    params: Optional[transformer.TransformerNet] = None,
    models_path: Optional[str] = None,
    chunk_size: int = 24,
    max_frames: int = video_data.MAX_FRAMES_DEFAULT,
    precision: str = "f32",
    pad_mode: str = "reflect",
    device=constants.DEFAULT_DEVICE,
    devices: Optional[Sequence] = None,
) -> List[str]:
    """Stylize every video in a directory, ``batch_size`` clips at a time,
    one carry lane each, the lanes split over ``devices``
    (``mesh.serving_placement``; each device keeps its lanes' carries):
    each clip's frames are bit for bit those of the clip stylized alone
    (``_stylize_chunk``), wherever its lane runs. Clips that
    end early keep feeding their last frame and their outputs are dropped; a
    clip that yields no frame rides a zero lane and writes no file;
    a clip that cannot be opened is skipped with a warning. Outputs are
    ``{out_dir}/video_st_{style}_{stem}.mp4`` (or ``.gif``); returns their
    paths."""
    logger = get_logger()
    dev = constants.resolve_device(device)
    compute_dtype = fast._compute_dtype(precision)
    in_dir = os.path.join(constants.PROJECT_ROOT_PATH, input_dir)
    files = sorted(f for f in os.listdir(in_dir) if f.lower().endswith(VIDEO_EXTS))
    if not files:
        raise FileNotFoundError(f"No videos ({'/'.join(VIDEO_EXTS)}) in {in_dir}")
    if params is None:
        params, _ = ckpt.load_latest_transformer(MODEL_NAME, style_name, models_path, device=dev)
    placement = mesh_lib.serving_placement(batch_size, params, devices, dev)
    layers.disable_tf32()
    out_dir = os.path.join(constants.PROJECT_ROOT_PATH, out_dir)
    os.makedirs(out_dir, exist_ok=True)

    outputs: List[str] = []
    t0 = time.time()
    total_written = 0
    for gstart in range(0, len(files), batch_size):
        group, readers = [], []
        for f in files[gstart:gstart + batch_size]:
            try:
                readers.append(video_data.ImageioFrameReader(os.path.join(in_dir, f),
                                                             normalized=False))
                group.append(f)
            except ImportError:
                raise  # no reader for the format: not a bad file
            except Exception as exc:  # noqa: BLE001 - skip-and-continue contract
                logger.warning("Skipping unreadable video %s (%s)", f, exc)
        if not group:
            continue
        # A ragged last group runs at its own size: the JAX engine pads it to
        # batch_size to keep one compiled program and one summation order,
        # and here a lane's result does not depend on the batch size.
        nb = len(group)
        counts = [0] * nb  # real frames read per lane
        done = [False] * nb
        last: List[Optional[np.ndarray]] = [None] * nb

        def rows():
            for _ in range(max_frames):
                any_live = False
                row = []
                for j in range(nb):
                    f = None
                    if not done[j]:
                        f = readers[j].next_frame()
                        if f is None:
                            done[j] = True
                    if f is not None:
                        any_live = True
                        last[j] = f
                        counts[j] += 1
                    row.append(last[j])
                if not any_live:
                    return
                template = next(r for r in row if r is not None)
                yield np.concatenate([r if r is not None else np.zeros_like(template)
                                      for r in row], axis=0)  # [nb, H, W, 3]

        writers, paths = [], []
        for f in group:
            w, p = _open_video_writer(
                os.path.join(out_dir, f"video_st_{style_name}_{os.path.splitext(f)[0]}"),
                fps, logger)
            writers.append(w)
            paths.append(p)

        carries: List[Optional[torch.Tensor]] = [None] * len(placement.devices)
        tstep = 0
        try:
            for chunk, _ in _chunk_frames(rows(), chunk_size):
                outs = []
                # [T, lanes, H, W, 3] uint8: each device's lanes, the same
                # split for every chunk of the group.
                shares = mesh_lib.shard_frames(chunk, placement.devices)
                for i, (replica, frames) in enumerate(zip(placement.replicas, shares)):
                    if carries[i] is None:
                        carries[i] = img_utils.maybe_normalize_on_device(frames[0])
                    out = _stylize_chunk(replica, frames, carries[i], compute_dtype, pad_mode)
                    carries[i] = out[-1]
                    outs.append(img_utils.to_uint8_on_device(out))
                outs_u8 = torch.cat([o.cpu() for o in outs], dim=1).numpy()
                for t in range(outs_u8.shape[0]):
                    for j in range(nb):
                        if tstep + t < counts[j]:
                            writers[j].append_data(outs_u8[t, j])
                            total_written += 1
                tstep += outs_u8.shape[0]
        finally:
            for r in readers:
                r.close()
            for w in writers:
                w.close()
        for j in range(nb):
            if counts[j] == 0:
                logger.warning("No frames decoded from %s; skipping", group[j])
                if os.path.exists(paths[j]):
                    os.remove(paths[j])
            else:
                outputs.append(paths[j])
    dt = time.time() - t0
    logger.info("Stylized %d clips (%d frames) in %.1fs (%.1f fps incl. IO)",
                len(outputs), total_written, dt, total_written / dt if dt else 0.0)
    return outputs


# ---------------------------------------------------------------------------
# The streaming daemon (``video_st serve``).
# ---------------------------------------------------------------------------


class _SlotCarries:
    """Per-stream carries (the previous stylized frame, model space, f32) in
    ONE device buffer per resolution bucket: a slot table.

    A wave assembles its carries with one ``index_select`` and writes its
    outputs back with one ``index_copy_``, instead of a copy per lane. Row 0
    of each buffer is scratch (failed lanes, and lanes that are not fresh
    when fresh streams are seeded, write there); real slots are 1-based.
    Tables start at ``init`` rows and double toward ``cap`` as streams
    appear (sizing them at the cap would hold (cap + 1) x s x s x 12 bytes
    per bucket whether or not any stream exists); growing appends rows, so
    every live slot keeps its index. Streams are LRU-evicted at ``cap``."""

    def __init__(self, cap: int, init: int, device, logger):
        self.cap = cap
        self.init = max(1, min(init, cap))
        self.device = device
        self.logger = logger
        self.lru: "OrderedDict[str, Tuple[int, int]]" = OrderedDict()  # sid -> (bucket, slot)
        self.buffers: Dict[int, torch.Tensor] = {}  # bucket -> [rows + 1, s, s, 3] f32
        self.rows: Dict[int, int] = {}  # bucket -> allocated slots (row 0 excluded)
        self.free: Dict[int, List[int]] = {}  # bucket -> free slot indices

    def __contains__(self, sid) -> bool:
        return sid in self.lru

    def bucket_of(self, sid) -> int:
        return self.lru[sid][0]

    def slot_of(self, sid) -> int:
        return self.lru[sid][1]

    def scratch(self, bucket: int) -> int:
        self._ensure(bucket)
        return 0

    def _ensure(self, bucket: int) -> None:
        if bucket not in self.buffers:
            self.rows[bucket] = self.init
            self.buffers[bucket] = torch.zeros((self.init + 1, bucket, bucket, 3),
                                               dtype=torch.float32, device=self.device)
            self.free[bucket] = list(range(1, self.init + 1))

    def _grow(self, bucket: int) -> None:
        old = self.rows[bucket]
        new = min(self.cap, old * 2)
        self.logger.info("video serve: growing the %dpx slot table %d -> %d rows", bucket, old,
                         new)
        self.buffers[bucket] = torch.cat([self.buffers[bucket], torch.zeros(
            (new - old, bucket, bucket, 3), dtype=torch.float32, device=self.device)])
        self.free[bucket].extend(range(old + 1, new + 1))
        self.rows[bucket] = new

    def index(self, slots) -> torch.Tensor:
        """Slot numbers as a long tensor on the device (from pinned memory on
        a CUDA device: a pageable copy would wait for all queued work)."""
        from styletransfer_tpu_torch.parallel import prefetch

        return prefetch.to_device(np.asarray(slots, dtype=np.int64), self.device)

    def gather(self, bucket: int, idx: torch.Tensor) -> torch.Tensor:
        return self.buffers[bucket].index_select(0, idx)

    def scatter(self, bucket: int, idx: torch.Tensor, rows: torch.Tensor) -> None:
        """Write ``rows`` [B, s, s, 3] at ``idx`` [B] (scratch entries absorb
        lanes whose carry must not move)."""
        self.buffers[bucket].index_copy_(0, idx, rows)

    def allocate(self, sid, bucket: int, protected=()) -> int:
        """A slot for a NEW stream, evicting the LRU stream at capacity.
        ``protected`` sids (the current wave's other lanes, whose slots the
        caller already holds) are skipped (rotated to MRU), or an eviction
        could free a slot mid-wave and hand it to a second lane; a victim
        outside the wave exists, since a wave has at most batch_size <=
        max_streams lanes. The caller commits the sid only once its request
        succeeded; ``release`` returns the slot otherwise."""
        self._ensure(bucket)
        while not self.free[bucket] or len(self.lru) >= self.cap:
            if (not self.free[bucket] and self.rows[bucket] < self.cap
                    and len(self.lru) < self.cap):
                self._grow(bucket)
                continue
            evicted, (eb, eslot) = self.lru.popitem(last=False)
            if evicted in protected:
                self.lru[evicted] = (eb, eslot)  # re-insert at MRU
                continue
            self.free[eb].append(eslot)
            self.logger.warning("video serve: evicted stream %r (max-streams=%d); its next "
                                "frame starts a fresh stream", evicted, self.cap)
        return self.free[bucket].pop()

    def release(self, bucket: int, slot: int) -> None:
        self.free[bucket].append(slot)

    def commit(self, sid, bucket: int, slot: int) -> None:
        """Register or refresh ``sid`` at ``slot`` (its row was already
        written) and mark it most recently used."""
        self.lru[sid] = (bucket, slot)
        self.lru.move_to_end(sid)

    def pop(self, sid) -> None:
        entry = self.lru.pop(sid, None)
        if entry is not None:
            self.free[entry[0]].append(entry[1])

    def clear(self) -> None:
        for bucket in self.buffers:
            self.free[bucket] = list(range(1, self.rows[bucket] + 1))
        self.lru.clear()


def serve_stream_loop(
    style_name: str,
    out_dir: str = "results/",
    params: Optional[transformer.TransformerNet] = None,
    models_path: Optional[str] = None,
    size: Optional[int] = None,
    precision: str = "f32",
    pad_mode: str = "reflect",
    batch_size: int = 1,
    max_streams: int = 64,
    sizes=None,
    stdin=None,
    stdout=None,
    device=constants.DEFAULT_DEVICE,
    devices: Optional[Sequence] = None,
) -> int:
    """Warm-process STREAMING stylization (``video_st serve``): one frame per
    request, the recurrent carry held on the device between requests, so
    consecutive requests of a stream form one temporally consistent clip.

    The protocol of the JAX daemon (``engines/daemon.py``):

    - ``FRAME[\\tOUTPUT[\\tSTREAM[\\tSIZE]]]``: stylize the next frame of
      STREAM (absent: ``"0"``); reply ``OK <out_path>``. The default output
      is ``{out_dir}/video_st_{style}_{stem}.png``, with an ``s{stream}_``
      tag before the stem for streams other than ``"0"``.
    - ``RESET`` drops every stream's carry (``OK RESET``); ``RESET\\t\\tID``
      drops one (``OK RESET ID``). The next frame of a dropped stream pairs
      with itself, like a clip's first frame.
    - ``RELOAD`` swaps in the latest checkpoint (``OK RELOAD epoch=<n>``;
      on failure ``ERR`` and the old parameters keep serving); the carries
      survive it, since the recurrence reads the previous stylized frame as
      data. ``STATS`` answers the latency summary and ``device_rtt_ms``.
    - a blank line or EOF shuts down.

    Each stream's carry lives in a slot table (:class:`_SlotCarries`),
    LRU-capped at ``max_streams`` (an evicted stream restarts on its next
    frame), which must be at least ``batch_size``. A stream's resolution
    bucket (``sizes``; absent: ``size`` or 256) is fixed by its first frame
    and remembered: naming another size for a live stream answers ``ERR``.
    A failed request does not advance its carry.

    ``batch_size > 1`` batches across streams: the requests already queued
    run in waves of at most ``batch_size`` lanes, one stream each (requests
    of one stream serialize into successive waves, since the carry is a
    dependency), one device call per bucket present; a bare ``RESET`` or
    ``RELOAD`` is a barrier that rides a wave alone. The forward runs with
    ``fixed_order=True``, so a lane's bits do not depend on the wave, and a
    stream's outputs are exactly :func:`_stylize_chunk` of its frames at
    every ``batch_size``; a ragged wave runs at its own size (the JAX
    daemon pads it to keep one compiled shape). ``READY`` is printed once
    every bucket's forward has run at one lane and at ``batch_size`` lanes
    (which builds the kernels). A wave's lanes are split over ``devices``
    (``mesh.serving_placement``): the slot table stays on the first, and
    each device steps its lanes' frames and carries with its replica.
    Returns the number of OK responses (bare ``RESET`` in the serial loop
    rides the command path and is not counted)."""
    import re
    import sys

    from styletransfer_tpu_torch.engines import daemon
    from styletransfer_tpu_torch.parallel import prefetch

    logger = get_logger()
    stdout = stdout if stdout is not None else sys.stdout
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    if max_streams < max(batch_size, 1):
        # Fewer slots than lanes per wave would evict carries written in the
        # same wave: every stream would restart each wave while answering OK.
        raise ValueError(f"max_streams must be >= batch_size (and >= 1), got {max_streams} "
                         f"with batch_size={batch_size}")
    dev = constants.resolve_device(device)
    compute_dtype = fast._compute_dtype(precision)
    if params is None:
        params, _ = ckpt.load_latest_transformer(MODEL_NAME, style_name, models_path, device=dev)
    layers.disable_tf32()
    buckets = daemon.normalize_buckets(sizes, size or constants.IMSIZE)
    out_dir = os.path.join(constants.PROJECT_ROOT_PATH, out_dir)
    os.makedirs(out_dir, exist_ok=True)
    # The placement holds the params, so that RELOAD can swap them.
    placement = mesh_lib.serving_placement(batch_size, params, devices, dev)

    def lane_step(params, frame_u8: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
        frame = img_utils.maybe_normalize_on_device(frame_u8)
        return transformer.apply(params, torch.cat([frame, old], dim=-1),
                                 compute_dtype=compute_dtype, pad_mode=pad_mode,
                                 fixed_order=True)

    @torch.no_grad()
    def step(frame_u8: torch.Tensor, old: torch.Tensor):
        """One frame of each lane, as :func:`_stylize_chunk` steps it:
        (model-space output, the next carry, on the slot table's device;
        uint8 output)."""
        out = placement.run(lane_step, frame_u8, old).to(old.device)
        return out, img_utils.to_uint8_on_device(out)

    # The initial table holds one full wave of fresh streams (and at least 8).
    carries = _SlotCarries(max_streams, max(8, batch_size), dev, logger)
    t0 = time.time()
    for s in buckets:
        scratch = carries.scratch(s)
        for b in sorted({1, batch_size}):
            warm = torch.zeros((b, s, s, 3), dtype=torch.uint8, device=dev)
            idx = carries.index([scratch] * b)
            carries.scatter(s, idx, img_utils.maybe_normalize_on_device(warm))
            step(warm, carries.gather(s, idx))[1].cpu()
    logger.info("video serve: warmed %s px %s (batch %d) in %.1fs; ready", buckets, precision,
                batch_size, time.time() - t0)
    print("READY", file=stdout, flush=True)

    def stream_bucket(sid, size_field) -> int:
        """A stream's resolution: fixed by its first frame, remembered after
        (the carry has a shape: changing it mid-stream is an ERR)."""
        want = None
        if size_field:
            try:
                want = int(size_field)
            except ValueError:
                raise ValueError(f"SIZE must be an integer, got {size_field!r}")
            if want not in buckets:
                raise ValueError(f"size {want} not in serving buckets {buckets}")
        if sid in carries:
            have = carries.bucket_of(sid)
            if want is not None and want != have:
                raise ValueError(f"stream {sid!r} is {have}px; RESET it before changing size "
                                 f"to {want}")
            return have
        return want if want is not None else buckets[0]

    def reset_all():
        carries.clear()
        return "RESET"

    def reload():
        new, epoch = ckpt.load_latest_transformer(MODEL_NAME, style_name, models_path,
                                                  device=dev, template=placement.params)
        placement.place_params(new)
        return f"RELOAD epoch={epoch}"

    def out_path(in_path, explicit_out, sid):
        stem = os.path.splitext(os.path.basename(in_path))[0]
        tag = "" if sid == "0" else "s" + re.sub(r"[^\w.-]", "_", sid) + "_"
        return daemon.resolve_out_path(explicit_out, out_dir,
                                       f"video_st_{style_name}_{tag}{stem}.png")

    def load_frame(in_path, bucket):
        return img_utils.load_image_uint8(os.path.join(constants.PROJECT_ROOT_PATH, in_path),
                                          size=bucket)

    def parse(fields):
        if len(fields) > 4:
            raise ValueError(f"expected FRAME[\\tOUTPUT[\\tSTREAM[\\tSIZE]]], got {len(fields)} "
                             "fields")
        return (fields[0], fields[1] if len(fields) > 1 else "",
                (fields[2] if len(fields) > 2 else "") or "0",
                fields[3] if len(fields) > 3 else "")

    def reset(fields, sid):
        if len(fields) == 2 or (len(fields) > 3 and fields[3]):
            # Refuse rather than guess: the serial and batched loops must not
            # part ways on a malformed trailing-tab RESET.
            raise ValueError("RESET takes no OUTPUT/SIZE field; use RESET or RESET\\t\\t<stream>")
        if len(fields) > 2:
            carries.pop(sid)
            return f"RESET {sid}"
        return reset_all()

    def run_lanes(bucket, lanes, protected=()):
        """One device call for ``lanes`` [(result index, in_path, explicit
        out, sid, frame [s, s, 3] uint8)] of one bucket, one stream each:
        fresh streams are seeded with their normalized frame (a clip's first
        frame pairs with itself), one gather assembles the carries, and one
        scatter commits the outputs of the lanes whose PNG was saved.
        ``protected``: the sids of the whole wave, which an eviction must
        not pick. Returns [(result index, payload or exception)]."""
        scratch = carries.scratch(bucket)
        slots, fresh = [], []
        for _, _, _, sid, _ in lanes:
            is_fresh = sid not in carries
            slots.append(carries.allocate(sid, bucket, protected=protected) if is_fresh
                         else carries.slot_of(sid))
            fresh.append(is_fresh)
        try:
            frames = prefetch.to_device(np.stack([lane[4] for lane in lanes]), dev)
            if any(fresh):
                carries.scatter(bucket, carries.index(
                    [s if f else scratch for s, f in zip(slots, fresh)]),
                    img_utils.maybe_normalize_on_device(frames))
            out_model, out_u8 = step(frames, carries.gather(bucket, carries.index(slots)))
            out_u8 = out_u8.cpu().numpy()
        except Exception as exc:  # noqa: BLE001 - answered per lane
            for s, f in zip(slots, fresh):
                if f:
                    carries.release(bucket, s)
            return [(lane[0], exc) for lane in lanes]

        def encode(k):
            _, in_path, explicit_out, sid, _ = lanes[k]
            try:
                path = out_path(in_path, explicit_out, sid)
                img_utils.save_uint8(out_u8[k], path)
                return path
            except Exception as exc:  # noqa: BLE001 - answered per request
                return exc

        outcomes = (list(daemon.io_pool().map(encode, range(len(lanes)))) if len(lanes) > 1
                    else [encode(0)])
        # A failed save does not advance that lane's carry: its row goes to
        # scratch, and a fresh lane's slot is returned.
        carries.scatter(bucket, carries.index(
            [scratch if isinstance(o, Exception) else s for o, s in zip(outcomes, slots)]),
            out_model)
        results = []
        for (i, _, _, sid, _), slot, is_fresh, o in zip(lanes, slots, fresh, outcomes):
            if isinstance(o, Exception):
                if is_fresh:
                    carries.release(bucket, slot)
            else:
                carries.commit(sid, bucket, slot)
            results.append((i, o))
        return results

    def handle(*fields):
        in_path, explicit_out, sid, size_field = parse(fields)
        if in_path == "RESET":
            return reset(fields, sid)
        bucket = stream_bucket(sid, size_field)
        ((_, result),) = run_lanes(bucket, [(0, in_path, explicit_out, sid,
                                             load_frame(in_path, bucket)[0])])
        if isinstance(result, Exception):
            raise result
        return result

    if batch_size == 1:
        return daemon.run_request_loop(handle, stdin=stdin, stdout=stdout, name="video serve",
                                       commands={"RESET": reset_all, "RELOAD": reload},
                                       device=dev)

    def handle_batch(requests):
        results: list = [None] * len(requests)
        pending = list(enumerate(requests))
        while pending:
            # One wave: at most one request per stream (the carry is a
            # dependency within a stream) and at most batch_size lanes;
            # leftovers go to the next wave. A bare RESET touches every stream
            # and a RELOAD swaps the params, so both are barriers: each rides
            # a wave alone, and nothing after one joins an earlier wave.
            wave, rest, seen = [], [], set()
            barrier = False
            for i, fields in pending:
                if barrier:
                    rest.append((i, fields))
                    continue
                if len(fields) == 1 and fields[0] in ("RESET", "RELOAD"):
                    barrier = True
                    (wave if not wave else rest).append((i, fields))
                    continue
                sid = (fields[2] if len(fields) > 2 else "") or "0"
                if sid in seen or len(wave) == batch_size:
                    rest.append((i, fields))
                else:
                    seen.add(sid)
                    wave.append((i, fields))
            pending = rest

            # Parse, commands and stream-bucket bookkeeping in request order
            # (they change shared stream state); frame decode on the IO pool.
            jobs = []
            for i, fields in wave:
                try:
                    in_path, explicit_out, sid, size_field = parse(fields)
                    if in_path == "RELOAD" and len(fields) == 1:
                        results[i] = reload()
                    elif in_path == "RESET":
                        results[i] = reset(fields, sid)
                    else:
                        jobs.append((i, in_path, explicit_out, sid,
                                     stream_bucket(sid, size_field)))
                except Exception as exc:  # noqa: BLE001 - answered per request
                    results[i] = exc

            def decode(job):
                try:
                    return job, load_frame(job[1], job[4])[0], None
                except Exception as exc:  # noqa: BLE001 - answered per request
                    return job, None, exc

            by_bucket: Dict[int, list] = {}
            for (i, in_path, explicit_out, sid, bucket), frame, exc in daemon.io_pool().map(
                    decode, jobs):
                if exc is not None:
                    results[i] = exc
                else:
                    by_bucket.setdefault(bucket, []).append((i, in_path, explicit_out, sid,
                                                             frame))
            for bucket, lanes in by_bucket.items():
                for i, result in run_lanes(bucket, lanes, protected=seen):
                    results[i] = result
        return results

    return daemon.run_batched_request_loop(handle_batch, batch_size, stdin=stdin, stdout=stdout,
                                           name="video serve", device=dev)
