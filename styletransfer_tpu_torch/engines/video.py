"""Video style transfer: temporally consistent training and inference.

The port of ``styletransfer_tpu/engines/video.py`` for one process. The
model is the 6-channel transform net fed [current frame, previous stylized
frame] on channels.

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

Inference (:func:`stylize_clip`, :func:`process_video`,
:func:`process_video_dir`) runs the serving forward (``transformer.apply``:
the conv3x3_valid and IN-pad kernels, or with ``pad_mode="zeros"`` the
conv3x3_flat and fused-IN kernels) frame by frame, each output fed back as
the next frame's carry. Output videos are mp4 where imageio has an encoder,
GIF (through Pillow) otherwise.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
from PIL import Image

from styletransfer_tpu_torch import ckpt, constants
from styletransfer_tpu_torch.data import video as video_data
from styletransfer_tpu_torch.engines import fast
from styletransfer_tpu_torch.models import transformer, vgg
from styletransfer_tpu_torch.ops import layers, losses
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
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """The per-frame objective: style + content + total variation +
    temporal. Returns ``(total, (transformed, metrics))``."""
    frame = img_utils.maybe_normalize_on_device(frame)
    net_input = torch.cat([frame, old_stylized], dim=-1)
    transformed = transformer.apply_stacked(params, net_input, compute_dtype)
    perceptual, comps = vgg.perceptual_loss(
        vgg_params, transformed, frame, style_grams,
        style_weight=style_weight, content_weight=content_weight,
        compute_dtype=compute_dtype,
    )
    tv = losses.total_variation_loss(transformed)
    temporal = losses.temporal_loss(old_content, old_stylized, frame, transformed,
                                    temporal_weight)
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
    to a [T] f32 tensor on the frames' device."""
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
                style_weight, content_weight, temporal_weight, compute_dtype)
            total.backward()
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
    layout is the JAX trainer's single-process one: either package resumes
    the other's state."""
    logger = get_logger()
    dev = constants.resolve_device(device)
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
                                          compute_dtype=compute_dtype)
    optimizer = opt(params)
    if video_loader is None:
        video_loader = video_data.VideoDataset(batch_size=batch_size)
    logger.info("Training video_st with Adam on %s (%s)", dev, precision)

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
            if resume_chunks and {"old_content", "old_stylized"} <= set(state["arrays"]):
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
        for batch_idx, readers in enumerate(video_loader):
            if batch_idx < skip_batches:  # trained before the stop
                for r in readers:
                    r.close()
                continue
            frame_iter = video_data.iterate_on_video_batches(readers, max_frames)
            # The first frame of each video batch is its own carry (old =
            # [frame, frame]); it is also the first frame trained on.
            old_content = old_stylized = None
            chunks_done = 0
            for chunk, valid in _chunk_frames(frame_iter, chunk_size):
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
                if image_steps:
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
                    ckpt.save_step_state(
                        params, ckpt.adam_state_to_tree(params, optimizer), epoch, iteration,
                        MODEL_NAME, style_name, models_path,
                        extra={**step_extra, "batch_in_epoch": batch_idx,
                               "chunk_in_batch": chunks_done},
                        arrays={"old_content": old_content, "old_stylized": old_stylized})
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
) -> List[str]:
    """Stylize every video in a directory, ``batch_size`` clips at a time,
    one carry lane each: each clip's frames are bit for bit those of the
    clip stylized alone (``_stylize_chunk``). Clips that
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

        old_stylized = None
        tstep = 0
        try:
            for chunk, _ in _chunk_frames(rows(), chunk_size):
                frames = torch.from_numpy(chunk).to(dev)  # [T, nb, H, W, 3] uint8
                if old_stylized is None:
                    old_stylized = img_utils.maybe_normalize_on_device(frames[0])
                outs = _stylize_chunk(params, frames, old_stylized, compute_dtype, pad_mode)
                old_stylized = outs[-1]
                outs_u8 = img_utils.to_uint8_on_device(outs).cpu().numpy()
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
