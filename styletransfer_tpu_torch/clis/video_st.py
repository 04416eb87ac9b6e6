"""``video_st`` CLI: video style transfer training and inference.

The JAX package's ``train``, ``convert-video`` and ``convert-dir`` commands,
with the same arguments and output names, plus ``--device`` (default
``cuda``; there is no silent fallback to the CPU). ``train`` does not take
the JAX command's ``--distributed`` and ``--global-batch``, and there is no
``serve`` yet.
"""

import os

import click

from styletransfer_tpu_torch.clis.fast_st import (
    _device_option, _pad_mode_option, _precision_option)


@click.group()
def video_st():
    """Video Style Transfer"""


@video_st.command()
@click.argument("style-image-path")
@click.option("-e", "--epochs", default=50, help="How many epochs the training will take")
@click.option("-b", "--batch-size", default=4, help="Batch size for training")
@click.option("-cw", "--content-weight", default=1,
              help="The weight we will assign to the content loss during the optimization")
@click.option("-sw", "--style-weight", default=100_000,
              help="The weight we will assign to the style loss during the optimization")
@click.option("-tw", "--temporal-weight", default=0.8,
              help="The weight we will assign to the temporal loss during the optimization")
@click.option("--use-pretrained-fast-st", is_flag=True,
              help="States whether we want to start training the video model from "
                   "pretrained fast style transfer weights (which was trained on the "
                   "same style name)")
@click.option("--precision", default="f32", type=click.Choice(["f32", "bf16"]),
              help="Activation precision (params/optimizer stay f32)")
@click.option("--step-checkpoint-every", default=None, type=int,
              help="Also save mid-epoch resumable state every N frame updates")
@_device_option
def train(style_image_path, epochs, batch_size, content_weight, style_weight,
          temporal_weight, use_pretrained_fast_st, precision, step_checkpoint_every, device):
    """
    Perform the training for the video style transfer network. A checkpoint
    will be created at the end of each epoch in the `data/models/` directory.

    Optionally warm-starts from pretrained fast style transfer weights of the
    same style name (latest epoch).
    """
    from styletransfer_tpu_torch import constants
    from styletransfer_tpu_torch.engines import video
    from styletransfer_tpu_torch.utils import images
    from styletransfer_tpu_torch.utils.logging import get_logger

    constants.resolve_device(device)
    style_name = style_image_path.split("/")[-1]
    get_logger().info("Training video style transfer network with style name: %s", style_name)
    style_image = images.load_image(os.path.join(constants.PROJECT_ROOT_PATH, style_image_path))
    video.video_train(
        style_image, style_name=style_name, epochs=epochs, batch_size=batch_size,
        style_weight=style_weight, content_weight=content_weight,
        temporal_weight=temporal_weight, use_pretrained_fast_st=use_pretrained_fast_st,
        precision=precision, step_checkpoint_every=step_checkpoint_every, device=device,
    )


@video_st.command("convert-video")
@click.argument("video-path")
@click.argument("style-name")
@click.option("-o", "--out-dir", default="results/",
              help="The results directory where the converted style will be saved")
@click.option("--fps", default=24.0,
              help="The FPS that will be used when saving the transformed video")
@_precision_option
@_pad_mode_option
@click.option("--save-frames", is_flag=True, default=False,
              help="Also save each stylized frame as {i}.png in --workdir")
@click.option("--workdir", default="workdir/", help="Frame directory for --save-frames")
@_device_option
def convert_video(video_path, style_name, out_dir, fps, precision, pad_mode, save_frames,
                  workdir, device):
    """
    Converts the video at `video-path` using the network pretrained with
    `style-name` and saves the resulting transformed video in `out-dir`.

    A pretrained model should exist in `data/models/` for the specified
    `style-name`.
    """
    from styletransfer_tpu_torch.engines import video

    video.process_video(
        video_path=video_path, style_name=style_name, out_dir=out_dir, fps=fps,
        precision=precision, pad_mode=pad_mode, save_frames=save_frames,
        working_dir=workdir, device=device,
    )


@video_st.command("convert-dir")
@click.argument("input-dir")
@click.argument("style-name")
@click.option("-b", "--batch-size", default=4,
              help="Clips stylized together (one carry lane each; per-clip outputs "
                   "as one at a time)")
@click.option("-o", "--out-dir", default="results/",
              help="The results directory where converted videos are saved")
@click.option("--fps", default=24.0,
              help="The FPS that will be used when saving the transformed videos")
@_precision_option
@_pad_mode_option
@_device_option
def convert_dir(input_dir, style_name, batch_size, out_dir, fps, precision, pad_mode, device):
    """
    Converts every video in `input-dir` (gif/mp4/avi/mov/webm/mkv) using the
    network pretrained with `style-name`, several clips at a time. Outputs
    are saved as `video_st_{style}_{name}.mp4` (or `.gif`) in `out-dir`.
    """
    from styletransfer_tpu_torch.engines import video

    video.process_video_dir(
        input_dir=input_dir, style_name=style_name, batch_size=batch_size, out_dir=out_dir,
        fps=fps, precision=precision, pad_mode=pad_mode, device=device,
    )
