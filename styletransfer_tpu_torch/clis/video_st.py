"""``video_st`` CLI: video style transfer training and inference.

The JAX package's ``train``, ``convert-video``, ``convert-dir`` and
``serve`` commands, with the same arguments and output names, plus
``--device`` (default ``cuda``; there is no silent fallback to the CPU).
``train`` takes ``--distributed`` and ``--global-batch`` as ``fast_st
train`` does; ``convert-dir`` and ``serve`` split their lanes over every
visible GPU with ``--device cuda``, and ``serve`` listens on stdin or over
``--tcp`` / ``--http``.
"""

import os

import click

from styletransfer_tpu_torch.clis.fast_st import (
    _device_option, _distributed_option, _global_batch_option, _pad_mode_option,
    _precision_option, _training_batch, _transport_options, serve_on_transport)


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
@_distributed_option
@_global_batch_option
@_device_option
def train(style_image_path, epochs, batch_size, content_weight, style_weight,
          temporal_weight, use_pretrained_fast_st, precision, step_checkpoint_every,
          distributed, global_batch, device):
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

    batch_size = _training_batch(device, distributed, batch_size, global_batch)
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


@video_st.command()
@click.argument("style-name")
@click.option("-o", "--out-dir", default="results/",
              help="Default results directory for requests without an explicit output path")
@click.option("--size", default=None, type=int,
              help="Working resolution (default 256); all frames are resized to it")
@_precision_option
@_pad_mode_option
@click.option("-b", "--batch-size", default=1, type=click.IntRange(min=1),
              help="Cross-STREAM dynamic batching: pending requests for different streams "
                   "run as one device call (same-stream requests serialize: the carry is a "
                   "dependency). 1 = strictly serial.")
@click.option("--max-streams", default=64, type=click.IntRange(min=1),
              help="LRU cap on concurrently-held stream carries")
@click.option("--sizes", default=None, metavar="S1,S2,...",
              help="Multi-resolution serving buckets (e.g. 256,512), each warmed before "
                   "READY. A stream's bucket is fixed by its FIRST frame's optional fourth "
                   "field (FRAME<TAB>OUTPUT<TAB>STREAM<TAB>512; absent = the first listed) "
                   "and remembered: RESET the stream to change it. Overrides --size.")
@_transport_options(
    tcp_extra=" Each connection can carry its own STREAM ids; clients share one id "
              "namespace.",
    http_extra=" Route frames to streams with ?stream=ID; POST /reset[?stream=ID] drops "
               "carries.")
@_device_option
def serve(style_name, out_dir, size, precision, pad_mode, batch_size, max_streams, sizes, tcp,
          http, device):
    """
    Warm-process STREAMING stylization daemon: runs the recurrent step once
    per bucket (which builds the kernels), prints `READY`, then stylizes one
    frame per stdin line until EOF or a blank line. The previous stylized
    frame is kept on the device between requests, so consecutive requests
    form one temporally consistent stream (a live source that cannot be
    stylized as a whole clip).

    Each line is `FRAME_PATH[<TAB>OUTPUT_PATH[<TAB>STREAM]]`; the optional
    STREAM field serves several concurrent streams (each with its own carry)
    through one daemon. `RESET` starts everything fresh;
    `RESET<TAB><TAB>STREAM` resets one stream; `RELOAD` swaps in the latest
    checkpoint (carries survive). Each response line is `OK <output_path>`,
    `OK RESET`, or `ERR <input>: <reason>`.
    """
    from styletransfer_tpu_torch.clis import common
    from styletransfer_tpu_torch.engines import video

    size_list = common.parse_sizes_option(sizes)

    def run(stdin, stdout):
        return video.serve_stream_loop(
            style_name=style_name, out_dir=out_dir, size=size, precision=precision,
            pad_mode=pad_mode, batch_size=batch_size, max_streams=max_streams, sizes=size_list,
            stdin=stdin, stdout=stdout, device=device,
        )

    serve_on_transport(run, tcp, http, "video")
