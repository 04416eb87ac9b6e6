"""``fast_st`` CLI: feed-forward style transfer training and inference.

The JAX package's ``train``, ``convert-image``, ``convert-dir`` and
``convert-image-multi`` commands, with the same arguments and output names,
plus ``--device`` (default ``cuda``; there is no silent fallback to the
CPU). ``train`` does not take the JAX command's ``--packed``,
``--distributed`` and ``--global-batch`` yet; ``train-multi`` is not ported
yet.
"""

import os

import click

_device_option = click.option(
    "--device", default="cuda", show_default=True,
    help="Torch device to run on ('cuda', 'cuda:1', 'cpu')",
)
_precision_option = click.option(
    "--precision", default="f32", type=click.Choice(["f32", "bf16"]),
    help="Activation precision",
)
_pad_mode_option = click.option(
    "--pad-mode", default="reflect", type=click.Choice(["reflect", "zeros"]),
    help="Conv padding. Use 'zeros' for checkpoints trained by the ORIGINAL "
         "reference code (its pinned torch 1.1.0 silently used zero padding "
         "despite the 'reflection' string)",
)


@click.group()
def fast_st():
    """Fast Style Transfer"""


@fast_st.command()
@click.argument("style-image-path")
@click.option("-e", "--epochs", default=50, help="How many epochs the training will take")
@click.option("-b", "--batch-size", default=4, help="Batch size for training")
@click.option("-cw", "--content-weight", default=1,
              help="The weight we will assign to the content loss during the optimization")
@click.option("-sw", "--style-weight", default=100_000,
              help="The weight we will assign to the style loss during the optimization")
@click.option("--step-checkpoint-every", default=None, type=int,
              help="Also save mid-epoch resumable state every N steps")
@click.option("--precision", default="f32", type=click.Choice(["f32", "bf16"]),
              help="Activation precision (params/optimizer stay f32)")
@_device_option
def train(style_image_path, epochs, batch_size, content_weight, style_weight,
          step_checkpoint_every, precision, device):
    """
    Perform the training for the fast style transfer network. A checkpoint
    will be created at the end of each epoch in the `data/models/` directory.
    """
    from styletransfer_tpu_torch import constants
    from styletransfer_tpu_torch.engines import fast
    from styletransfer_tpu_torch.utils import images
    from styletransfer_tpu_torch.utils.logging import get_logger

    constants.resolve_device(device)
    style_name = style_image_path.split("/")[-1]
    get_logger().info("Training fast style transfer network with style name: %s", style_name)
    style_image = images.load_image(os.path.join(constants.PROJECT_ROOT_PATH, style_image_path))
    fast.static_train(
        style_image, style_name=style_name, epochs=epochs, batch_size=batch_size,
        style_weight=style_weight, content_weight=content_weight,
        step_checkpoint_every=step_checkpoint_every, precision=precision, device=device,
    )


@fast_st.command("convert-image")
@click.argument("image-path")
@click.argument("style-name")
@click.option("-o", "--out-dir", default="results/",
              help="The results directory where the converted image will be saved")
@click.option("--size", default=None, type=int,
              help="Working resolution (default 256; the net is fully convolutional)")
@_precision_option
@_pad_mode_option
@_device_option
def convert_image(image_path, style_name, out_dir, size, precision, pad_mode, device):
    """
    Converts the image at `image-path` using the network trained with
    `style-name` (latest `data/models/fast_st_{style}_epoch{e}.msgpack`, or a
    reference `.pth`) and saves the result in `out-dir`.
    """
    from styletransfer_tpu_torch.engines import fast

    fast.process_image(
        image_path=image_path, style_name=style_name, out_dir=out_dir,
        size=size, precision=precision, pad_mode=pad_mode, device=device,
    )


@fast_st.command("convert-dir")
@click.argument("input-dir")
@click.argument("style-name")
@click.option("-b", "--batch-size", default=64, help="Inference batch size")
@click.option("-o", "--out-dir", default="results/",
              help="The results directory where converted images are saved")
@click.option("--size", default=None, type=int,
              help="Working resolution (default 256; the net is fully convolutional)")
@_precision_option
@_pad_mode_option
@_device_option
def convert_dir(input_dir, style_name, batch_size, out_dir, size, precision, pad_mode,
                device):
    """
    Converts every image in `input-dir` (png/jpg/jpeg/bmp/webp) with the
    network trained with `style-name`, in batches; outputs are saved as
    `converted_fast_st_{style}_{name}.png` in `out-dir`.
    """
    from styletransfer_tpu_torch.engines import fast

    fast.process_dir(
        input_dir=input_dir, style_name=style_name, batch_size=batch_size,
        out_dir=out_dir, size=size, precision=precision, pad_mode=pad_mode,
        device=device,
    )


@fast_st.command("convert-image-multi")
@click.argument("image-path")
@click.argument("name")
@click.option("--style-index", default=0, help="Which trained style to apply")
@click.option("--blend", default=None,
              help="Comma-separated style weights (overrides --style-index), e.g. '0.5,0.5'")
@click.option("-o", "--out-dir", default="results/")
@click.option("--num-styles", required=True, type=int,
              help="Number of styles the checkpoint was trained with")
@_precision_option
@_device_option
def convert_image_multi(image_path, name, style_index, blend, out_dir, num_styles, precision,
                        device):
    """
    Stylize an image with a multi-style network trained by `train-multi`
    (latest `data/models/fast_multi_st_{name}_epoch{e}.msgpack`), selecting
    a style by index or blending several; saves
    `converted_fast_multi_st_{name}_{style<i>|blend}.png` in `out-dir`.
    """
    from styletransfer_tpu_torch.engines import multistyle

    multistyle.process_image(
        image_path=image_path, name=name, num_styles=num_styles, style_index=style_index,
        blend=blend, out_dir=out_dir, precision=precision, device=device,
    )
