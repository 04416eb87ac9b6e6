"""``fast_st`` CLI: feed-forward style transfer training and inference.

The JAX package's ``train``, ``train-multi``, ``pack-dataset``,
``convert-image``, ``convert-dir``, ``convert-image-multi``, ``serve`` and
``serve-multi`` commands, with the same arguments and output names, plus
``--device`` (default ``cuda``; there is no silent fallback to the CPU) on
all but the host-only ``pack-dataset``. ``train`` and ``train-multi`` take
``--packed`` (a file written by ``pack-dataset``; ``data/packed.py``),
``--distributed`` (one process per GPU over ``torch.distributed``,
launched by ``torchrun`` or with the ``STX_*`` variables;
``parallel/distributed.py``; each rank reads its shard of a packed file)
and ``--global-batch``. The batched commands and daemons serve over every
visible GPU with ``--device cuda`` (one replica each, the batch split over
them; ``parallel/mesh.py``), on stdin or over ``--tcp`` / ``--http``
(``engines/netserve.py``, ``engines/httpserve.py``).
"""

import os

import click

from styletransfer_tpu_torch import constants
from styletransfer_tpu_torch.engines import httpserve, netserve

_device_option = click.option(
    "--device", default=constants.DEFAULT_DEVICE, show_default=True,
    help="Torch device to run on ('cuda', 'cuda:1', 'cpu')",
)
_distributed_option = click.option(
    "--distributed", is_flag=True, default=False,
    help="Join a torch.distributed group for a multi-process run, one process per "
         "device (coordinator/rank from STX_COORDINATOR_ADDRESS / STX_NUM_PROCESSES / "
         "STX_PROCESS_ID, or torchrun's MASTER_ADDR/MASTER_PORT / WORLD_SIZE / RANK / "
         "LOCAL_RANK; BATCH-SIZE is the GLOBAL batch)",
)
_global_batch_option = click.option(
    "--global-batch", default=None, type=str,
    help="DP scaling opt-in: 'auto' treats -b as PER-CHIP batch (global = b x device "
         "count, every chip busy), or an explicit global batch size. Default: -b is the "
         "global batch (reference semantics; extra chips may idle). Adam lr stays at the "
         "reference default either way.",
)


def _training_batch(device, distributed_run, batch_size, global_batch) -> int:
    """Join the process group when asked (before anything touches the
    device; left at exit) and resolve the global batch."""
    import atexit

    from styletransfer_tpu_torch import constants
    from styletransfer_tpu_torch.parallel import distributed, mesh

    constants.resolve_device(device)
    if distributed_run:
        distributed.initialize(device=device)
        atexit.register(distributed.shutdown)
    return mesh.resolve_global_batch(batch_size, global_batch)


_packed_option = click.option(
    "--packed", default=None, type=str,
    help="Path to a packed dataset file (see data.packed.pack_images); zero-decode mmap "
         "reads instead of per-image JPEG decode",
)


def _packed_loaders(packed: str, batch_size: int) -> dict:
    """``train_loader`` / ``test_loader`` over a packed file (relative paths
    from the project root), the rank's shard with its local batch in a
    distributed run; empty without ``--packed``."""
    if not packed:
        return {}
    from styletransfer_tpu_torch import constants
    from styletransfer_tpu_torch.data.packed import get_packed_loader
    from styletransfer_tpu_torch.parallel import distributed

    rank, world = distributed.process_info()
    test_loader, train_loader = get_packed_loader(
        os.path.join(constants.PROJECT_ROOT_PATH, packed),
        batch_size=distributed.local_batch_size(batch_size), test_split=0.10, test_limit=20,
        shard_index=rank, shard_count=world)
    return {"test_loader": test_loader, "train_loader": train_loader}


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
@_packed_option
@click.option("--step-checkpoint-every", default=None, type=int,
              help="Also save mid-epoch resumable state every N steps")
@click.option("--precision", default="f32", type=click.Choice(["f32", "bf16"]),
              help="Activation precision (params/optimizer stay f32)")
@_distributed_option
@_global_batch_option
@_device_option
def train(style_image_path, epochs, batch_size, content_weight, style_weight, packed,
          step_checkpoint_every, precision, distributed, global_batch, device):
    """
    Perform the training for the fast style transfer network. A checkpoint
    will be created at the end of each epoch in the `data/models/` directory.
    """
    from styletransfer_tpu_torch import constants
    from styletransfer_tpu_torch.engines import fast
    from styletransfer_tpu_torch.utils import images
    from styletransfer_tpu_torch.utils.logging import get_logger

    batch_size = _training_batch(device, distributed, batch_size, global_batch)
    style_name = style_image_path.split("/")[-1]
    get_logger().info("Training fast style transfer network with style name: %s", style_name)
    style_image = images.load_image(os.path.join(constants.PROJECT_ROOT_PATH, style_image_path))
    fast.static_train(
        style_image, style_name=style_name, epochs=epochs, batch_size=batch_size,
        style_weight=style_weight, content_weight=content_weight,
        step_checkpoint_every=step_checkpoint_every, precision=precision, device=device,
        **_packed_loaders(packed, batch_size),
    )


@fast_st.command("train-multi")
@click.argument("style-image-paths", nargs=-1, required=True)
@click.option("-n", "--name", default="multi", help="Name for the multi-style model")
@click.option("-e", "--epochs", default=50, help="How many epochs the training will take")
@click.option("-b", "--batch-size", default=4, help="Batch size for training")
@click.option("-cw", "--content-weight", default=1,
              help="The weight we will assign to the content loss during the optimization")
@click.option("-sw", "--style-weight", default=100_000,
              help="The weight we will assign to the style loss during the optimization")
@_packed_option
@click.option("--step-checkpoint-every", default=None, type=int,
              help="Also save mid-epoch resumable state every N steps")
@click.option("--precision", default="f32", type=click.Choice(["f32", "bf16"]),
              help="Activation precision (params/optimizer stay f32)")
@_distributed_option
@_global_batch_option
@_device_option
def train_multi(style_image_paths, name, epochs, batch_size, content_weight, style_weight,
                packed, step_checkpoint_every, precision, distributed, global_batch, device):
    """
    Train ONE network on MULTIPLE styles (conditional instance norm).

    Pass several style image paths; at inference select a style by index or
    blend styles (`convert-image-multi`, `serve-multi`). Checkpoints are
    saved as `fast_multi_st_{name}_epoch{e}.msgpack`.
    """
    import numpy as np

    from styletransfer_tpu_torch import constants
    from styletransfer_tpu_torch.engines import multistyle
    from styletransfer_tpu_torch.utils import images
    from styletransfer_tpu_torch.utils.logging import get_logger

    batch_size = _training_batch(device, distributed, batch_size, global_batch)
    stack = np.concatenate([images.load_image(os.path.join(constants.PROJECT_ROOT_PATH, p))
                            for p in style_image_paths], axis=0)
    get_logger().info("Training multi-style network '%s' on %d styles", name, len(stack))
    multistyle.train(
        stack, style_name=name, epochs=epochs, batch_size=batch_size,
        style_weight=style_weight, content_weight=content_weight,
        step_checkpoint_every=step_checkpoint_every, precision=precision, device=device,
        **_packed_loaders(packed, batch_size),
    )


@fast_st.command("pack-dataset")
@click.argument("image-dir")
@click.argument("out-path")
@click.option("--size", default=256, help="Crop size for packed images")
@click.option("--limit", default=None, type=int, help="Max images to pack")
def pack_dataset(image_dir, out_path, size, limit):
    """
    Pack a directory of images into a single memory-mapped dataset file for
    zero-decode training (use with `fast_st train --packed OUT_PATH`).

    Each image is center-cropped square, resized to SIZE and stored as raw
    uint8; non-RGB and unreadable files are skipped.
    """
    from styletransfer_tpu_torch import constants
    from styletransfer_tpu_torch.data.packed import pack_images
    from styletransfer_tpu_torch.utils.logging import get_logger

    image_dir = os.path.join(constants.PROJECT_ROOT_PATH, image_dir)
    out_path = os.path.join(constants.PROJECT_ROOT_PATH, out_path)
    n = pack_images(image_dir, out_path, size=size, limit=limit)
    get_logger().info("Packed %d images into %s", n, out_path)


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


_out_dir_option = click.option(
    "-o", "--out-dir", default="results/",
    help="Default results directory for requests without an explicit output path")
_size_option = click.option(
    "--size", default=None, type=int,
    help="Working resolution (default 256); all requests are resized to it")


def _transport_options(tcp_extra: str = "", http_extra: str = ""):
    """``--tcp`` and ``--http`` of a serve command (the JAX CLIs' help)."""
    def wrap(fn):
        fn = click.option("--http", default=None, metavar="[HOST:]PORT",
                          help=httpserve.HTTP_HELP + http_extra)(fn)
        return click.option("--tcp", default=None, metavar="[HOST:]PORT",
                            help=netserve.TCP_HELP + tcp_extra)(fn)
    return wrap


def serve_on_transport(run, tcp, http, kind: str) -> None:
    """Run ``run(stdin, stdout)`` on the pipes, ``--tcp`` or ``--http``; a
    conflicting or malformed option is a UsageError before ``run`` starts."""
    try:
        httpserve.serve_transport(run, tcp, http, kind, kind)
    except ValueError as exc:
        raise click.UsageError(str(exc))


@fast_st.command()
@click.argument("style-name")
@_out_dir_option
@_size_option
@click.option("--sizes", default=None, metavar="S1,S2,...",
              help="Multi-resolution serving buckets (e.g. 256,512): each is warmed before "
                   "READY, and a request's optional third field picks its bucket "
                   "(INPUT<TAB>OUTPUT<TAB>512; absent = the first listed). Overrides --size.")
@_precision_option
@_pad_mode_option
@click.option("-b", "--batch-size", default=1, type=click.IntRange(min=1),
              help="Dynamic batching: serve up to N already-queued requests per device call "
                   "(lone requests keep single-request latency; with --sizes, a group runs "
                   "one call per bucket present)")
@_transport_options()
@_device_option
def serve(style_name, out_dir, size, sizes, precision, pad_mode, batch_size, tcp, http, device):
    """
    Warm-process stylization daemon: runs the serving forward once per
    bucket (which builds the kernels), prints `READY`, then stylizes one
    image per stdin line until EOF or a blank line. Each line is
    `INPUT_PATH` or `INPUT_PATH<TAB>OUTPUT_PATH`; each response line is
    `OK <output_path>` or `ERR <input>: <reason>`. A `RELOAD` line swaps in
    the latest checkpoint; a `STATS` line answers the latency summary.
    With `--tcp` or `--http` the same loop serves many clients.
    """
    from styletransfer_tpu_torch.clis import common
    from styletransfer_tpu_torch.engines import fast

    size_list = common.parse_sizes_option(sizes)

    def run(stdin, stdout):
        return fast.serve_loop(
            style_name=style_name, out_dir=out_dir, size=size, precision=precision,
            pad_mode=pad_mode, batch_size=batch_size, sizes=size_list, stdin=stdin,
            stdout=stdout, device=device,
        )

    serve_on_transport(run, tcp, http, "fast")


@fast_st.command("serve-multi")
@click.argument("name")
@click.option("--num-styles", required=True, type=int,
              help="Number of styles the checkpoint was trained with")
@_out_dir_option
@_size_option
@click.option("--sizes", default=None, metavar="S1,S2,...",
              help="Multi-resolution serving buckets (e.g. 256,512): each is warmed before "
                   "READY, and a request's optional fourth field picks its bucket "
                   "(INPUT<TAB>OUTPUT<TAB>STYLE<TAB>512; absent = the first listed). "
                   "Overrides --size.")
@_precision_option
@click.option("-b", "--batch-size", default=1, type=click.IntRange(min=1),
              help="Dynamic batching: serve up to N already-queued requests per device call "
                   "(mixed styles and blends batch together: the style is per-image data)")
@_transport_options()
@_device_option
def serve_multi(name, num_styles, out_dir, size, sizes, precision, batch_size, tcp, http,
                device):
    """
    Warm-process MULTI-STYLE daemon for a network trained by `train-multi`:
    prints `READY`, then stylizes one image per stdin line until EOF or a
    blank line, each request picking its own style or blend as data.

    Each line is `INPUT[<TAB>OUTPUT[<TAB>STYLE]]` where STYLE is an index
    (`2`) or comma-separated blend weights (`0.3,0.7`); leave OUTPUT empty
    (two TABs) to use the default naming. Responses: `OK <output_path>` or
    `ERR <input>: <reason>`. A `RELOAD` line swaps in the latest checkpoint.
    """
    from styletransfer_tpu_torch.clis import common
    from styletransfer_tpu_torch.engines import multistyle

    size_list = common.parse_sizes_option(sizes)

    def run(stdin, stdout):
        return multistyle.serve_loop(
            name=name, num_styles=num_styles, out_dir=out_dir, size=size,
            precision=precision, batch_size=batch_size, sizes=size_list, stdin=stdin,
            stdout=stdout, device=device,
        )

    serve_on_transport(run, tcp, http, "multi")
