"""``gatys_st`` CLI: optimization-based style transfer.

The JAX package's command with its arguments, defaults and output names
(positional content and style paths, ``-n/--out-name`` default
``gatys_converted.png``, ``-s/--steps`` 300, ``-cw``/``-sw``, a content
directory with ``-b``, blend specs, the optimizer and L-BFGS options,
coarse-to-fine, ``--precision``, ``--size``) and its daemon (``--serve``, on
stdin or over ``--tcp`` / ``--http``), plus ``--device`` (default ``cuda``;
there is no silent fallback to the CPU). The optimizers are ``lbfgs``,
``lbfgs-zoom`` and ``adam`` (``engines/gatys.py``). Both modes log the
L-BFGS history size in effect at start-up, and where it came from.
"""

import os

import click

from styletransfer_tpu_torch import constants
from styletransfer_tpu_torch.clis.fast_st import _transport_options, serve_on_transport


def _log_history(optimizer: str, history_size: int, source: str) -> None:
    """Log the L-BFGS memory a run takes and where it came from."""
    from styletransfer_tpu_torch.ops.lbfgs import ZOOM_MEMORY
    from styletransfer_tpu_torch.utils.logging import get_logger

    if optimizer == "lbfgs":
        get_logger().info("gatys_st: L-BFGS history size %d (%s)", history_size, source)
    elif optimizer == "lbfgs-zoom":
        get_logger().info("gatys_st: lbfgs-zoom keeps optax's fixed memory of %d "
                          "(--history-size and --history-math do not apply)", ZOOM_MEMORY)


@click.command()
@click.argument("content-image-path", required=False)
@click.argument("style-image-path", required=False)
@click.option("-n", "--out-name", default="gatys_converted.png",
              help="The name of the result file (transformed image)")
@click.option("-s", "--steps", default=300,
              help="How many iterations should the optimization go through.")
@click.option("-cw", "--content-weight", default=1,
              help="The weight we will assign to the content loss during the optimization")
@click.option("-sw", "--style-weight", default=100_000,
              help="The weight we will assign to the style loss during the optimization")
@click.option("--optimizer", default="lbfgs",
              type=click.Choice(["adam", "lbfgs", "lbfgs-zoom"]),
              help="Pixel optimizer. lbfgs replicates the reference's torch LBFGS "
                   "contract exactly (~20 inner iterations per step); lbfgs-zoom is optax "
                   "L-BFGS with linesearch (1 update per step, memory 10); adam is Adam over "
                   "the pixels.")
@click.option("-b", "--batch", default=0, type=click.IntRange(min=0),
              help="If CONTENT-IMAGE-PATH is a directory, stylize up to this many images "
                   "from it in one batched optimization of independent lanes (0 = all).")
@click.option("--learning-rate", default=0.05, help="Adam learning rate")
@click.option("--history-size", default=None, type=click.IntRange(min=1),
              help="L-BFGS history length H (lbfgs only). Default: 100 (torch's default, "
                   "the reference contract) for one-shot runs, 16 for --serve daemons. "
                   "Pass a value to override either mode.")
@click.option("--history-math", default="compact", type=click.Choice(["compact", "two_loop"]),
              help="L-BFGS direction computation (lbfgs only): compact is the "
                   "Byrd-Nocedal form, two_loop torch's literal recursion; the same "
                   "operator.")
@click.option("--coarse-steps", default=0, type=click.IntRange(min=0),
              help="Coarse-to-fine: run this many steps at --coarse-scale resolution "
                   "first and warm-start the full run from the upsampled result (0 = off, "
                   "the reference trajectory).")
@click.option("--coarse-scale", default=0.5, type=click.FloatRange(min=0.1, max=0.9),
              help="Resolution factor of the coarse stage")
@click.option("--precision", default="f32", type=click.Choice(["f32", "bf16"]),
              help="VGG tower activation precision (pixels stay f32)")
@click.option("--size", default=None, type=int, help="Working resolution (default 256)")
@click.option("--serve", is_flag=True, default=False,
              help="Warm-process daemon mode: warm up, print READY, then run one "
                   "optimization per stdin line (CONTENT<TAB>STYLE[<TAB>OUTPUT]) until EOF "
                   "or a blank line. The positional image paths are omitted. "
                   "Optimizer/steps/weights are fixed per daemon. With -b N, pending "
                   "requests group into one optimization of up to N independent lanes "
                   "(styles may mix). STYLE may be a blend spec a.png,b.png[:0.3,0.7].")
@_transport_options(
    http_extra=" The content image is the POST body; ?style= names a server-side style "
               "path or blend spec.")
@click.option("--device", default=constants.DEFAULT_DEVICE, show_default=True,
              help="Torch device to run on ('cuda', 'cuda:1', 'cpu')")
def gatys_st(content_image_path, style_image_path, out_name, steps, content_weight,
             style_weight, optimizer, batch, learning_rate, history_size, history_math,
             coarse_steps, coarse_scale, precision, size, serve, tcp, http, device):
    """
    Run the original Gatys style transfer. Both `style-image` and
    `content-image` should be the paths to the image we want to take the
    content from and the one we want to take the style from (respectively).

    CONTENT-IMAGE-PATH may also be a directory: every image in it is
    stylized in one batched optimization (see --batch).

    STYLE-IMAGE-PATH may be a blend spec `a.png,b.png[:0.3,0.7]`: the
    style targets become the weighted average of the listed styles'
    Gram matrices (weights normalized; omitted = equal).
    """
    # The daemon's history defaults to H = 16, the one-shot run keeps torch's
    # H = 100; an explicit --history-size wins in both modes.
    if history_size is None:
        history_size, source = (16, "the daemon's default") if serve else (
            100, "the one-shot default")
    else:
        source = "--history-size"
    _log_history(optimizer, history_size, source)
    if serve:
        if coarse_steps:
            raise click.UsageError("--coarse-steps is not supported in --serve mode (the "
                                   "daemon runs one optimization configuration).")
        from styletransfer_tpu_torch.engines import gatys

        def run(stdin, stdout):
            return gatys.serve_loop(
                steps=steps, style_weight=style_weight, content_weight=content_weight,
                optimizer=optimizer, learning_rate=learning_rate, history_size=history_size,
                history_math=history_math, precision=precision, size=size,
                batch=max(batch, 1), stdin=stdin, stdout=stdout, device=device,
            )

        serve_on_transport(run, tcp, http, "gatys")
        return
    if tcp is not None or http is not None:
        raise click.UsageError("--tcp/--http require --serve (daemon mode).")
    if not content_image_path or not style_image_path:
        raise click.UsageError("CONTENT-IMAGE-PATH and STYLE-IMAGE-PATH are required (or pass "
                               "--serve for daemon mode).")
    import torch

    from styletransfer_tpu_torch import constants
    from styletransfer_tpu_torch.engines import gatys
    from styletransfer_tpu_torch.engines.fast import IMAGE_EXTS
    from styletransfer_tpu_torch.models import vgg
    from styletransfer_tpu_torch.utils import images
    from styletransfer_tpu_torch.utils.logging import get_logger

    dev = constants.resolve_device(device)
    root = constants.PROJECT_ROOT_PATH
    try:
        style_paths, style_ws = gatys.parse_style_spec(style_image_path, root=root)
    except ValueError as exc:
        raise click.UsageError(str(exc))
    style_paths = [os.path.join(root, p) for p in style_paths]
    content_image_path = os.path.join(root, content_image_path)
    imsize = size or constants.IMSIZE

    def load(path):
        return torch.from_numpy(images.load_image(path, size=imsize)).to(dev)

    if os.path.isdir(content_image_path):
        names = sorted(n for n in os.listdir(content_image_path)
                       if n.lower().endswith(IMAGE_EXTS))
        if batch:
            names = names[:batch]
        if not names:
            raise click.ClickException(f"No images found in directory {content_image_path}")
        content_image = torch.cat([load(os.path.join(content_image_path, n)) for n in names])
    else:
        names = [None]
        content_image = load(content_image_path)

    vgg_params = vgg.load_params(device=dev)
    style_image = style_grams = None
    if len(style_paths) > 1:
        style_grams = gatys.blend_grams(
            [vgg.style_gram_targets(vgg_params, load(p)) for p in style_paths], style_ws)
    else:
        style_image = load(style_paths[0])

    converted, _ = gatys.train_gatys(
        vgg_params, style_image=style_image, style_grams=style_grams,
        content_image=content_image, steps=steps, style_weight=style_weight,
        content_weight=content_weight, optimizer=optimizer, learning_rate=learning_rate,
        history_size=history_size, history_math=history_math, coarse_steps=coarse_steps,
        coarse_scale=coarse_scale, precision=precision,
    )
    converted = converted.cpu().numpy()

    out_dir = os.path.join(root, "results")
    os.makedirs(out_dir, exist_ok=True)
    stem, ext = os.path.splitext(out_name)
    used: dict = {}
    for i, name in enumerate(names):
        suffix = f"_{os.path.splitext(name)[0]}" if name is not None else ""
        # a.png and a.jpg share a stem: number the second instead of
        # overwriting the first.
        n_seen = used.get(suffix, 0)
        used[suffix] = n_seen + 1
        if n_seen:
            suffix = f"{suffix}_{n_seen + 1}"
        out_file = os.path.join(out_dir, f"{stem}{suffix}{ext}")
        images.save_image(converted[i:i + 1], out_file)
        get_logger().info("Done! Transformed image has been saved to: %s", out_file)
