"""SANet arbitrary style transfer: the serving forward and the directory
command (``fast_st convert-sanet``).

``make_serve_fn`` gives the uint8-in / uint8-out forward of
``models/sanet.py::apply`` on the device: a content batch and a style batch
(one style per pair, or one for all), the output
``round(clamp(g(m), 0, 1) * 255)``. ``process_dir`` runs it over a
directory with one style image, on the batched decode and encode path of
``engines/fast.py::stylize_files``. Weights are the released files' layout,
``vgg_normalised.pth``, ``decoder_iter_500000.pth`` and
``transformer_iter_500000.pth`` in one directory (:func:`load_params`).
"""

from __future__ import annotations

import os
from typing import Callable, List

import numpy as np
import torch

from styletransfer_tpu_torch import constants
from styletransfer_tpu_torch.engines import fast
from styletransfer_tpu_torch.models import sanet
from styletransfer_tpu_torch.ops import layers
from styletransfer_tpu_torch.utils import images as img_utils
from styletransfer_tpu_torch.utils import profiling

VGG_FILE = "vgg_normalised.pth"
DECODER_FILE = "decoder_iter_500000.pth"
TRANSFORMER_FILE = "transformer_iter_500000.pth"
FORWARD_SPAN = "sanet.forward"


def make_serve_fn(precision: str = "f32") -> Callable:
    """``serve_fn(params, content_u8, style_u8)``: ``content_u8`` [B, H, W,
    3] and ``style_u8`` [B or 1, Hs, Ws, 3] uint8 on the params' device
    (sides multiples of 16) -> [B, H, W, 3] uint8. f32 with TF32 off for the
    library's matmuls; bf16 is not implemented. A call is the span
    ``sanet.forward``."""
    if precision == "bf16":
        raise NotImplementedError("SANet serves in f32 only: there is no bf16 route")
    if precision != "f32":
        raise ValueError(f"precision must be 'f32' or 'bf16', got {precision!r}")
    layers.disable_tf32()

    def serve_fn(params: sanet.SANetNet, content_u8: torch.Tensor,
                 style_u8: torch.Tensor) -> torch.Tensor:
        with profiling.span(FORWARD_SPAN):
            y = sanet.apply(params, content_u8.float() / 255.0, style_u8.float() / 255.0)
            return torch.round(torch.clamp(y, 0.0, 1.0) * 255.0).to(torch.uint8)

    return serve_fn


def load_params(weights_dir: str, device=constants.DEFAULT_DEVICE) -> sanet.SANetNet:
    """The parameters of ``weights_dir``'s three released files."""
    def load(name):
        path = os.path.join(weights_dir, name)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no SANet weights file {path}")
        return torch.load(path, map_location="cpu", weights_only=True)

    return sanet.import_torch_state_dict(load(VGG_FILE), load(DECODER_FILE),
                                         load(TRANSFORMER_FILE), device=device)


def process_dir(
    input_dir: str,
    style_image: str,
    weights_dir: str,
    out_dir: str = "results/",
    batch_size: int = 4,
    size: int = 1024,
    device=constants.DEFAULT_DEVICE,
) -> List[str]:
    """Stylize every image of ``input_dir`` with ``style_image``, ``batch_size``
    at a time, both cropped and resized to ``size`` (a multiple of 16).
    Outputs are ``{out_dir}/converted_sanet_{style stem}_{stem}.png``;
    returns their paths. Relative paths are from the project root."""
    root = constants.PROJECT_ROOT_PATH
    serve = make_serve_fn()
    dev = constants.resolve_device(device)
    in_dir = os.path.join(root, input_dir)
    files = fast.image_files(in_dir)
    params = load_params(os.path.join(root, weights_dir), dev)
    style = torch.from_numpy(np.array(
        img_utils.load_image_uint8(os.path.join(root, style_image), size=size))).to(dev)
    style_name = os.path.splitext(os.path.basename(style_image))[0]

    def run(batch: np.ndarray) -> np.ndarray:
        return serve(params, torch.from_numpy(batch).to(dev), style).cpu().numpy()

    return fast.stylize_files(in_dir, files, batch_size, size, run, os.path.join(root, out_dir),
                              lambda stem: f"converted_sanet_{style_name}_{stem}.png")
