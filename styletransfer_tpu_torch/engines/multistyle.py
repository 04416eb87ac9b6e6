"""Multi-style fast transfer, inference: one net, S styles.

The port of the inference half of ``styletransfer_tpu/engines/multistyle.py``:
``stylize`` (a style index per image), ``stylize_blend`` (per-image convex
blends of the styles) and the request parser ``_make_style_parser``, plus
:func:`process_image`, the work of ``fast_st convert-image-multi``. Both
forwards are ``models/multistyle.py`` on the serving kernels, the per-image
affines going to the IN-pad kernel as they are. Multi-style training
(``train-multi``) is not ported yet.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from styletransfer_tpu_torch import ckpt, constants
from styletransfer_tpu_torch.engines.fast import _compute_dtype
from styletransfer_tpu_torch.models import multistyle, transformer
from styletransfer_tpu_torch.ops import layers
from styletransfer_tpu_torch.utils import images as img_utils
from styletransfer_tpu_torch.utils.logging import get_logger

MODEL_NAME = "fast_multi_st"


def stylize(params: transformer.TransformerNet, images: torch.Tensor, style_idx: torch.Tensor,
            compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Stylize a batch with a hard style choice per image."""
    return multistyle.apply(params, images, style_idx, compute_dtype)


def stylize_blend(params: transformer.TransformerNet, images: torch.Tensor,
                  weights: torch.Tensor,
                  compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Stylize a batch with per-image convex style blends [B, S]."""
    return multistyle.apply_blend(params, images, weights, compute_dtype)


def _blend_weights(spec: str, num_styles: int) -> np.ndarray:
    """Comma-separated blend weights -> [num_styles] convex weights. They
    must be finite, non-negative, ``num_styles`` of them, with a positive
    sum; they are normalized. Raises ValueError."""
    w = np.asarray([float(v) for v in spec.split(",")], np.float32)
    if w.shape[0] != num_styles:
        raise ValueError(f"expected {num_styles} blend weights, got {w.shape[0]}")
    # NaN compares False against everything: 'nan,1' would pass the other
    # two checks and serve an all-NaN blend.
    if not np.isfinite(w).all() or w.min() < 0 or w.sum() <= 0:
        raise ValueError("blend weights must be finite and non-negative with a positive sum")
    return w / w.sum()


def _make_style_parser(num_styles: int) -> Callable[[Optional[str]], Tuple[np.ndarray, str]]:
    """A STYLE spec (an index, or comma-separated blend weights) ->
    ([num_styles] convex weights, filename tag): the weights as
    :func:`_blend_weights` takes them; an index must lie in [0,
    num_styles). Raises ValueError."""

    def parse_style(style_spec):
        style_spec = style_spec or "0"
        if "," in style_spec:
            w = _blend_weights(style_spec, num_styles)
            return w, "blend_" + "_".join(f"{v:g}" for v in w)
        idx = int(style_spec)
        if not 0 <= idx < num_styles:
            raise ValueError(f"style index {idx} out of range [0, {num_styles})")
        w = np.zeros((num_styles,), np.float32)
        w[idx] = 1.0
        return w, f"style{idx}"

    return parse_style


def load_params(name: str, num_styles: int, models_path: Optional[str] = None,
                device=constants.DEFAULT_DEVICE) -> transformer.TransformerNet:
    """The latest ``fast_multi_st_{name}`` checkpoint (one the JAX or the
    port's trainer wrote), held to a ``num_styles`` template."""
    template = multistyle.init_params(0, num_styles, device="cpu")
    params, _ = ckpt.load_latest_transformer(MODEL_NAME, name, models_path, device=device,
                                             template=template)
    return params


def process_image(
    image_path: str,
    name: str,
    num_styles: int,
    style_index: int = 0,
    blend: Optional[str] = None,
    out_dir: str = "results/",
    params: Optional[transformer.TransformerNet] = None,
    models_path: Optional[str] = None,
    precision: str = "f32",
    device=constants.DEFAULT_DEVICE,
) -> str:
    """Stylize one image with the latest multi-style weights of ``name``,
    by ``style_index`` or by ``blend`` (comma-separated weights, normalized;
    it overrides the index), as ``convert-image-multi`` does. Writes and
    returns ``{out_dir}/converted_fast_multi_st_{name}_{tag}.png`` (tag
    ``style{i}`` or ``blend``). Raises ValueError on an index out of range
    or weights that :func:`_blend_weights` refuses."""
    dev = constants.resolve_device(device)
    if params is None:
        params = load_params(name, num_styles, models_path, dev)
    if multistyle.num_styles(params) != num_styles:
        raise ValueError(f"the parameters hold {multistyle.num_styles(params)} styles, "
                         f"not {num_styles}")
    layers.disable_tf32()
    img = torch.from_numpy(img_utils.load_image(
        os.path.join(constants.PROJECT_ROOT_PATH, image_path))).to(dev)
    cd = _compute_dtype(precision)
    if blend:
        w = _blend_weights(blend, num_styles)
        out = stylize_blend(params, img, torch.from_numpy(w)[None].to(dev), cd)
        tag = "blend"
    else:
        _make_style_parser(num_styles)(str(style_index))
        out = stylize(params, img, torch.tensor([style_index], device=dev), cd)
        tag = f"style{style_index}"
    out_dir = os.path.join(constants.PROJECT_ROOT_PATH, out_dir)
    os.makedirs(out_dir, exist_ok=True)
    out_file = os.path.join(out_dir, f"converted_fast_multi_st_{name}_{tag}.png")
    img_utils.save_image(out.float().cpu().numpy(), out_file)
    get_logger().info("Saved stylized image to %s", out_file)
    return out_file
