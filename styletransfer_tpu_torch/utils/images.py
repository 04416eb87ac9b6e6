"""Image loading / saving with the reference's transform semantics.

The port of what fast_st, video and Gatys need from
``styletransfer_tpu/utils/images.py``: the shared center-crop +
bilinear-resize recipe (host side, PIL), normalized float and uint8 loading
(of image files and of decoded video frames),
atomic saving (of uint8 arrays and of model-space float images), the numpy
normalize / denormalize and preview helpers, and the on-device normalize /
denormalize steps that let serving move uint8 both ways. Layout is NHWC.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Tuple

import numpy as np
import torch
from PIL import Image

from styletransfer_tpu_torch import constants

_MEAN = np.asarray(constants.IMAGENET_MEAN, dtype=np.float32)
_STD = np.asarray(constants.IMAGENET_STD, dtype=np.float32)


def _center_crop_resize_pil(image: "Image.Image", size: int) -> "Image.Image":
    """The one crop recipe every load path shares: center-crop to the min
    dimension's square, with torchvision CenterCrop's offsets
    ``int(round(delta / 2.))`` (banker's rounding, not floor: they differ by
    one pixel when delta % 4 == 3), then bilinear-resize to ``size``."""
    w, h = image.size
    side = min(w, h)
    left = int(round((w - side) / 2.0))
    top = int(round((h - side) / 2.0))
    image = image.crop((left, top, left + side, top + side))
    return image.resize((size, size), Image.BILINEAR)


def center_crop_resize(image: "Image.Image", size: int = constants.IMSIZE) -> np.ndarray:
    """Center-crop to a square of the min dimension, then bilinear-resize
    (torchvision ``CenterCrop(min_dim) -> Resize(size)``). Returns float32
    HWC in [0, 1]; a grayscale image keeps a channel axis of 1."""
    arr = np.asarray(_center_crop_resize_pil(image, size), dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def normalize(image: np.ndarray) -> np.ndarray:
    """ImageNet-normalize a [0, 1]-scaled NHWC (or HWC) image."""
    return (image - _MEAN) / _STD


def denormalize(image: np.ndarray) -> np.ndarray:
    """Invert :func:`normalize`."""
    return image * _STD + _MEAN


def load_image(image_path: str, size: int = constants.IMSIZE) -> np.ndarray:
    """Load an image as ``[1, size, size, 3]`` float32: decode, convert to
    RGB, center-crop, resize, scale to [0, 1] and ImageNet-normalize."""
    with Image.open(image_path) as img:
        arr = center_crop_resize(img.convert("RGB"), size)
    return normalize(arr)[None, ...]


def concat_images(im1: np.ndarray, im2: np.ndarray, axis: int = -2) -> np.ndarray:
    """Concatenate two HWC or NHWC images, along the width by default."""
    return np.concatenate([np.asarray(im1), np.asarray(im2)], axis=axis)


def to_uint8(image: np.ndarray) -> np.ndarray:
    """A model-space image (HWC, or NHWC whose first image is taken) as
    displayable HWC uint8: denormalize, clip to [0, 1], scale and round."""
    arr = np.asarray(image, dtype=np.float32)
    if arr.ndim == 4:
        arr = arr[0]
    return np.round(np.clip(denormalize(arr), 0.0, 1.0) * 255.0).astype(np.uint8)


def save_image(image: np.ndarray, path: str) -> None:
    """Save a model-space float image (HWC, or NHWC whose first image is
    taken) to ``path`` as uint8, creating its directory."""
    out_dir = os.path.dirname(path)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    save_uint8(to_uint8(image), path)


def from_array(frame: np.ndarray, size: int = constants.IMSIZE) -> np.ndarray:
    """A decoded HWC uint8 frame (e.g. of a video) as :func:`load_image`
    gives an image: ``[1, size, size, 3]`` float32, normalized."""
    return normalize(center_crop_resize(Image.fromarray(frame).convert("RGB"), size))[None, ...]


def from_array_uint8(frame: np.ndarray, size: int = constants.IMSIZE) -> np.ndarray:
    """A decoded HWC frame as ``[1, size, size, 3]`` uint8, cropped and
    resized as :func:`from_array`, not normalized: the video serving input."""
    img = _center_crop_resize_pil(Image.fromarray(frame).convert("RGB"), size)
    return np.asarray(img, dtype=np.uint8)[None, ...]


def load_image_uint8(image_path: str, size: int = constants.IMSIZE) -> np.ndarray:
    """Load an image as ``[1, size, size, 3]`` uint8 (RGB, cropped and
    resized, not normalized): the serving input path."""
    with Image.open(image_path) as img:
        img = img.convert("RGB")
        img = _center_crop_resize_pil(img, size)
        return np.asarray(img, dtype=np.uint8)[None, ...]


def save_uint8(arr: np.ndarray, path: str) -> None:
    """Atomically save a uint8 [H, W, 3] array as an image.

    Write to a temporary name (pid and thread id, so two writers of one path
    never share it) in the target directory, then rename: a reader never sees
    a partly written file at the final path."""
    if arr.ndim == 4:
        arr = arr[0]
    base, ext = os.path.splitext(path)
    tmp = f"{base}.tmp-{os.getpid()}-{threading.get_ident()}{ext or '.png'}"
    try:
        Image.fromarray(arr).save(tmp)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


# ImageNet mean and std by device, made once: a copy from the host at every
# call would also stop the forward from being captured in a CUDA graph.
_STATS: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _stats(device) -> Tuple[torch.Tensor, torch.Tensor]:
    device = torch.device(device)
    if device not in _STATS:
        _STATS[device] = (
            torch.tensor(constants.IMAGENET_MEAN, dtype=torch.float32, device=device),
            torch.tensor(constants.IMAGENET_STD, dtype=torch.float32, device=device))
    return _STATS[device]


def maybe_normalize_on_device(batch: torch.Tensor) -> torch.Tensor:
    """ImageNet-normalize a raw uint8 NHWC batch where it lies; pass float
    batches through."""
    if batch.dtype != torch.uint8:
        return batch
    mean, std = _stats(batch.device)
    return (batch.float() / 255.0 - mean) / std


def to_uint8_on_device(image: torch.Tensor) -> torch.Tensor:
    """Denormalize, clamp to the legal RGB range and scale to uint8.

    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    mean, std = _stats(image.device)
    arr = torch.clamp(image.float() * std + mean, 0.0, 1.0)
    return torch.round(arr * 255.0).to(torch.uint8)
