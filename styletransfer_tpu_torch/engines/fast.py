"""Fast (feed-forward) style transfer inference.

The port of the serving half of ``styletransfer_tpu/engines/fast.py``:
``make_serve_fn`` (uint8 in, uint8 out, the normalize and denormalize steps
on the device), ``process_image`` and ``process_dir``. Inputs are decoded
on the host with PIL and moved to the device as uint8.
"""

from __future__ import annotations

import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional

import numpy as np
import torch

from styletransfer_tpu_torch import ckpt, constants
from styletransfer_tpu_torch.models import transformer
from styletransfer_tpu_torch.ops import layers
from styletransfer_tpu_torch.utils import images as img_utils
from styletransfer_tpu_torch.utils.logging import get_logger

MODEL_NAME = "fast_st"

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")

# Decoded batches in flight or buffered at once in process_dir.
PREFETCH_BATCHES = 4

_PRECISIONS = {"f32": None, "bf16": torch.bfloat16}


def make_serve_fn(precision: str = "f32") -> Callable:
    """The uint8-in / uint8-out serving forward: ``serve_fn(params, batch_u8)``
    with ``batch_u8`` [B, H, W, 3] uint8 on the params' device.

    f32 runs in full f32: TF32 is switched off for cuDNN convs and matmuls
    (both default differently), so the output stays within 1/255 of the
    f32 reference."""
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be 'f32' or 'bf16', got {precision!r}")
    compute_dtype = _PRECISIONS[precision]
    layers.disable_tf32()

    def serve_fn(params: transformer.TransformerNet, batch_u8: torch.Tensor) -> torch.Tensor:
        x = img_utils.maybe_normalize_on_device(batch_u8)
        y = transformer.apply(params, x, compute_dtype=compute_dtype)
        return img_utils.to_uint8_on_device(y)

    return serve_fn


def _load_params(params, style_name, models_path, device):
    if params is None:
        params, _ = ckpt.load_latest_transformer(MODEL_NAME, style_name, models_path, device)
    return params


def process_image(
    image_path: str,
    style_name: str = "nsp",
    out_dir: str = "results/",
    params: Optional[transformer.TransformerNet] = None,
    models_path: Optional[str] = None,
    size: Optional[int] = None,
    precision: str = "f32",
    device=constants.DEFAULT_DEVICE,
) -> str:
    """Stylize one image with the latest trained weights for ``style_name``
    (or ``params``). Returns the output path
    (``{out_dir}/converted_fast_st_{style}.png``)."""
    dev = constants.resolve_device(device)
    params = _load_params(params, style_name, models_path, dev)
    input_u8 = img_utils.load_image_uint8(
        os.path.join(constants.PROJECT_ROOT_PATH, image_path),
        size=size or constants.IMSIZE,
    )
    serve_fn = make_serve_fn(precision)
    out_u8 = serve_fn(params, torch.from_numpy(np.array(input_u8)).to(dev)).cpu().numpy()[0]

    out_dir = os.path.join(constants.PROJECT_ROOT_PATH, out_dir)
    os.makedirs(out_dir, exist_ok=True)
    out_file = os.path.join(out_dir, f"converted_fast_st_{style_name}.png")
    img_utils.save_uint8(out_u8, out_file)
    get_logger().info("Saved stylized image to %s", out_file)
    return out_file


def process_dir(
    input_dir: str,
    style_name: str,
    out_dir: str = "results/",
    batch_size: int = 64,
    params: Optional[transformer.TransformerNet] = None,
    models_path: Optional[str] = None,
    size: Optional[int] = None,
    precision: str = "f32",
    device=constants.DEFAULT_DEVICE,
) -> List[str]:
    """Stylize every image in a directory with batched inference.

    One checkpoint load, threaded host decode of up to ``PREFETCH_BATCHES``
    batches ahead of the device, uint8 both ways. Unreadable files are
    skipped with a warning. Outputs are
    ``{out_dir}/converted_fast_st_{style}_{stem}.png``; returns their paths.
    """
    dev = constants.resolve_device(device)
    logger = get_logger()
    in_dir = os.path.join(constants.PROJECT_ROOT_PATH, input_dir)
    files = sorted(f for f in os.listdir(in_dir) if f.lower().endswith(IMAGE_EXTS))
    if not files:
        raise FileNotFoundError(f"No images ({'/'.join(IMAGE_EXTS)}) in {in_dir}")
    params = _load_params(params, style_name, models_path, dev)
    serve_fn = make_serve_fn(precision)
    sz = size or constants.IMSIZE
    out_dir = os.path.join(constants.PROJECT_ROOT_PATH, out_dir)
    os.makedirs(out_dir, exist_ok=True)

    def decode(name):
        try:
            return name, img_utils.load_image_uint8(os.path.join(in_dir, name), size=sz)[0]
        except Exception as exc:  # noqa: BLE001 - skip-and-continue contract
            logger.warning("Skipping unreadable image %s (%s)", name, exc)
            return name, None

    def decode_batch(chunk):
        return [decode(n) for n in chunk]

    batches = [files[i:i + batch_size] for i in range(0, len(files), batch_size)]
    out_paths: List[str] = []
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=8) as pool:
        pending = deque(pool.submit(decode_batch, b) for b in batches[:PREFETCH_BATCHES])
        next_idx = len(pending)
        while pending:
            chunk = pending.popleft().result()
            if next_idx < len(batches):
                pending.append(pool.submit(decode_batch, batches[next_idx]))
                next_idx += 1
            good = [(n, a) for n, a in chunk if a is not None]
            if not good:
                continue
            batch = torch.from_numpy(np.stack([a for _, a in good])).to(dev)
            out = serve_fn(params, batch).cpu().numpy()
            for (name, _), img in zip(good, out):
                stem = os.path.splitext(name)[0]
                path = os.path.join(out_dir, f"converted_fast_st_{style_name}_{stem}.png")
                img_utils.save_uint8(img, path)
                out_paths.append(path)
    dt = time.time() - t0
    logger.info(
        "Stylized %d images in %.1fs (%.1f img/s incl. IO) -> %s",
        len(out_paths), dt, len(out_paths) / dt if dt else 0.0, out_dir,
    )
    return out_paths
