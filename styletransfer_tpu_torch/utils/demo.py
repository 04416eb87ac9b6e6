"""Deterministic demo assets: a content image and a style image.

The port of ``styletransfer_tpu/utils/demo.py``, in numpy and Pillow, so the
images are the JAX package's byte for byte. The reference ships demo data (a
photo and style paintings); these are procedural stand-ins that keep the
repository self-contained where nothing can be downloaded: a smooth
"photo-like" content image and a high-texture "painting-like" style image.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
from PIL import Image

from styletransfer_tpu_torch import constants


def demo_content_image(size: int = 444, seed: int = 7) -> np.ndarray:
    """Smooth scene-like image: sky gradient, blobs, a textured ground."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    sky = np.stack([0.45 + 0.3 * (1 - yy), 0.55 + 0.25 * (1 - yy), 0.8 - 0.2 * yy], -1)
    img = sky
    for _ in range(6):  # rounded foreground blobs
        cx, cy, r = rng.uniform(0.1, 0.9), rng.uniform(0.3, 0.9), rng.uniform(0.05, 0.2)
        color = rng.uniform(0.1, 0.9, size=3).astype(np.float32)
        mask = ((xx - cx) ** 2 + (yy - cy) ** 2) < r**2
        img = np.where(mask[..., None], 0.7 * color + 0.3 * img, img)
    ground = yy > 0.75
    tex = 0.05 * np.sin(40 * np.pi * xx) * np.sin(25 * np.pi * yy)
    img = np.where(ground[..., None], img * 0.6 + 0.2 + tex[..., None], img)
    return np.clip(img, 0, 1).astype(np.float32)


def demo_style_image(size: int = 512, seed: int = 13) -> np.ndarray:
    """Swirly high-frequency 'painting': layered sinusoids and color bands."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    field = np.zeros((size, size), np.float32)
    for _ in range(8):
        fx, fy = rng.uniform(3, 20, size=2)
        ph = rng.uniform(0, 2 * np.pi)
        field += np.sin(2 * np.pi * (fx * xx + fy * yy) + ph + 2.0 * field)
    field = (field - field.min()) / (np.ptp(field) + 1e-6)
    palette = rng.uniform(0, 1, size=(5, 3)).astype(np.float32)
    idx = np.clip((field * len(palette)).astype(int), 0, len(palette) - 1)
    img = palette[idx]
    img += 0.1 * rng.standard_normal(img.shape).astype(np.float32)
    return np.clip(img, 0, 1).astype(np.float32)


def _write_atomic(path: str, arr: np.ndarray) -> None:
    # A temporary name, then a rename: an interrupted save (or two processes
    # racing on first use) never leaves a truncated PNG that later runs would
    # take for the asset.
    tmp = f"{path}.tmp.{os.getpid()}"
    Image.fromarray((arr * 255).astype(np.uint8)).save(tmp, format="PNG")
    os.replace(tmp, path)


def ensure_demo_assets(base_dir: Optional[str] = None) -> dict:
    """Write the demo assets under ``data/`` where they are missing
    (``demo_content.png``, ``styles/demo_style.png``); return their paths."""
    base = base_dir or os.path.join(constants.PROJECT_ROOT_PATH, "data")
    os.makedirs(os.path.join(base, "styles"), exist_ok=True)
    content_path = os.path.join(base, "demo_content.png")
    style_path = os.path.join(base, "styles", "demo_style.png")
    if not os.path.isfile(content_path):
        _write_atomic(content_path, demo_content_image())
    if not os.path.isfile(style_path):
        _write_atomic(style_path, demo_style_image())
    return {"content": content_path, "style": style_path}
