"""Packed dataset: pre-cropped images in one memory-mapped file.

The port of ``styletransfer_tpu/data/packed.py``, with the same file format
byte for byte, so either package trains on the other's files. Decoding JPEGs
on the host caps a training run's rate; packing the crops once into a flat
uint8 file makes every read a slice of a memory map (no decode, no resize).
The batches stay uint8 up to the device, a quarter of float32's bytes over
the host-to-device copy (``parallel/prefetch.py``), and every train, eval
and preview step normalizes them there
(``utils/images.maybe_normalize_on_device``).

Format: a raw C-order uint8 array file of shape [N, size, size, 3], and
next to it ``<path>.json`` holding {"num_images", "size", "channels",
"dtype"}.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from styletransfer_tpu_torch import constants
from styletransfer_tpu_torch.utils.logging import get_logger


def _header_path(data_path: str) -> str:
    return data_path + ".json"


def _write_header(out_path: str, count: int, size: int) -> None:
    with open(_header_path(out_path), "w") as f:
        json.dump({"num_images": count, "size": size, "channels": 3, "dtype": "uint8"}, f)


def _to_uint8(arr: np.ndarray) -> bytes:
    return (arr * 255.0).round().astype(np.uint8).tobytes()


def pack_images(
    image_dir: str,
    out_path: str,
    size: int = constants.IMSIZE,
    image_names: Optional[Sequence[str]] = None,
    limit: Optional[int] = None,
) -> int:
    """Pack a directory of images into ``out_path`` as uint8 crops (center
    crop, bilinear resize to ``size``). Non-RGB and unreadable files are
    skipped, as the loaders skip them. Returns the number of images packed."""
    from PIL import Image

    from styletransfer_tpu_torch.utils import images as img_utils

    names = image_names or sorted(os.listdir(image_dir))
    if limit:
        names = names[:limit]

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    count = 0
    with open(out_path, "wb") as f:
        for name in names:
            try:
                with Image.open(os.path.join(image_dir, name)) as img:
                    if img.mode != "RGB":
                        continue
                    arr = img_utils.center_crop_resize(img, size)
            except Exception:  # noqa: BLE001 - an unreadable file is skipped
                continue
            if arr.shape[-1] != 3:
                continue
            f.write(_to_uint8(arr))
            count += 1
    _write_header(out_path, count, size)
    get_logger().info("Packed %d images (%dpx) into %s", count, size, out_path)
    return count


def pack_synthetic(out_path: str, num_images: int = 256, size: int = constants.IMSIZE) -> int:
    """Pack the deterministic synthetic corpus (``coco.synthetic_image``),
    for runs without images on disk."""
    from styletransfer_tpu_torch.data.coco import synthetic_image

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "wb") as f:
        for i in range(num_images):
            f.write(_to_uint8(synthetic_image(i, size)))
    _write_header(out_path, num_images, size)
    return num_images


class _PackedView:
    """An index-remapped view of a PackedDataset (the test and train splits)."""

    def __init__(self, base: "PackedDataset", indices):
        self._base = base
        self._indices = list(indices)

    def __len__(self) -> int:
        return len(self._indices)

    def load(self, idx: int) -> np.ndarray:
        return self._base.load(self._indices[idx])


def get_packed_loader(
    data_path: str,
    batch_size: int = 4,
    test_split: float = 0.10,
    test_limit: Optional[int] = None,
    train_limit: Optional[int] = None,
    seed: int = 0,
    shard_index: int = 0,
    shard_count: int = 1,
) -> Tuple["DataLoader", "DataLoader"]:  # noqa: F821 - coco.DataLoader
    """``(test_loader, train_loader)`` over a packed file, split as
    ``coco.get_coco_loader`` splits a directory (the first 10% are the test
    set, capped at ``test_limit``), with the same seeds (``seed``, ``seed +
    1``). Both loaders take the rank's shard (``shard_index`` of
    ``shard_count``): each rank evaluates a disjoint slice of the test set,
    as it trains on one of the train set. Batches are uint8."""
    from styletransfer_tpu_torch.data.coco import DataLoader

    ds = PackedDataset(data_path)
    split_idx = int(len(ds) * test_split)
    test_ds = _PackedView(ds, range(0, min(split_idx, test_limit or split_idx)))
    train_idx = range(split_idx, len(ds))
    if train_limit:
        train_idx = range(split_idx, min(split_idx + train_limit, len(ds)))
    train_ds = _PackedView(ds, train_idx)
    shard = dict(shard_index=shard_index, shard_count=shard_count)
    test_loader = DataLoader(test_ds, batch_size, shuffle=True, drop_last=True, seed=seed,
                             **shard)
    train_loader = DataLoader(train_ds, batch_size, shuffle=True, drop_last=True,
                              seed=seed + 1, **shard)
    return test_loader, train_loader


class PackedDataset:
    """A memory-mapped packed file; ``load(i)`` returns the raw uint8
    [size, size, 3] row of the map. Works with ``coco.DataLoader``."""

    def __init__(self, data_path: str):
        with open(_header_path(data_path)) as f:
            hdr = json.load(f)
        self.size = hdr["size"]
        self.num_images = hdr["num_images"]
        shape = (self.num_images, self.size, self.size, hdr["channels"])
        self._data = np.memmap(data_path, dtype=np.uint8, mode="r", shape=shape)

    def __len__(self) -> int:
        return self.num_images

    def load(self, idx: int) -> np.ndarray:
        return self._data[idx]
