"""COCO image dataset and a batched loader with threaded host decode.

The port of ``styletransfer_tpu/data/coco.py``, in numpy and ``random`` as
there, so the synthetic images and the batch order are the JAX package's
exactly. Batches are float32 ``[B, size, size, 3]`` numpy arrays,
ImageNet-normalized; :mod:`styletransfer_tpu_torch.parallel.prefetch` moves
them to the device.

Contracts kept from the reference:
- 10% test / 90% train split by directory listing order, the test set
  capped at ``test_limit``;
- non-RGB and unreadable images are replaced by another image rather than
  failing the epoch;
- ``drop_last=True`` and a shuffle per epoch.

:func:`get_coco_loader` first calls ``download.download_coco_images``, as
the JAX loader does: it fetches the images that ``image_info_test2017.json``
lists when that manifest is in ``data/coco_dataset/`` (it is not shipped),
and otherwise returns at once. With no images on disk the loaders fall back
to a deterministic synthetic corpus of procedural images.
"""

from __future__ import annotations

import os
import random
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from styletransfer_tpu_torch import constants
from styletransfer_tpu_torch.data import download
from styletransfer_tpu_torch.utils import images as img_utils
from styletransfer_tpu_torch.utils.logging import get_logger

IMAGE_FOLDER_PATH = os.path.join("data/coco_dataset/", "images")


def _abspath(path: str) -> str:
    return path if os.path.isabs(path) else os.path.join(constants.PROJECT_ROOT_PATH, path)


def synthetic_image(index: int, size: int = constants.IMSIZE) -> np.ndarray:
    """Procedural RGB image: mixed gradients and a sinusoidal texture,
    float32 HWC in [0, 1], determined by ``index``."""
    rng = np.random.default_rng(index)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    freqs = rng.uniform(2, 12, size=(3, 2))
    phases = rng.uniform(0, 2 * np.pi, size=(3,))
    base = rng.uniform(0.2, 0.8, size=(3,))
    chans = [
        base[c]
        + 0.3 * np.sin(2 * np.pi * (freqs[c, 0] * xx + freqs[c, 1] * yy) + phases[c])
        + 0.2 * (xx * rng.uniform(-1, 1) + yy * rng.uniform(-1, 1))
        for c in range(3)
    ]
    arr = np.stack(chans, axis=-1)
    return np.clip(arr, 0.0, 1.0).astype(np.float32)


class SyntheticDataset:
    """Deterministic stand-in corpus with the CocoDataset interface.
    ``seed_offset`` shifts the image indices, so a test split can be
    disjoint from the train split."""

    def __init__(self, num_images: int = 256, size: int = constants.IMSIZE,
                 seed_offset: int = 0):
        self.num_images = num_images
        self.size = size
        self.seed_offset = seed_offset

    def __len__(self) -> int:
        return self.num_images

    def load(self, idx: int) -> Optional[np.ndarray]:
        arr = synthetic_image(self.seed_offset + idx, self.size)
        return np.asarray(img_utils.normalize(arr), dtype=np.float32)


class CocoDataset:
    """Image-directory dataset of normalized [size, size, 3] arrays.
    ``load`` returns None for an image to discard (non-RGB or unreadable)."""

    def __init__(
        self,
        image_names: Optional[Sequence[str]] = None,
        image_limit: Optional[int] = None,
        image_dir: str = IMAGE_FOLDER_PATH,
        size: int = constants.IMSIZE,
    ):
        self.image_dir = _abspath(image_dir)
        if image_names is None:
            image_names = sorted(os.listdir(self.image_dir))
        self.images: List[str] = list(image_names)
        if image_limit:
            self.images = self.images[:image_limit]
        self.size = size

    def __len__(self) -> int:
        return len(self.images)

    def load(self, idx: int) -> Optional[np.ndarray]:
        path = os.path.join(self.image_dir, self.images[idx])
        try:
            with Image.open(path) as img:
                if img.mode != "RGB":
                    return None
                arr = img_utils.center_crop_resize(img, self.size)
        except Exception:  # noqa: BLE001 - an unreadable or corrupt file is skipped
            return None
        if arr.shape[-1] != 3:
            return None
        return np.asarray(img_utils.normalize(arr), dtype=np.float32)


class DataLoader:
    """Batched loader with a per-epoch shuffle, drop_last and threaded decode.

    Yields float32 ``[batch, size, size, 3]`` numpy arrays. A thread pool
    decodes a bounded window ahead of the consumer. ``shard_index`` /
    ``shard_count`` give each rank of a distributed run a disjoint strided
    slice of the corpus; every rank shuffles with the same seed, so the
    epochs line up."""

    def __init__(
        self,
        dataset,
        batch_size: int = 4,
        shuffle: bool = True,
        drop_last: bool = True,
        num_threads: int = 4,
        seed: int = 0,
        shard_index: int = 0,
        shard_count: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_threads = num_threads
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.seed = seed
        self._epoch = 0
        self._skip_batches = 0

    def __len__(self) -> int:
        n = len(range(self.shard_index, len(self.dataset), self.shard_count))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _indices(self, epoch: Optional[int] = None) -> List[int]:
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            # The order of epoch e depends only on (seed, e), so a resume can
            # rebuild where an epoch left off (see set_position).
            e = self._epoch if epoch is None else epoch
            random.Random((self.seed << 32) ^ e).shuffle(idx)
        if self.shard_count > 1:
            idx = idx[self.shard_index::self.shard_count]
        return idx

    def set_position(self, epoch: int, batches_consumed: int) -> None:
        """Resume mid-epoch: the next ``__iter__`` yields epoch ``epoch``'s
        order with its first ``batches_consumed`` batches skipped, without
        decoding them."""
        self._epoch = epoch
        self._skip_batches = batches_consumed

    def __iter__(self) -> Iterator[np.ndarray]:
        indices = self._indices()
        if self._skip_batches:
            # Index slots are skipped, not decoded batches: a substituted bad
            # image can shift a batch's contents, but no trained batch repeats.
            indices = indices[self._skip_batches * self.batch_size :]
            self._skip_batches = 0
        self._epoch += 1
        bs = self.batch_size
        with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            lookahead = max(4 * bs, 2 * self.num_threads)
            it = iter(indices)
            window: deque = deque()
            for i in it:
                window.append(pool.submit(self.dataset.load, i))
                if len(window) >= lookahead:
                    break
            batch: List[np.ndarray] = []
            fallback: Optional[np.ndarray] = None
            # Bad images before the first good one are counted and filled in
            # once a good image exists, so they never shrink the epoch.
            pending = 0
            while window:
                fut = window.popleft()
                nxt = next(it, None)
                if nxt is not None:
                    window.append(pool.submit(self.dataset.load, nxt))
                arr = fut.result()
                if arr is None:
                    if fallback is None:
                        pending += 1
                        continue
                    arr = fallback
                fallback = arr
                for a in [arr] * (pending + 1):
                    batch.append(a)
                    if len(batch) == bs:
                        yield np.stack(batch)
                        batch = []
                pending = 0
            if batch and not self.drop_last:
                yield np.stack(batch)


def get_coco_loader(
    batch_size: int = 4,
    test_split: float = 0.10,
    test_limit: Optional[int] = None,
    train_limit: Optional[int] = None,
    image_dir: str = IMAGE_FOLDER_PATH,
    seed: int = 0,
    shard_index: int = 0,
    shard_count: int = 1,
) -> Tuple[DataLoader, DataLoader]:
    """``(test_loader, train_loader)``, split as the reference's
    ``get_coco_loader``; the synthetic corpus (256 train images, a disjoint
    test split) when the directory holds no images. Both loaders take the
    rank's shard (``shard_index`` of ``shard_count``)."""
    logger = get_logger()
    download.download_coco_images()
    abs_dir = _abspath(image_dir)
    all_images = sorted(os.listdir(abs_dir)) if os.path.isdir(abs_dir) else []

    if not all_images:
        logger.warning(
            "No COCO images found in %s; using the deterministic synthetic "
            "dataset (256 images).", abs_dir,
        )
        n_train = train_limit or 256
        test_ds = SyntheticDataset(num_images=max(test_limit or 20, 8), seed_offset=n_train)
        train_ds = SyntheticDataset(num_images=n_train)
    else:
        split_idx = int(len(all_images) * test_split)
        test_ds = CocoDataset(all_images[:split_idx], test_limit, image_dir)
        train_ds = CocoDataset(all_images[split_idx:], train_limit, image_dir)
        logger.info("Train set has %d entries", len(train_ds))
        logger.info("Test set has %d entries", len(test_ds))

    shard = dict(shard_index=shard_index, shard_count=shard_count)
    test_loader = DataLoader(test_ds, batch_size, shuffle=True, drop_last=True, seed=seed,
                             **shard)
    train_loader = DataLoader(train_ds, batch_size, shuffle=True, drop_last=True,
                              seed=seed + 1, **shard)
    return test_loader, train_loader
