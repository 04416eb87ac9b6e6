"""Video dataset: batched frame streams for recurrent training.

The port of ``styletransfer_tpu/data/video.py``, in numpy as there, so the
synthetic clips and the batch order are the JAX package's exactly. Contracts
kept from the reference:

- batches are batches of *videos*; each step yields one frame per video,
  stacked to ``[B, size, size, 3]``;
- iteration stops when the shortest video in the batch ends;
- the ragged last batch of videos is dropped, and the batch size is clamped
  to the video count;
- ``max_frames`` caps each clip at 90 s at 24 fps.

GIFs are decoded with Pillow (frame by frame, by index); other formats need
``imageio`` with a video backend, and opening one without it raises. A
frame that cannot be decoded ends its clip with a warning. With no videos on
disk a deterministic synthetic clip source (a procedural image translating
over time) keeps the video paths runnable. Nothing here downloads: put clips
in ``data/video/`` to train on them.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence

import numpy as np
from PIL import Image

from styletransfer_tpu_torch import constants
from styletransfer_tpu_torch.data.coco import synthetic_image
from styletransfer_tpu_torch.utils import images as img_utils
from styletransfer_tpu_torch.utils.logging import get_logger

MAX_FRAMES_DEFAULT = 90 * 24
VIDEO_DATA_PATH = "data/video/"


def _abspath(path: str) -> str:
    return path if os.path.isabs(path) else os.path.join(constants.PROJECT_ROOT_PATH, path)


class FrameReader:
    """Iterator protocol over the decoded frames of one video."""

    def next_frame(self) -> Optional[np.ndarray]:  # [1, size, size, 3] or None at the end
        raise NotImplementedError

    def close(self) -> None:
        pass


class _GifFrames:
    """Indexed RGB frames of a GIF through Pillow (``get_data(i)``, as an
    imageio reader has it). Seeking past the last frame raises EOFError."""

    def __init__(self, path: str):
        self._image = Image.open(path)

    def get_data(self, index: int) -> np.ndarray:
        self._image.seek(index)
        return np.asarray(self._image.convert("RGB"))

    def close(self) -> None:
        self._image.close()


def _open_frames(path: str):
    """An indexed frame source for ``path``: Pillow for a GIF, else an
    imageio reader (ImportError where imageio is missing)."""
    if path.lower().endswith(".gif"):
        return _GifFrames(path)
    import imageio

    return imageio.get_reader(path)


class ImageioFrameReader(FrameReader):
    """Frames of a video file through the standard image transform
    (crop-square, resize, normalize).

    ``normalized=False`` gives uint8 frames instead (crop and resize only)
    for the serving paths, which normalize on the device."""

    def __init__(self, path: str, size: int = constants.IMSIZE, normalized: bool = True):
        self._reader = _open_frames(path)
        self._size = size
        self._index = 0
        self._normalized = normalized

    def next_frame(self) -> Optional[np.ndarray]:
        try:
            # Explicit indexed reads: some imageio backends start their own
            # next-frame cursor past frame 0.
            frame = self._reader.get_data(self._index)
        except (IndexError, EOFError, StopIteration):
            return None
        except Exception as exc:  # noqa: BLE001 - a corrupt frame mid-stream
            # Decoders raise their own errors on a truncated or corrupt
            # frame. Training keeps going through bad files, so the clip
            # ends here, with a warning that shows the corpus problem.
            get_logger().warning("Video frame %d unreadable (%s: %s); treating clip as ended.",
                                 self._index, type(exc).__name__, exc)
            return None
        self._index += 1
        if not self._normalized:
            return img_utils.from_array_uint8(frame, self._size)
        return img_utils.from_array(frame, self._size)

    def close(self) -> None:
        self._reader.close()


class SyntheticFrameReader(FrameReader):
    """Deterministic clip: a procedural image translating over time."""

    def __init__(self, seed: int, num_frames: int = 48, size: int = constants.IMSIZE):
        self._base = synthetic_image(seed, size)
        self._num_frames = num_frames
        self._i = 0

    def next_frame(self) -> Optional[np.ndarray]:
        if self._i >= self._num_frames:
            return None
        shifted = np.roll(self._base, shift=2 * self._i, axis=1)
        self._i += 1
        return np.asarray(img_utils.normalize(shifted), dtype=np.float32)[None]


def make_batches(items: Sequence, n: int) -> List[List]:
    """Successive n-sized chunks."""
    return [list(items[i:i + n]) for i in range(0, len(items), n)]


class VideoDataset:
    """Iterable over batches of frame readers: the clips in ``videos``, or
    the files of ``video_dir``, or (none on disk) ``synthetic_count``
    synthetic clips of 48 frames. ``shard_index`` / ``shard_count`` give
    each rank of a distributed run a disjoint strided slice of the clips;
    sharded, the batch size is never clamped to the rank's count (every
    rank's local batch must be the same size), and a rank with fewer clips
    than a batch yields no batch."""

    def __init__(
        self,
        videos: Optional[Sequence[str]] = None,
        data_limit: Optional[int] = None,
        batch_size: int = 3,
        video_dir: str = VIDEO_DATA_PATH,
        size: int = constants.IMSIZE,
        synthetic_fallback: bool = True,
        synthetic_count: int = 4,
        shard_index: int = 0,
        shard_count: int = 1,
    ):
        logger = get_logger()
        self.size = size
        self.synthetic = False

        if videos is None:
            abs_dir = _abspath(video_dir)
            listing = sorted(os.listdir(abs_dir)) if os.path.isdir(abs_dir) else []
            videos = [os.path.join(abs_dir, v) for v in listing]
        videos = list(videos)

        if not videos and synthetic_fallback:
            logger.warning("No videos found; using %d deterministic synthetic clips.",
                           synthetic_count)
            self.synthetic = True
            videos = list(range(synthetic_count))

        if data_limit:
            videos = videos[:data_limit]
        if shard_count > 1:
            videos = videos[shard_index::shard_count]
            if batch_size > len(videos):
                logger.warning("Shard %d/%d has %d video(s) < batch %d; it will yield no "
                               "batches (all hosts stop together via lockstep).",
                               shard_index, shard_count, len(videos), batch_size)
        elif batch_size > len(videos):
            logger.warning("Batch size larger than video count; using batch of %d",
                           len(videos))
            batch_size = len(videos)
        self.batch_size = batch_size

        # batch_size is 0 only for an empty corpus (no videos, no synthetic
        # fallback): no batches.
        self.video_batches = make_batches(videos, batch_size) if batch_size > 0 else []
        if self.video_batches and len(self.video_batches[-1]) != batch_size:
            self.video_batches = self.video_batches[:-1]

    def __len__(self) -> int:
        return len(self.video_batches)

    def __iter__(self) -> Iterator[List[FrameReader]]:
        for batch in self.video_batches:
            if self.synthetic:
                yield [SyntheticFrameReader(seed, size=self.size) for seed in batch]
            else:
                yield [ImageioFrameReader(path, self.size) for path in batch]


def iterate_on_video_batches(
    batch: List[FrameReader], max_frames: int = MAX_FRAMES_DEFAULT
) -> Iterator[np.ndarray]:
    """Yield ``[B, size, size, 3]`` frame stacks until the shortest video ends
    or ``max_frames`` is reached; the readers are closed at the end."""
    try:
        for _ in range(max_frames):
            frames = []
            for reader in batch:
                f = reader.next_frame()
                if f is None:
                    return
                frames.append(f)
            yield np.concatenate(frames, axis=0)
    finally:
        for reader in batch:
            reader.close()
