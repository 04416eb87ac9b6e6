"""The port's data pipeline (data/coco.py, parallel/prefetch.py) and its
TensorBoard writer (utils/tb.py) against the JAX package's: the synthetic
corpus and the batch order must be the same, bit for bit."""

import struct
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from styletransfer_tpu.data import coco as jcoco
from styletransfer_tpu.utils import images as jimages
from styletransfer_tpu.utils import tb as jtb
from styletransfer_tpu_torch.data import coco as tcoco
from styletransfer_tpu_torch.parallel import prefetch
from styletransfer_tpu_torch.utils import images as timages
from styletransfer_tpu_torch.utils import tb as ttb


def _write_images(d, names, size=16):
    d.mkdir(parents=True, exist_ok=True)
    for i, name in enumerate(names):
        arr = np.full((size, size, 3), i * 10 % 255, dtype=np.uint8)
        Image.fromarray(arr).save(d / name)


@pytest.mark.parametrize("index,size", [(0, 32), (5, 256), (301, 17)])
def test_synthetic_image_is_bit_equal(index, size):
    np.testing.assert_array_equal(tcoco.synthetic_image(index, size),
                                  jcoco.synthetic_image(index, size))


def test_synthetic_dataset_is_bit_equal():
    for offset in (0, 256):
        t, j = tcoco.SyntheticDataset(4, 16, offset), jcoco.SyntheticDataset(4, 16, offset)
        for i in range(4):
            np.testing.assert_array_equal(t.load(i), j.load(i))


@pytest.mark.parametrize("seed,epoch,skip", [(0, 0, 0), (1, 0, 2), (7, 3, 1),
                                            (4, 1, 3)])
def test_batch_order_equals_jax_including_set_position(seed, epoch, skip):
    ds_t, ds_j = tcoco.SyntheticDataset(12, 8), jcoco.SyntheticDataset(12, 8)
    lt = tcoco.DataLoader(ds_t, batch_size=3, seed=seed, num_threads=2)
    lj = jcoco.DataLoader(ds_j, batch_size=3, seed=seed, num_threads=2)
    lt.set_position(epoch, skip)
    lj.set_position(epoch, skip)
    for expected in (4 - skip, 4):  # the resumed epoch, then the next one
        got, want = list(lt), list(lj)
        assert len(got) == len(want) == expected
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert len(lt) == len(lj) == 4


@pytest.mark.parametrize("mode,shape", [("RGB", (40, 30, 3)), ("RGBA", (21, 33, 4)),
                                        ("L", (30, 30))])
def test_image_helpers_equal_jax(tmp_path, mode, shape):
    """The training path's host image helpers (style image load, previews)
    against the JAX package's on the same file: the same PIL and numpy
    arithmetic, so bit for bit."""
    pixels = np.random.default_rng(12).integers(0, 256, size=shape, dtype=np.uint8)
    path = tmp_path / "img.png"
    Image.fromarray(pixels, mode).save(path)
    got, want = timages.load_image(str(path), 24), jimages.load_image(str(path), 24)
    assert got.shape == (1, 24, 24, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    with Image.open(path) as img:
        np.testing.assert_array_equal(timages.center_crop_resize(img, 16),
                                      jimages.center_crop_resize(img, 16))
    np.testing.assert_array_equal(timages.to_uint8(got), jimages.to_uint8(want))
    np.testing.assert_array_equal(timages.denormalize(got), np.asarray(jimages.denormalize(want)))
    np.testing.assert_array_equal(timages.concat_images(got, got[:, ::-1], axis=1),
                                  jimages.concat_images(want, want[:, ::-1], axis=1))


def test_bad_images_are_substituted_like_jax(tmp_path):
    d = tmp_path / "imgs"
    _write_images(d, [f"{i:04d}.png" for i in range(5)])
    (d / "!bad.png").write_bytes(b"not an image")
    Image.fromarray(np.zeros((16, 16), dtype=np.uint8)).save(d / "0002gray.png")
    lt = tcoco.DataLoader(tcoco.CocoDataset(image_dir=str(d), size=16), 2, seed=3)
    lj = jcoco.DataLoader(jcoco.CocoDataset(image_dir=str(d), size=16), 2, seed=3)
    got, want = list(lt), list(lj)
    assert len(got) == len(want) == 3  # 7 files, two substituted, last one dropped
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_get_coco_loader_falls_back_to_the_synthetic_corpus(tmp_path):
    test_loader, train_loader = tcoco.get_coco_loader(
        batch_size=2, image_dir=str(tmp_path / "empty"), test_limit=8, train_limit=6)
    assert len(train_loader) == 3 and len(test_loader) == 4
    first = next(iter(train_loader))
    assert first.shape == (2, 256, 256, 3) and first.dtype == np.float32
    # The test split is disjoint from the train split (indices past it).
    assert test_loader.dataset.seed_offset == 6


def test_get_coco_loader_splits_a_directory(tmp_path):
    d = tmp_path / "imgs"
    _write_images(d, [f"{i:04d}.png" for i in range(20)])
    test_loader, train_loader = tcoco.get_coco_loader(batch_size=2, image_dir=str(d))
    assert test_loader.dataset.images == [f"{i:04d}.png" for i in range(2)]
    assert len(train_loader.dataset) == 18


def test_prefetch_yields_tensors_in_order():
    batches = [np.full((2, 3, 3, 3), i, np.float32) for i in range(5)]
    got = list(prefetch.prefetch_to_device(iter(batches), "cpu", size=2))
    assert [int(t[0, 0, 0, 0]) for t in got] == list(range(5))
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in got)


def test_prefetch_raises_producer_errors():
    def gen():
        yield np.zeros((1, 2, 2, 3), np.float32)
        raise OSError("disk went away")

    it = prefetch.prefetch_to_device(gen(), "cpu")
    next(it)
    with pytest.raises(OSError, match="disk went away"):
        next(it)


def test_prefetch_cleans_up_when_the_consumer_stops_early():
    produced = []

    def gen():
        for i in range(100):
            produced.append(i)
            yield np.ones((2, 2, 2, 3), np.float32) * i

    before = threading.active_count()
    it = prefetch.prefetch_to_device(gen(), "cpu", size=2)
    next(it)
    it.close()
    deadline = time.monotonic() + 5
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
    assert len(produced) < 100


def test_tb_crc32c_matches_the_jax_package():
    rng = np.random.default_rng(0)
    for n in (0, 1, 9, 1023):
        payload = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert ttb._crc32c(payload) == jtb._crc32c_py(payload)
    assert ttb._crc32c(b"123456789") == 0xE3069283


def test_tb_writer_records_parse(tmp_path):
    d = str(tmp_path / "run")
    (tmp_path / "run").mkdir()
    (tmp_path / "run" / "stale.txt").write_text("old")
    w = ttb.get_tensorboard_writer(d)
    assert not (tmp_path / "run" / "stale.txt").exists()
    w.add_scalar("data/fst_train_loss", 1.5, 0)
    w.add_image("data/fst_images", np.zeros((4, 8, 3), np.uint8), 0)
    w.close()
    records = []
    with open(w._path, "rb") as f:
        while header := f.read(8):
            (length,) = struct.unpack("<Q", header)
            assert struct.unpack("<I", f.read(4))[0] == jtb._masked_crc(header)
            data = f.read(length)
            assert struct.unpack("<I", f.read(4))[0] == jtb._masked_crc(data)
            records.append(data)
    assert len(records) == 3 and b"brain.Event:2" in records[0]
    assert struct.pack("<f", 1.5) in records[1] and b"\x89PNG" in records[2]
