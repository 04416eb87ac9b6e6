"""The port's packed dataset (``data/packed.py``, ``fast_st pack-dataset``,
``train --packed``, ``train-multi --packed``) against the JAX package's:
the files and headers byte for byte, the loaders' batches and shards in the
same order, and the uint8 batches normalized on the device by every step
that takes them (train, eval and preview, single- and multi-style)."""

import os

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from styletransfer_tpu import constants as jconstants
from styletransfer_tpu.clis import cli as jcli
from styletransfer_tpu.data import packed as jpacked
from styletransfer_tpu_torch import constants as tconstants
from styletransfer_tpu_torch.clis import cli as tcli
from styletransfer_tpu_torch.data import packed as tpacked
from styletransfer_tpu_torch.engines import fast
from styletransfer_tpu_torch.engines import multistyle
from styletransfer_tpu_torch.models import multistyle as ms
from styletransfer_tpu_torch.models import transformer, vgg
from styletransfer_tpu_torch.utils import images as img_utils

SIZE = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU ops here are small: one thread each, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _image_dir(d, n_rgb=6):
    """RGB images of several shapes, a grey one, an RGBA one and a junk file."""
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(3)
    for i in range(n_rgb):
        h, w = 40 + 7 * i, 33 + 11 * (i % 3)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            d / f"img{i:02d}.{'png' if i % 2 else 'jpg'}")
    Image.fromarray(rng.integers(0, 256, (30, 30), dtype=np.uint8)).save(d / "grey.png")
    Image.fromarray(rng.integers(0, 256, (30, 30, 4), dtype=np.uint8)).save(d / "rgba.png")
    (d / "junk.jpg").write_bytes(b"not an image")
    return d


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("limit", [None, 4])
def test_pack_images_writes_the_jax_file_and_header(tmp_path, limit):
    src = _image_dir(tmp_path / "imgs")
    n_t = tpacked.pack_images(str(src), str(tmp_path / "t" / "p.bin"), size=SIZE, limit=limit)
    n_j = jpacked.pack_images(str(src), str(tmp_path / "j" / "p.bin"), size=SIZE, limit=limit)
    assert n_t == n_j == (6 if limit is None else 3)  # grey.png sorts first
    for suffix in ("", ".json"):
        assert _bytes(tmp_path / "t" / f"p.bin{suffix}") == _bytes(tmp_path / "j" /
                                                                    f"p.bin{suffix}")
    ds = tpacked.PackedDataset(str(tmp_path / "t" / "p.bin"))
    row = ds.load(1)
    assert len(ds) == n_t and ds.size == SIZE
    assert isinstance(row, np.memmap) and row.dtype == np.uint8 and row.shape == (SIZE, SIZE, 3)


@pytest.mark.parametrize("num,size", [(5, 32), (2, 17)])
def test_pack_synthetic_writes_the_jax_file_and_header(tmp_path, num, size):
    assert tpacked.pack_synthetic(str(tmp_path / "t.bin"), num, size) == num
    assert jpacked.pack_synthetic(str(tmp_path / "j.bin"), num, size) == num
    for suffix in ("", ".json"):
        assert _bytes(tmp_path / f"t.bin{suffix}") == _bytes(tmp_path / f"j.bin{suffix}")


@pytest.mark.parametrize("seed,shard_index,shard_count,train_limit",
                         [(0, 0, 1, None), (3, 0, 2, None), (3, 1, 2, None), (1, 2, 3, 20),
                          (5, 0, 1, 7)])
def test_packed_loaders_yield_the_jax_batches_and_shards(tmp_path, seed, shard_index,
                                                         shard_count, train_limit):
    path = str(tmp_path / "p.bin")
    tpacked.pack_synthetic(path, 40, 8)
    kw = dict(batch_size=2, test_split=0.25, test_limit=6, train_limit=train_limit, seed=seed,
              shard_index=shard_index, shard_count=shard_count)
    got, want = tpacked.get_packed_loader(path, **kw), jpacked.get_packed_loader(path, **kw)
    for t_loader, j_loader in zip(got, want):
        assert len(t_loader) == len(j_loader)
        for _ in range(2):  # two epochs: the shuffle follows (seed, epoch)
            t_batches, j_batches = list(t_loader), list(j_loader)
            assert len(t_batches) == len(j_batches) == len(j_loader) > 0
            for a, b in zip(t_batches, j_batches):
                assert a.dtype == np.uint8
                np.testing.assert_array_equal(a, b)


def _normalized(batch_u8):
    return torch.from_numpy(img_utils.normalize(batch_u8.astype(np.float32) / 255.0))


def _u8(seed, n=2):
    return np.random.default_rng(seed).integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def port_vgg():
    return vgg.load_params(device="cpu")


@pytest.fixture(scope="module")
def grams(port_vgg):
    style = torch.from_numpy(_normalized(_u8(9, 1)).numpy())
    return vgg.style_gram_targets(port_vgg, style)


def test_a_uint8_batch_trains_and_evaluates_as_its_host_normalized_floats(port_vgg, grams):
    params = transformer.init_params(0, device="cpu")
    batch = _u8(4)
    raw = torch.from_numpy(batch)
    total_u8, comps_u8 = fast.loss_fn(params, raw, port_vgg, grams, 1e5, 1.0)
    total_f, comps_f = fast.loss_fn(params, _normalized(batch), port_vgg, grams, 1e5, 1.0)
    for k in comps_f:
        np.testing.assert_allclose(float(comps_u8[k].detach()), float(comps_f[k].detach()),
                                   rtol=1e-6)
    eval_step = fast.make_eval_step(port_vgg, grams)
    np.testing.assert_allclose(float(eval_step(params, raw)),
                               float(eval_step(params, _normalized(batch))), rtol=1e-6)


def test_a_uint8_batch_trains_and_evaluates_multistyle_as_its_host_normalized_floats(
        port_vgg, grams):
    params = ms.init_params(0, num_styles=2, device="cpu")
    stacked = {k: torch.cat([g, 0.5 * g]) for k, g in grams.items()}
    batch, idx = _u8(5), np.asarray([1, 0])
    raw = torch.from_numpy(batch)
    total_u8, _ = multistyle.multistyle_loss(params, raw, idx, port_vgg, stacked, 1e5, 1.0)
    total_f, _ = multistyle.multistyle_loss(params, _normalized(batch), idx, port_vgg, stacked,
                                            1e5, 1.0)
    np.testing.assert_allclose(float(total_u8.detach()), float(total_f.detach()), rtol=1e-6)
    eval_step = multistyle.make_eval_step(port_vgg, stacked)
    np.testing.assert_allclose(float(eval_step(params, raw, idx)),
                               float(eval_step(params, _normalized(batch), idx)), rtol=1e-6)


def _cli_root(tmp_path, monkeypatch):
    monkeypatch.setattr(jconstants, "PROJECT_ROOT_PATH", str(tmp_path))
    monkeypatch.setattr(tconstants, "PROJECT_ROOT_PATH", str(tmp_path))
    _image_dir(tmp_path / "imgs", n_rgb=20)  # a test split of 2: one batch
    Image.fromarray(_u8(9, 1)[0]).save(tmp_path / "style.png")
    Image.fromarray(_u8(8, 1)[0]).save(tmp_path / "style2.png")


def test_pack_dataset_command_writes_the_jax_commands_file(tmp_path, monkeypatch):
    _cli_root(tmp_path, monkeypatch)
    for cli, out in ((tcli, "t/p.bin"), (jcli, "j/p.bin")):
        r = CliRunner().invoke(cli, ["fast_st", "pack-dataset", "imgs", out, "--size",
                                     str(SIZE), "--limit", "9"])
        assert r.exit_code == 0, r.output + repr(r.exception)
    for suffix in ("", ".json"):
        assert _bytes(tmp_path / f"t/p.bin{suffix}") == _bytes(tmp_path / f"j/p.bin{suffix}")
    assert tpacked.PackedDataset(str(tmp_path / "t/p.bin")).num_images == 8  # grey.png skipped


@pytest.mark.parametrize("command", ["train", "train-multi"])
def test_train_packed_runs_a_cpu_step_on_uint8_batches(tmp_path, monkeypatch, port_vgg,
                                                       command):
    """pack-dataset, then the command with --packed for one step, whose
    loaders are the packed file's (uint8 batches, JAX's split); the preview
    the loop makes of a uint8 batch is that of its host-normalized floats."""
    _cli_root(tmp_path, monkeypatch)
    r = CliRunner().invoke(tcli, ["fast_st", "pack-dataset", "imgs", "p.bin", "--size",
                                  str(SIZE)])
    assert r.exit_code == 0, r.output + repr(r.exception)
    seen = {}
    real_loop = fast.train_loop

    def loop(params, train_step, test, preview, *args, **kw):
        seen["preview"] = (params, preview)
        return real_loop(params, train_step, test, preview, *args, **kw)

    engine = fast if command == "train" else multistyle
    real_train = engine.static_train if command == "train" else engine.train

    def train(style, **kw):
        seen["kw"] = kw
        return real_train(style, **kw, vgg_params=port_vgg, max_steps_per_epoch=1,
                          log_cadence=(1, 1, 1))

    monkeypatch.setattr(fast, "train_loop", loop)
    monkeypatch.setattr(engine, "static_train" if command == "train" else "train", train)
    styles = ["style.png"] if command == "train" else ["style.png", "style2.png", "-n", "duo"]
    r = CliRunner().invoke(tcli, ["fast_st", command, *styles, "-e", "1", "-b", "2",
                                  "--packed", "p.bin", "--device", "cpu"])
    assert r.exit_code == 0, r.output + repr(r.exception)
    want_test, want_train = jpacked.get_packed_loader(
        str(tmp_path / "p.bin"), batch_size=2, test_split=0.10, test_limit=20)
    for key, want in (("train_loader", want_train), ("test_loader", want_test)):
        got = seen["kw"][key]
        assert isinstance(got.dataset, tpacked._PackedView)
        list(want)  # the run took epoch 0 of each loader
        batches, want_batches = list(got), list(want)
        assert len(batches) == len(want_batches) > 0 and batches[0].dtype == np.uint8
        for a, b in zip(batches, want_batches):
            np.testing.assert_array_equal(a, b)
    model = "fast_st_style.png" if command == "train" else "fast_multi_st_duo"
    assert os.path.isfile(tmp_path / "data" / "models" / f"{model}_epoch0.msgpack")
    params, preview = seen["preview"]
    batch = _u8(6)
    with torch.no_grad():
        got, got_in = preview(params, torch.from_numpy(batch), 1)
        want, want_in = preview(params, _normalized(batch), 1)
    np.testing.assert_allclose(got_in.numpy(), want_in.numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
