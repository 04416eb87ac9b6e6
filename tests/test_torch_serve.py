"""The port's fast_st inference (engines/fast.py, the CLI) against the JAX
package's, on the same inputs and the same checkpoint file."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from styletransfer_tpu import ckpt as jckpt
from styletransfer_tpu.engines import fast as jfast
from styletransfer_tpu.models import transformer as jt
from styletransfer_tpu_torch import constants as tconstants
from styletransfer_tpu_torch.clis import cli as tcli
from styletransfer_tpu_torch.engines import fast as tfast
from styletransfer_tpu_torch.models import transformer as tt

SIZE = 32


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(jt.init_params(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def models_dir(tmp_path_factory, jax_params):
    """A models directory holding one checkpoint written by the JAX package."""
    d = tmp_path_factory.mktemp("models")
    jckpt.save_epoch(jax_params, "fast_st", "tst", 1, str(d))
    return str(d)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(5)
    for i, shape in enumerate([(40, 40, 3), (48, 37, 3), (33, 50, 3)]):
        Image.fromarray(rng.integers(0, 256, size=shape, dtype=np.uint8)).save(
            d / f"pic{i}.png")
    (d / "broken.jpg").write_bytes(b"not an image")
    return str(d)


def _read(path):
    return np.asarray(Image.open(path)).astype(np.int32)


@pytest.mark.parametrize("precision,steps", [("f32", 1), ("bf16", 8)])
def test_make_serve_fn_matches_jax(jax_params, precision, steps):
    """uint8 in, uint8 out. f32 within one step of 255; bf16 within 8 (both
    round activations to bf16, at different places)."""
    batch = np.random.default_rng(3).integers(0, 256, size=(2, SIZE, SIZE, 3), dtype=np.uint8)
    want = np.asarray(jax.jit(jfast.make_serve_fn(precision))(jax_params, jnp.asarray(batch)))
    got = tfast.make_serve_fn(precision)(tt.params_from_jax(jax_params, device="cpu"),
                                         torch.from_numpy(batch))
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert np.abs(got.numpy().astype(np.int32) - want.astype(np.int32)).max() <= steps


def test_process_image_matches_jax_from_the_same_checkpoint(tmp_path, models_dir, image_dir):
    src = os.path.join(image_dir, "pic1.png")
    want = jfast.process_image(src, "tst", out_dir=str(tmp_path / "jax"),
                               models_path=models_dir, size=SIZE)
    got = tfast.process_image(src, "tst", out_dir=str(tmp_path / "port"),
                              models_path=models_dir, size=SIZE, device="cpu")
    assert os.path.basename(got) == os.path.basename(want) == "converted_fast_st_tst.png"
    assert np.abs(_read(got) - _read(want)).max() <= 1


def test_process_dir_matches_jax_from_the_same_checkpoint(tmp_path, models_dir, image_dir):
    want = jfast.process_dir(image_dir, "tst", out_dir=str(tmp_path / "jax"), batch_size=2,
                             models_path=models_dir, size=SIZE)
    got = tfast.process_dir(image_dir, "tst", out_dir=str(tmp_path / "port"), batch_size=2,
                            models_path=models_dir, size=SIZE, device="cpu")
    assert sorted(os.path.basename(p) for p in got) == sorted(
        os.path.basename(p) for p in want) == [
        f"converted_fast_st_tst_pic{i}.png" for i in range(3)]  # broken.jpg skipped
    for g, w in zip(sorted(got), sorted(want)):
        assert np.abs(_read(g) - _read(w)).max() <= 1


def test_process_dir_rejects_a_directory_without_images(tmp_path):
    with pytest.raises(FileNotFoundError, match="No images"):
        tfast.process_dir(str(tmp_path), "tst", device="cpu")


def test_make_serve_fn_rejects_unknown_precision():
    with pytest.raises(ValueError, match="precision"):
        tfast.make_serve_fn("f16")


def _project(tmp_path, monkeypatch, models_dir, image_dir):
    """A project root with data/models/ holding the JAX-written checkpoint."""
    import shutil

    shutil.copytree(models_dir, tmp_path / "data" / "models")
    shutil.copytree(image_dir, tmp_path / "imgs")
    monkeypatch.setattr(tconstants, "PROJECT_ROOT_PATH", str(tmp_path))


def test_convert_image_cli(tmp_path, monkeypatch, models_dir, image_dir):
    _project(tmp_path, monkeypatch, models_dir, image_dir)
    result = CliRunner().invoke(tcli, [
        "fast_st", "convert-image", "imgs/pic0.png", "tst", "--size", str(SIZE),
        "--device", "cpu"])
    assert result.exit_code == 0, result.output
    out = tmp_path / "results" / "converted_fast_st_tst.png"
    assert _read(out).shape == (SIZE, SIZE, 3)
    want = jfast.process_image(os.path.join(image_dir, "pic0.png"), "tst",
                               out_dir=str(tmp_path / "jax"), models_path=models_dir,
                               size=SIZE)
    assert np.abs(_read(out) - _read(want)).max() <= 1


def test_convert_dir_cli_bf16(tmp_path, monkeypatch, models_dir, image_dir):
    _project(tmp_path, monkeypatch, models_dir, image_dir)
    result = CliRunner().invoke(tcli, [
        "fast_st", "convert-dir", "imgs", "tst", "-b", "2", "-o", "out/", "--size",
        str(SIZE), "--precision", "bf16", "--device", "cpu"])
    assert result.exit_code == 0, result.output
    assert sorted(os.listdir(tmp_path / "out")) == [
        f"converted_fast_st_tst_pic{i}.png" for i in range(3)]


def test_convert_image_cli_zeros_from_a_pth(tmp_path, monkeypatch, jax_params, image_dir):
    """A models directory holding only a reference .pth, served with
    --pad-mode zeros: the output of the JAX command on the same file."""
    (tmp_path / "models").mkdir()
    torch.save(tt.export_torch_state_dict(jax_params),
               str(tmp_path / "models" / "fast_st_ref_epoch0.pth"))
    _project(tmp_path, monkeypatch, str(tmp_path / "models"), image_dir)
    result = CliRunner().invoke(tcli, [
        "fast_st", "convert-image", "imgs/pic1.png", "ref", "--size", str(SIZE),
        "--pad-mode", "zeros", "--device", "cpu"])
    assert result.exit_code == 0, result.output
    out = tmp_path / "results" / "converted_fast_st_ref.png"
    want = jfast.process_image(os.path.join(image_dir, "pic1.png"), "ref",
                               out_dir=str(tmp_path / "jax"),
                               models_path=str(tmp_path / "models"), size=SIZE,
                               pad_mode="zeros")
    assert np.abs(_read(out) - _read(want)).max() <= 1
    reflect = tfast.process_image("imgs/pic1.png", "ref", out_dir="reflect/", size=SIZE,
                                  device="cpu")
    assert np.abs(_read(out) - _read(reflect)).max() > 1  # the padding mode was used


@pytest.mark.parametrize("precision,steps", [("f32", 1), ("bf16", 8)])
def test_zeros_serve_fn_matches_jax(jax_params, precision, steps):
    batch = np.random.default_rng(4).integers(0, 256, size=(2, SIZE, SIZE, 3), dtype=np.uint8)
    want = np.asarray(jax.jit(jfast.make_serve_fn(precision, "zeros"))(jax_params,
                                                                       jnp.asarray(batch)))
    got = tfast.make_serve_fn(precision, "zeros")(tt.params_from_jax(jax_params, device="cpu"),
                                                  torch.from_numpy(batch))
    assert got.dtype == torch.uint8
    assert np.abs(got.numpy().astype(np.int32) - want.astype(np.int32)).max() <= steps
    with pytest.raises(ValueError, match="pad_mode"):
        tfast.make_serve_fn(precision, "circular")
