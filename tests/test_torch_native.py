"""The port's native CRC32C (``styletransfer_tpu_torch/native``): the check
value, the C library against the Python table and against the JAX package's
CRC on seeded byte strings, TensorBoard event files byte for byte the same
with either CRC, and the fallback to Python where no C compiler is found."""

import logging
import os
import shutil

import numpy as np
import pytest

from styletransfer_tpu.utils import tb as jtb
from styletransfer_tpu_torch import native
from styletransfer_tpu_torch.utils import tb

LENGTHS = [0, 1, 7, 8, 9, 4096, 1 << 20]


@pytest.fixture()
def fresh_native(monkeypatch, tmp_path):
    """The native module with nothing loaded and its builds under
    ``tmp_path``."""
    monkeypatch.setattr(native, "_crc32c_fn", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "native"))
    return tmp_path / "native"


def test_check_value():
    assert native.crc32c(b"123456789") == 0xE3069283
    assert tb._crc32c_py(b"123456789") == 0xE3069283


@pytest.mark.parametrize("n", LENGTHS)
def test_native_equals_python_and_jax(fresh_native, n):
    if shutil.which("cc") is None and shutil.which("gcc") is None:
        pytest.fail("this test needs a C compiler")
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    got = native.crc32c(data)
    assert native._crc32c_fn is not tb._crc32c_py  # the C library answered
    assert got == tb._crc32c_py(data) == jtb._crc32c_py(data)


def test_the_library_is_built_once_and_named_by_its_source(fresh_native):
    native.crc32c(b"x")
    (lib,) = os.listdir(fresh_native)
    assert lib == os.path.basename(native._target("crc32c.c"))
    assert lib.startswith("libstxcrc32c_") and lib.endswith(".so")
    mtime = os.path.getmtime(fresh_native / lib)
    native._crc32c_fn = None
    native.crc32c(b"y")
    assert os.listdir(fresh_native) == [lib] and os.path.getmtime(fresh_native / lib) == mtime


def test_without_a_compiler_it_falls_back_to_python_and_says_so(
        fresh_native, monkeypatch, tmp_path, caplog):
    empty = tmp_path / "empty_path"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    with caplog.at_level(logging.WARNING, logger="StyleTransfer"):
        assert native.crc32c(b"123456789") == 0xE3069283
        assert native.crc32c(b"abc") == tb._crc32c_py(b"abc")
    assert native._crc32c_fn is tb._crc32c_py
    warnings = [r.message for r in caplog.records if "CRC32C" in r.message]
    assert len(warnings) == 1 and "no C compiler" in warnings[0]
    assert not os.path.exists(fresh_native) or os.listdir(fresh_native) == []


def test_an_unloadable_library_falls_back_to_python(fresh_native, caplog):
    fresh_native.mkdir()
    with open(native._target("crc32c.c"), "w") as f:
        f.write("not a shared library")
    with caplog.at_level(logging.WARNING, logger="StyleTransfer"):
        assert native.crc32c(b"123456789") == 0xE3069283
    assert native._crc32c_fn is tb._crc32c_py
    assert any("could not be loaded" in r.message for r in caplog.records)


def test_event_files_are_byte_identical_with_either_crc(tmp_path, monkeypatch):
    monkeypatch.setattr(tb.time, "time", lambda: 1700000000.25)
    monkeypatch.setattr(tb.socket, "gethostname", lambda: "host")
    img = np.random.default_rng(1).integers(0, 256, (64, 48, 3), dtype=np.uint8)

    def write(sub):
        with tb.SummaryWriter(str(tmp_path / sub)) as w:
            for step in range(3):
                w.add_scalar("data/fst_train_loss", 1.5 / (step + 1), step)
            w.add_image("data/fst_images", img, 3)
            path = w._path
        with open(path, "rb") as f:
            return f.read()

    native.crc32c(b"")  # loaded: the C library here
    assert native._crc32c_fn is not tb._crc32c_py
    with_c = write("native")
    monkeypatch.setattr(native, "_crc32c_fn", tb._crc32c_py)
    assert write("python") == with_c and len(with_c) > img.size
