"""The port stands alone: no import of JAX, flax or the JAX package, and no
silent move to the CPU when no GPU is present."""

import ast
import os
import subprocess
import sys

import pytest
import torch
from click.testing import CliRunner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "styletransfer_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "styletransfer_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _forbidden(module):
    top = module.split(".")[0]
    return top in FORBIDDEN  # "styletransfer_tpu_torch" is its own top-level name


def test_ast_scan_finds_no_jax_import():
    files = _port_files()
    assert len(files) > 10
    bad = [(os.path.relpath(f, ROOT), m) for f in files for m in _imported_modules(f)
           if _forbidden(m)]
    assert bad == []


def test_the_scan_would_catch_a_jax_import():
    assert _forbidden("jax.numpy") and _forbidden("styletransfer_tpu.ops.layers")
    assert _forbidden("flax")
    assert not _forbidden("styletransfer_tpu_torch.ops.layers")


@pytest.mark.subprocess
def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import styletransfer_tpu_torch, styletransfer_tpu_torch.clis\n"
        "import styletransfer_tpu_torch.__main__\n"
        "import styletransfer_tpu_torch.engines.fast, styletransfer_tpu_torch.ckpt\n"
        "import styletransfer_tpu_torch.engines.gatys, styletransfer_tpu_torch.ops.lbfgs\n"
        "import styletransfer_tpu_torch.utils.profiling\n"
        "import styletransfer_tpu_torch.engines.video, styletransfer_tpu_torch.data.video\n"
        "import styletransfer_tpu_torch.engines.multistyle\n"
        "import styletransfer_tpu_torch.models.multistyle\n"
        "import styletransfer_tpu_torch.ops.cuda.conv_direct\n"
        "import styletransfer_tpu_torch.engines.daemon, styletransfer_tpu_torch.clis.common\n"
        "import styletransfer_tpu_torch.engines.netserve\n"
        "import styletransfer_tpu_torch.engines.httpserve\n"
        "import styletransfer_tpu_torch.data.packed, styletransfer_tpu_torch.ops.linesearch\n"
        "import styletransfer_tpu_torch.utils.doctor, styletransfer_tpu_torch.utils.demo\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'styletransfer_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


@pytest.mark.subprocess
def test_the_last_ported_modules_load_no_jax():
    """``utils/aot.py``, ``utils/cache.py``, ``native``, ``utils/profiling.py``
    and ``utils/logging.py``, and the CRC and the logger they set up, bring
    in nothing of JAX."""
    code = (
        "import sys\n"
        "from styletransfer_tpu_torch import native\n"
        "from styletransfer_tpu_torch.utils import aot, cache, logging, profiling, tb\n"
        "assert native.crc32c(b'123456789') == 0xE3069283\n"
        "logging.get_logger().info('isolation check')\n"
        "with profiling.trace('build/isolation_trace', device='cpu'):\n"
        "    pass\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'styletransfer_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_native_builds_from_the_ports_own_source():
    """The CRC library is built from ``styletransfer_tpu_torch/native/crc32c.c``
    (a copy of the JAX package's source, not a path into it) into the
    port's ``build/native``, named by that file's hash."""
    from styletransfer_tpu_torch import native

    src = os.path.join(PORT, "native", "crc32c.c")
    assert native.SRC_DIR == os.path.dirname(src) and os.path.isfile(src)
    assert native.BUILD_DIR == os.path.join(ROOT, "build", "native")
    with open(src) as f:
        text = f.read()
    assert "uint32_t crc32c(const uint8_t *data, size_t len)" in text
    assert "styletransfer_tpu/" not in text
    target = native._target("crc32c.c")
    assert os.path.dirname(target) == native.BUILD_DIR
    with open(os.path.join(ROOT, "styletransfer_tpu", "native", "crc32c.c"), "rb") as f:
        jax_src = f.read()
    with open(src, "rb") as f:
        assert f.read() != jax_src  # the port's own copy, hashed on its own


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a GPU")


def test_entry_points_raise_without_a_gpu(no_gpu, tmp_path):
    from styletransfer_tpu_torch import constants
    from styletransfer_tpu_torch.engines import fast
    from styletransfer_tpu_torch.models import transformer

    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        transformer.init_params()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        transformer.params_from_jax({})
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        fast.process_image("img.png", "tst")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        fast.process_dir(str(tmp_path), "tst")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        constants.resolve_device("cuda:0")
    assert constants.resolve_device("cpu") == torch.device("cpu")


def test_cli_defaults_to_cuda_and_fails_without_a_gpu(no_gpu, tmp_path, monkeypatch):
    from styletransfer_tpu_torch import constants
    from styletransfer_tpu_torch.clis import cli

    monkeypatch.setattr(constants, "PROJECT_ROOT_PATH", str(tmp_path))
    result = CliRunner().invoke(cli, ["fast_st", "convert-image", "img.png", "tst"])
    assert result.exit_code != 0
    assert "no CUDA GPU" in str(result.exception)
    assert not (tmp_path / "results").exists()


def test_train_cli_defaults_to_cuda_and_fails_without_a_gpu(no_gpu, tmp_path, monkeypatch):
    from styletransfer_tpu_torch import constants
    from styletransfer_tpu_torch.clis import cli

    monkeypatch.setattr(constants, "PROJECT_ROOT_PATH", str(tmp_path))
    result = CliRunner().invoke(cli, ["fast_st", "train", "style.png", "-e", "1"])
    assert result.exit_code != 0
    assert "no CUDA GPU" in str(result.exception)
    assert not (tmp_path / "runs").exists() and not (tmp_path / "data").exists()


def test_video_entry_points_raise_without_a_gpu(no_gpu, tmp_path, monkeypatch):
    from styletransfer_tpu_torch import constants
    from styletransfer_tpu_torch.clis import cli
    from styletransfer_tpu_torch.engines import video
    from styletransfer_tpu_torch.models import transformer

    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        transformer.init_video_params()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        video.video_train(None)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        video.process_video("clip.gif", "tst")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        video.process_video_dir(str(tmp_path), "tst")
    monkeypatch.setattr(constants, "PROJECT_ROOT_PATH", str(tmp_path))
    for args in (["train", "style.png", "-e", "1"], ["convert-video", "clip.gif", "tst"],
                 ["convert-dir", "clips", "tst"]):
        result = CliRunner().invoke(cli, ["video_st", *args])
        assert result.exit_code != 0
        assert "no CUDA GPU" in str(result.exception), args
    assert os.listdir(tmp_path) == []


def test_multistyle_entry_points_raise_without_a_gpu(no_gpu, tmp_path, monkeypatch):
    from styletransfer_tpu_torch import constants
    from styletransfer_tpu_torch.clis import cli
    from styletransfer_tpu_torch.engines import multistyle as engine
    from styletransfer_tpu_torch.models import multistyle

    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        multistyle.init_params(0, num_styles=2)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        engine.process_image("img.png", "duo", num_styles=2)
    monkeypatch.setattr(constants, "PROJECT_ROOT_PATH", str(tmp_path))
    result = CliRunner().invoke(cli, ["fast_st", "convert-image-multi", "img.png", "duo",
                                      "--num-styles", "2"])
    assert result.exit_code != 0
    assert "no CUDA GPU" in str(result.exception)
    assert os.listdir(tmp_path) == []


def test_training_and_serving_entry_points_raise_without_a_gpu(no_gpu, tmp_path, monkeypatch):
    from styletransfer_tpu_torch import constants
    from styletransfer_tpu_torch.clis import cli
    from styletransfer_tpu_torch.engines import fast
    from styletransfer_tpu_torch.engines import multistyle as engine

    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        engine.train(None)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        fast.serve_loop("tst")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        engine.serve_loop("duo", num_styles=2)
    monkeypatch.setattr(constants, "PROJECT_ROOT_PATH", str(tmp_path))
    for args in (["train-multi", "a.png", "b.png", "-e", "1"], ["serve", "tst"],
                 ["serve-multi", "duo", "--num-styles", "2"]):
        result = CliRunner().invoke(cli, ["fast_st", *args], input="img.png\n\n")
        assert result.exit_code != 0
        assert "no CUDA GPU" in str(result.exception), args
        assert "READY" not in result.output
    assert os.listdir(tmp_path) == []


def test_video_and_gatys_daemons_raise_without_a_gpu(no_gpu, tmp_path, monkeypatch):
    """Also behind the network transports: the listener may bind, but the
    engine raises before READY."""
    from styletransfer_tpu_torch import constants
    from styletransfer_tpu_torch.clis import cli
    from styletransfer_tpu_torch.engines import gatys, video

    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        video.serve_stream_loop("tst")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        gatys.serve_loop()
    monkeypatch.setattr(constants, "PROJECT_ROOT_PATH", str(tmp_path))
    for args in (["video_st", "serve", "tst"], ["video_st", "serve", "tst", "--tcp", "0"],
                 ["gatys_st", "--serve"], ["gatys_st", "--serve", "--http", "0"],
                 ["fast_st", "serve", "tst", "--tcp", "0"]):
        result = CliRunner().invoke(cli, args, input="img.png\ts.png\n\n")
        assert result.exit_code != 0
        assert "no CUDA GPU" in str(result.exception), args
        assert "READY" not in result.output
    assert os.listdir(tmp_path) == []


def test_packed_training_and_lbfgs_zoom_raise_without_a_gpu(no_gpu, tmp_path, monkeypatch):
    """``train --packed``, ``train-multi --packed`` and ``gatys_st --optimizer
    lbfgs-zoom`` (one-shot and daemon) default to the card; ``pack-dataset``
    is host work and runs."""
    import numpy as np
    from PIL import Image

    from styletransfer_tpu_torch import constants
    from styletransfer_tpu_torch.clis import cli
    from styletransfer_tpu_torch.engines import gatys

    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        gatys.serve_loop(optimizer="lbfgs-zoom")
    monkeypatch.setattr(constants, "PROJECT_ROOT_PATH", str(tmp_path))
    (tmp_path / "imgs").mkdir()
    for i in range(3):
        Image.fromarray(np.full((20, 20, 3), 40 * i, np.uint8)).save(tmp_path / "imgs" /
                                                                     f"{i}.png")
    result = CliRunner().invoke(cli, ["fast_st", "pack-dataset", "imgs", "p.bin", "--size",
                                      "16"])
    assert result.exit_code == 0, result.output
    before = sorted(os.listdir(tmp_path))
    for args in (["fast_st", "train", "style.png", "-e", "1", "--packed", "p.bin"],
                 ["fast_st", "train-multi", "a.png", "b.png", "-e", "1", "--packed", "p.bin"],
                 ["gatys_st", "c.png", "s.png", "--optimizer", "lbfgs-zoom"],
                 ["gatys_st", "--serve", "--optimizer", "lbfgs-zoom"]):
        result = CliRunner().invoke(cli, args, input="c.png\ts.png\n\n")
        assert result.exit_code != 0
        assert "no CUDA GPU" in str(result.exception), args
        assert "READY" not in result.output
    assert sorted(os.listdir(tmp_path)) == before


@pytest.mark.subprocess
def test_the_parallel_modules_load_no_jax():
    """The multi-GPU modules, and the dry run's ranks, stand alone too."""
    code = (
        "import sys\n"
        "import styletransfer_tpu_torch.parallel.distributed\n"
        "import styletransfer_tpu_torch.parallel.mesh, styletransfer_tpu_torch.parallel.dryrun\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'styletransfer_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
