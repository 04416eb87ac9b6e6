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
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'styletransfer_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


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
