"""The port's logging, its build-cache, platform and precision knobs
(``utils/cache.py``), and ``utils/profiling.py``'s ``trace`` and
``StepTimer``, held against the JAX package's ``tests/test_utils.py`` and
``tests/test_entry.py`` where both run here."""

import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from styletransfer_tpu_torch import constants
from styletransfer_tpu_torch.ops import layers
from styletransfer_tpu_torch.utils import cache
from styletransfer_tpu_torch.utils import logging as plogging

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, cwd=ROOT, **env):
    """``python -c code`` in ``cwd`` with ``env`` added and the package on
    the path."""
    full = dict(os.environ, **env)
    for k in ("STX_PLATFORM", "STX_MATMUL_PRECISION", "STX_COMPILE_CACHE_DIR",
              "STX_NO_COMPILE_CACHE"):
        if k not in env:
            full.pop(k, None)
    full["PYTHONPATH"] = os.pathsep.join([ROOT] + [p for p in [os.environ.get("PYTHONPATH")]
                                                   if p])
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=120, env=full)


# --- Logging (JAX tests/test_utils.py:60-84) ----------------------------------------

@pytest.fixture()
def configure(tmp_path, monkeypatch):
    """Configures the logger anew, with no handler on it, in ``tmp_path`` as
    the working directory; the handlers it had are put back afterwards (the
    JAX package's logger has the same name)."""
    logger = logging.getLogger(plogging._LOGGER_NAME)
    saved, level = logger.handlers[:], logger.level
    monkeypatch.chdir(tmp_path)

    def fresh():
        for h in logger.handlers:
            if h not in saved:
                h.close()
        logger.handlers = []
        monkeypatch.setattr(plogging, "_configured", False)
        return plogging.get_logger()

    yield fresh
    for h in logger.handlers:
        if h not in saved:
            h.close()
    logger.handlers, logger.level = saved, level


@pytest.fixture()
def fresh_logger(configure):
    return configure()


def test_handlers_of_another_package_stay(configure, monkeypatch):
    """A handler already on the logger of the same name (the JAX package's,
    in a process that imports both) stays beside the port's two."""
    other = logging.NullHandler()
    logger = logging.getLogger(plogging._LOGGER_NAME)
    logger.handlers = [other]
    monkeypatch.setattr(plogging, "_configured", False)
    got = plogging.get_logger()
    assert got.handlers[0] is other and len(got.handlers) == 3


def test_logger_singleton_and_handlers(fresh_logger, tmp_path):
    a, b = plogging.get_logger(), plogging.get_logger()
    assert a is b is fresh_logger
    assert a.name == "StyleTransfer" and a.level == logging.INFO
    consoles = [h for h in a.handlers if isinstance(h, plogging.TqdmLoggingHandler)]
    files = [h for h in a.handlers if isinstance(h, logging.FileHandler)]
    assert len(consoles) == 1 and len(files) == 1 and len(a.handlers) == 2
    assert files[0].baseFilename == str(tmp_path / constants.LOG_PATH)
    assert constants.LOG_PATH == os.path.join("runs", "runtime.log")
    assert files[0].mode == "w+"


def test_console_logs_go_to_stderr_not_stdout(fresh_logger, capsys):
    """The daemons' stdout carries one protocol line per request."""
    fresh_logger.warning("daemon-protocol-check %d", 7)
    cap = capsys.readouterr()
    assert "daemon-protocol-check 7" in cap.err
    assert "daemon-protocol-check" not in cap.out


def test_logger_emits_through_tqdm(fresh_logger, monkeypatch, capsys):
    import tqdm

    seen = []
    real = tqdm.tqdm.write

    def write(msg, file=None, **kw):
        seen.append((msg, file))
        real(msg, file=file, **kw)

    monkeypatch.setattr(tqdm.tqdm, "write", write)
    fresh_logger.info("hello from test %d", 42)
    assert len(seen) == 1 and "hello from test 42" in seen[0][0]
    assert seen[0][1] is sys.stderr  # resolved at emit time: pytest's capture
    assert "hello from test 42" in capsys.readouterr().err


def test_logger_writes_plainly_without_tqdm(fresh_logger, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "tqdm", None)  # import tqdm raises ImportError
    fresh_logger.info("no tqdm here")
    assert "no tqdm here" in capsys.readouterr().err


def test_log_file_is_truncated_by_each_run(tmp_path):
    """Each process writes ``runs/runtime.log`` anew (mode ``w+``), at the
    first log line and not at import."""
    code = ("import os, styletransfer_tpu_torch.engines.fast\n"
            "from styletransfer_tpu_torch.utils.logging import get_logger\n"
            "assert not os.path.exists('runs/runtime.log')\n"
            "get_logger().info('run %s', os.environ['RUN'])\n")
    for run in ("one", "two"):
        out = _run(code, cwd=str(tmp_path), RUN=run)
        assert out.returncode == 0, out.stderr
        text = (tmp_path / "runs" / "runtime.log").read_text()
        assert f"run {run}" in text and text.count(" - run ") == 1
        os.rename(tmp_path / "runs" / "runtime.log", tmp_path / f"{run}.log")


def test_unwritable_tree_logs_to_the_console_only(configure, tmp_path, monkeypatch, capsys):
    blocked = tmp_path / "blocked"
    blocked.mkdir()
    (blocked / "runs").write_text("a file where the runs directory would go")
    monkeypatch.chdir(blocked)
    logger = configure()
    assert [type(h) for h in logger.handlers] == [plogging.TqdmLoggingHandler]
    logger.info("still logging")
    assert "still logging" in capsys.readouterr().err


# --- The knobs (JAX tests/test_utils.py:10-58) ---------------------------------------

def test_cache_dir_default_and_override(monkeypatch, tmp_path):
    monkeypatch.delenv("STX_COMPILE_CACHE_DIR", raising=False)
    monkeypatch.delenv("STX_NO_COMPILE_CACHE", raising=False)
    assert cache.cache_dir() == os.path.join(ROOT, "build", "kernels")
    monkeypatch.setenv("STX_COMPILE_CACHE_DIR", str(tmp_path))
    assert cache.cache_dir() == str(tmp_path)


def test_compile_cache_dir_moves_the_kernel_libraries(tmp_path):
    code = ("from styletransfer_tpu_torch.ops.cuda import _build\n"
            "print(_build.BUILD_DIR)\nprint(_build._target('conv3x3'))\n")
    out = _run(code, STX_COMPILE_CACHE_DIR=str(tmp_path / "kernels"))
    assert out.returncode == 0, out.stderr
    build_dir, target = out.stdout.split()
    assert build_dir == str(tmp_path / "kernels")
    assert os.path.dirname(target) == build_dir
    assert os.path.basename(target).startswith("libconv3x3_")
    out = _run(code)
    assert out.stdout.split()[0] == os.path.join(ROOT, "build", "kernels")


def test_no_compile_cache_builds_into_a_new_directory_per_process():
    code = ("import os\nfrom styletransfer_tpu_torch.ops.cuda import _build\n"
            "from styletransfer_tpu_torch.utils import cache\n"
            "assert cache.cache_dir() == _build.BUILD_DIR\n"
            "assert os.path.isdir(_build.BUILD_DIR)\nprint(_build.BUILD_DIR)\n")
    dirs = []
    for _ in range(2):
        out = _run(code, STX_NO_COMPILE_CACHE="1", STX_COMPILE_CACHE_DIR="/nowhere")
        assert out.returncode == 0, out.stderr
        dirs.append(out.stdout.strip())
    assert dirs[0] != dirs[1]
    for d in dirs:
        assert not d.startswith(os.path.join(ROOT, "build")) and d != "/nowhere"
        assert not os.path.exists(d)  # removed at the process's exit


def test_doctor_reports_the_build_directory_in_effect(tmp_path):
    code = ("from styletransfer_tpu_torch.utils import doctor\n"
            "print([c.detail for c in doctor._kernel_checks() if c.name == 'kernel build'][0])\n")
    out = _run(code, STX_COMPILE_CACHE_DIR=str(tmp_path / "k"))
    assert out.returncode == 0, out.stderr
    assert str(tmp_path / "k") in out.stdout


@pytest.mark.subprocess
def test_platform_knob_makes_the_cpu_the_default_device(tmp_path):
    """``STX_PLATFORM=cpu``: the default device of the entry points and of
    the CLIs is the CPU, and ``fast_st convert-image`` without ``--device``
    runs here; unset, the same command asks for the GPU and raises, as it
    does with ``STX_PLATFORM=cuda``."""
    from PIL import Image

    from styletransfer_tpu_torch import ckpt
    from styletransfer_tpu_torch.models import transformer

    code = ("import inspect\nfrom styletransfer_tpu_torch import constants\n"
            "from styletransfer_tpu_torch.engines import fast\n"
            "print(constants.DEFAULT_DEVICE, "
            "inspect.signature(fast.process_image).parameters['device'].default, "
            "constants.resolve_device().type)\n")
    out = _run(code, STX_PLATFORM="cpu")
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["cpu", "cpu", "cpu"]
    out = _run(code, STX_PLATFORM="bogus")
    assert "STX_PLATFORM='bogus' is not one of cpu, cuda, gpu; ignoring." in out.stderr
    assert out.returncode != 0 and "no CUDA GPU is available" in out.stderr

    Image.fromarray(np.random.default_rng(0).integers(0, 256, (24, 24, 3), np.uint8)).save(
        tmp_path / "c.png")
    ckpt.save(transformer.init_params(seed=0, device="cpu"),
              ckpt.checkpoint_path("fast_st", "sty", 0, str(tmp_path / "data" / "models")))
    cli = ("from styletransfer_tpu_torch.clis import cli\n"
           "cli(['fast_st', 'convert-image', 'c.png', 'sty', '--size', '32'])\n")
    out = _run(cli, STX_PLATFORM="cpu", STX_PROJECT_ROOT=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert (tmp_path / "results" / "converted_fast_st_sty.png").is_file()
    for env in ({}, {"STX_PLATFORM": "cuda"}):
        out = _run(cli, STX_PROJECT_ROOT=str(tmp_path), **env)
        assert out.returncode != 0 and "no CUDA GPU is available" in out.stderr


def _flags():
    return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())


@pytest.fixture()
def restore_flags():
    saved = _flags()
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved[:2]
    torch.set_float32_matmul_precision(saved[2])


OFF = (False, False, "highest")
TF32 = (True, True, "high")
BF16 = (True, True, "medium")


@pytest.mark.parametrize("value, want", [
    (None, OFF), ("highest", OFF), ("float32", OFF),
    ("high", TF32), ("tensorfloat32", TF32), ("default", TF32),
    ("bfloat16", BF16), ("bfloat16_3x", BF16)])
def test_matmul_precision_knob_sets_the_flags(monkeypatch, restore_flags, value, want):
    """Each value through ``layers.disable_tf32`` (what every engine calls);
    unset, TF32 stays off as before the knob existed."""
    if value is None:
        monkeypatch.delenv("STX_MATMUL_PRECISION", raising=False)
    else:
        monkeypatch.setenv("STX_MATMUL_PRECISION", value)
    torch.backends.cudnn.allow_tf32 = True  # torch's own default
    layers.disable_tf32()
    assert _flags() == want


def test_matmul_precision_unset_or_bogus_changes_nothing(monkeypatch, restore_flags, caplog):
    """As JAX's ``apply_matmul_precision``: unset, or not one of the valid
    values (a warning, once), the knob leaves the flags as they are; a bogus
    value in ``disable_tf32`` gives the flags of the knob unset."""
    monkeypatch.setenv("STX_MATMUL_PRECISION", "high")
    assert cache.apply_matmul_precision() and _flags() == TF32
    monkeypatch.setenv("STX_MATMUL_PRECISION", "bogus")
    monkeypatch.setattr(cache, "_warned", set())
    with caplog.at_level(logging.WARNING, logger="StyleTransfer"):
        assert not cache.apply_matmul_precision() and _flags() == TF32
        assert not cache.apply_matmul_precision()
    warnings = [r for r in caplog.records if "STX_MATMUL_PRECISION='bogus'" in r.message]
    assert len(warnings) == 1
    monkeypatch.delenv("STX_MATMUL_PRECISION")
    assert not cache.apply_matmul_precision() and _flags() == TF32
    monkeypatch.setenv("STX_MATMUL_PRECISION", "bogus")
    layers.disable_tf32()
    assert _flags() == OFF


def test_knobs_are_applied_at_import():
    code = ("import torch\nimport styletransfer_tpu_torch\n"
            "print(torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)\n")
    assert _run(code, STX_MATMUL_PRECISION="highest").stdout.split() == ["False", "False"]
    assert _run(code, STX_MATMUL_PRECISION="high").stdout.split() == ["True", "True"]
    # Unset: torch's own defaults, untouched until an engine runs.
    assert _run(code).stdout.split() == ["True", "False"]


# --- trace and StepTimer (JAX tests/test_entry.py:26-35) ------------------------------

def test_step_timer():
    from styletransfer_tpu_torch.utils.profiling import StepTimer

    t = StepTimer(items_per_step=4, skip=1)
    assert np.isnan(t.rate())
    for _ in range(5):
        t.step()
    assert t.timed_steps == 4
    assert t.rate() > 0
    assert "items/s" in t.summary()


def test_step_timer_skip_zero_times_every_step():
    from styletransfer_tpu_torch.utils.profiling import StepTimer

    t = StepTimer(items_per_step=2, skip=0)
    assert t.timed_steps == 0 and np.isnan(t.rate())
    t.step()
    assert t.timed_steps == 1 and t.rate() > 0
    assert t.summary().endswith("items/s over 1 steps")


def test_trace_writes_a_chrome_trace(tmp_path, caplog):
    import json

    from styletransfer_tpu_torch.utils.profiling import trace

    with caplog.at_level(logging.INFO, logger="StyleTransfer"):
        with trace(str(tmp_path / "profile"), device="cpu"):
            x = torch.ones((32, 32))
            (x @ x).sum()
    (name,) = os.listdir(tmp_path / "profile")
    path = tmp_path / "profile" / name
    assert name.endswith(".json") and path.stat().st_size > 0
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert any(str(path) in r.message for r in caplog.records)


@pytest.mark.parametrize("kernel,group", [
    ("void (anonymous namespace)::upconv_phase_f32_kernel<64>(float const*, float const*, "
     "float const*, float*, Shape)", "upconv_phase kernel"),
    ("void (anonymous namespace)::conv9x9_f32_kernel<(anonymous namespace)::Tile<32, 3, 16, 3, "
     "32, 8, 4, 1> >(float const*, float const*, float const*, float*, Shape)",
     "conv9x9 kernel"),
    ("void (anonymous namespace)::conv3x3_f32_kernel<8>(Args)", "conv3x3 kernel"),
    ("void (anonymous namespace)::direct_kernel<float, 9>(Args)", "conv_direct kernel"),
    ("void pointwise_mult_and_sum_complex<float2, 8, 4>(float2*)", "cuDNN convolutions"),
    ("void at::native::vectorized_elementwise_kernel<4>(int)",
     "other (copies, pads, elementwise)"),
])
def test_profile_groups_each_kernel_by_its_name(kernel, group):
    """The profile's breakdown: each hand-written kernel in its own group,
    ahead of the library convs, whose keys ("conv") its name also holds."""
    from styletransfer_tpu_torch.utils.profiling import _group

    assert _group(kernel) == group
