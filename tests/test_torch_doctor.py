"""The port's ``doctor`` (``utils/doctor.py``, ``clis/doctor.py``) and demo
assets (``utils/demo.py``) against the JAX package's: the rows that apply to
both, the exit codes, the card's probe failing without a GPU, and the demo
images and PNGs byte for byte."""

import click.testing
import numpy as np
import pytest
import torch

from styletransfer_tpu import constants as jconstants
from styletransfer_tpu.utils import demo as jdemo
from styletransfer_tpu.utils import doctor as jdoctor
from styletransfer_tpu_torch import constants as tconstants
from styletransfer_tpu_torch.clis import cli
from styletransfer_tpu_torch.utils import demo, doctor

# The rows of both packages' doctors; the JAX package's others are its
# backends and its compile cache, the port's its CPU probe, nvcc and its
# kernel build.
SHARED_ROWS = ["versions", "project root", "vgg19 weights", "mp4 codecs", "demo assets",
               "checkpoints"]


@pytest.fixture
def root(tmp_path, monkeypatch):
    monkeypatch.setattr(jconstants, "PROJECT_ROOT_PATH", str(tmp_path))
    monkeypatch.setattr(tconstants, "PROJECT_ROOT_PATH", str(tmp_path))
    monkeypatch.delenv("STX_VGG19_WEIGHTS", raising=False)
    return tmp_path


def _rows(checks):
    return {c.name: c for c in checks}


@pytest.mark.parametrize("with_assets", [False, True])
def test_rows_of_both_doctors_agree_without_probes(root, with_assets):
    if with_assets:
        demo.ensure_demo_assets()
        (root / "data" / "models").mkdir(parents=True)
        (root / "data" / "models" / "fast_st_x_epoch0.msgpack").write_bytes(b"")
    port, jax_rows = doctor.run_checks(backend="none"), jdoctor.run_checks(backend="none")
    names = [c.name for c in port]
    assert [n for n in names if n in SHARED_ROWS] == SHARED_ROWS
    assert [c.name for c in jax_rows if c.name in SHARED_ROWS] == SHARED_ROWS
    assert names == ["versions", "project root", "nvcc", "kernel build", *SHARED_ROWS[2:]]
    t, j = _rows(port), _rows(jax_rows)
    for name in ("project root", "vgg19 weights", "demo assets", "checkpoints"):
        assert t[name].status == j[name].status, name
    assert t["checkpoints"].detail == j["checkpoints"].detail
    assert "torch " + torch.__version__ in t["versions"].detail
    assert t["kernel build"].status in ("ok", "warn")


def test_kernel_build_row_names_the_sources_without_a_library(root, monkeypatch, tmp_path):
    from styletransfer_tpu_torch.ops.cuda import _build

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setattr(_build, "_target",
                        lambda name: str(tmp_path / "kernels" / f"lib{name}_h.so"))
    (tmp_path / "kernels").mkdir()
    names = _build.sources()
    (tmp_path / "kernels" / f"lib{names[0]}_h.so").write_bytes(b"")
    row = _rows(doctor.run_checks(backend="none"))["kernel build"]
    assert row.status == "warn" and f"1 of {len(names)}" in row.detail
    assert row.detail.split("first use: ")[1].split(", ") == names[1:]
    for name in names[1:]:
        (tmp_path / "kernels" / f"lib{name}_h.so").write_bytes(b"")
    assert _rows(doctor.run_checks(backend="none"))["kernel build"].status == "ok"


@pytest.mark.parametrize("backend", ["none", "cpu"])
def test_doctor_exits_0_without_a_failure(root, backend):
    res = click.testing.CliRunner().invoke(cli, ["doctor", "--backend", backend])
    assert res.exit_code == 0, res.output
    for name in SHARED_ROWS:
        assert f"] {name}: " in res.output
    assert ("[ OK ] backend (cpu): cpu" in res.output) == (backend == "cpu")
    assert "] backend: " not in res.output


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the machine without a GPU")
def test_doctor_auto_fails_on_the_card_without_a_gpu(root):
    res = click.testing.CliRunner().invoke(cli, ["doctor"])
    assert res.exit_code == 1, res.output
    assert "[FAIL] backend: no CUDA GPU" in res.output
    assert "[ OK ] backend (cpu): cpu" in res.output  # probed, not put in the card's place


def test_probe_timeout_is_a_failure(monkeypatch):
    import subprocess

    def hang(*args, **kwargs):
        raise subprocess.TimeoutExpired(args[0], kwargs["timeout"])

    monkeypatch.setattr(subprocess, "run", hang)
    check = doctor._probe("cuda", 5.0)
    assert check.status == "fail" and "no answer in 5s" in check.detail


@pytest.mark.parametrize("fn,kw", [("demo_content_image", {}),
                                   ("demo_content_image", {"size": 64, "seed": 3}),
                                   ("demo_style_image", {}),
                                   ("demo_style_image", {"size": 48, "seed": 1})])
def test_demo_images_equal_jax(fn, kw):
    np.testing.assert_array_equal(getattr(demo, fn)(**kw), getattr(jdemo, fn)(**kw))


def test_ensure_demo_assets_writes_the_jax_pngs_once(tmp_path):
    got = demo.ensure_demo_assets(str(tmp_path / "port"))
    want = jdemo.ensure_demo_assets(str(tmp_path / "jax"))
    for key in ("content", "style"):
        with open(got[key], "rb") as a, open(want[key], "rb") as b:
            assert a.read() == b.read()
    mtime = (tmp_path / "port" / "demo_content.png").stat().st_mtime_ns
    assert demo.ensure_demo_assets(str(tmp_path / "port")) == got
    assert (tmp_path / "port" / "demo_content.png").stat().st_mtime_ns == mtime
