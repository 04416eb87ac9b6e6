"""The port's ``gatys_st`` command end to end on the CPU (``--device cpu``,
32 px, 2 steps): one image, a directory, a style blend, coarse-to-fine and
Adam; its options and defaults against the JAX command's; and its refusal to
run without a GPU unless asked for the CPU."""

import os

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from styletransfer_tpu.clis import cli as jax_cli
from styletransfer_tpu_torch import constants
from styletransfer_tpu_torch.clis import cli

FAST = ["-s", "2", "--size", "32", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU ops here are small: one thread each, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def root(tmp_path, monkeypatch):
    """A project root holding two content images, a content directory and
    two styles; results land in its ``results/``."""
    monkeypatch.setattr(constants, "PROJECT_ROOT_PATH", str(tmp_path))
    rng = np.random.default_rng(0)

    def save(name, shape=(40, 48, 3)):
        path = tmp_path / name
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, size=shape, dtype=np.uint8)).save(path)

    save("content.png")
    save("s1.png")
    save("s2.png", (36, 36, 3))
    for name in ("a.png", "a.jpg", "b.png", "c.png"):
        save(f"dir/{name}")
    return tmp_path


def _run(args):
    result = CliRunner().invoke(cli, ["gatys_st", *args])
    assert result.exit_code == 0, result.output + repr(result.exception)
    return result


def _png(path):
    arr = np.asarray(Image.open(path))
    assert arr.shape == (32, 32, 3) and arr.dtype == np.uint8
    return arr


def test_single_image_writes_the_default_output_name(root):
    _run(["content.png", "s1.png", *FAST])
    _png(root / "results" / "gatys_converted.png")


def test_directory_batch_takes_the_first_b_images_and_keeps_colliding_stems(root):
    _run(["dir", "s1.png", "-b", "3", "-n", "out.png", *FAST])
    # sorted: a.jpg, a.png, b.png (c.png is past -b 3); a.jpg and a.png share a stem.
    assert sorted(os.listdir(root / "results")) == ["out_a.png", "out_a_2.png", "out_b.png"]
    outs = [_png(root / "results" / n) for n in ("out_a.png", "out_a_2.png", "out_b.png")]
    assert not np.array_equal(outs[0], outs[1])


def test_style_blend_spec(root):
    _run(["content.png", "s1.png,s2.png:1,3", "-n", "blend.png", *FAST])
    blend = _png(root / "results" / "blend.png")
    _run(["content.png", "s1.png", "-n", "single.png", *FAST])
    assert not np.array_equal(blend, _png(root / "results" / "single.png"))


def test_bad_blend_spec_is_a_usage_error(root):
    result = CliRunner().invoke(cli, ["gatys_st", "content.png", "s1.png,s2.png:nan,1", *FAST])
    assert result.exit_code == 2 and "finite" in result.output


@pytest.mark.parametrize("extra", [["--coarse-steps", "1", "--size", "64"],
                                   ["--optimizer", "adam"],
                                   ["--optimizer", "lbfgs-zoom"],
                                   ["--optimizer", "lbfgs-zoom", "--coarse-steps", "1",
                                    "--size", "64"],
                                   ["--history-math", "two_loop", "--history-size", "3"],
                                   ["--precision", "bf16"]])
def test_options_run_end_to_end(root, extra):
    _run(["content.png", "s1.png", *FAST, *extra])  # a repeated option: the last wins
    arr = np.asarray(Image.open(root / "results" / "gatys_converted.png"))
    assert arr.dtype == np.uint8 and arr.shape[2] == 3


def test_options_and_defaults_match_the_jax_command():
    port = {p.name: p for p in cli.commands["gatys_st"].params}
    jax = {p.name: p for p in jax_cli.commands["gatys_st"].params}
    # Every JAX option, the daemon's (--serve, --tcp, --http) included; added:
    # --device. --history-size defaults to None in both: 100 for one-shot
    # runs, 16 for the daemon (tests/test_torch_serve_cli.py).
    assert set(jax) - set(port) == set()
    assert set(port) - set(jax) == {"device"}
    assert port["device"].default == "cuda"
    for name in set(port) & set(jax):
        assert port[name].default == jax[name].default, name
        assert port[name].opts == jax[name].opts, name
    assert list(port["optimizer"].type.choices) == list(jax["optimizer"].type.choices) == [
        "adam", "lbfgs", "lbfgs-zoom"]
    assert list(port["history_math"].type.choices) == list(jax["history_math"].type.choices)


@pytest.mark.parametrize("args,logged", [
    (["--serve"], "L-BFGS history size 16 (the daemon's default)"),
    (["--serve", "--history-size", "100"], "L-BFGS history size 100 (--history-size)"),
    (["content.png", "s1.png"], "L-BFGS history size 100 (the one-shot default)"),
    (["content.png", "s1.png", "--history-size", "7"], "L-BFGS history size 7 (--history-size)"),
    (["--serve", "--optimizer", "lbfgs-zoom", "--history-size", "4"],
     "lbfgs-zoom keeps optax's fixed memory of 10"),
    (["content.png", "s1.png", "--optimizer", "lbfgs-zoom"],
     "lbfgs-zoom keeps optax's fixed memory of 10")])
def test_history_in_effect_is_logged_with_its_source(root, monkeypatch, caplog, args, logged):
    """The daemon's H = 16 differs from the one-shot run's H = 100 without a
    word in the JAX package; the port says which it takes, and why."""
    from styletransfer_tpu_torch.engines import gatys

    seen = {}

    def stub(**kw):
        seen.update(kw)
        return 0

    monkeypatch.setattr(gatys, "serve_loop", stub)
    monkeypatch.setattr(gatys, "train_gatys", lambda *a, **kw: (seen.update(kw), (
        torch.zeros((1, 32, 32, 3)), None))[1])
    caplog.set_level("INFO")
    _run([*args, *FAST])
    assert logged in caplog.text
    if "lbfgs-zoom" not in args:
        assert f"history size {seen['history_size']} " in caplog.text


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a GPU")


def test_without_device_it_raises_instead_of_using_the_cpu(no_gpu, root):
    result = CliRunner().invoke(cli, ["gatys_st", "content.png", "s1.png", "-s", "1"])
    assert result.exit_code != 0
    assert "no CUDA GPU" in str(result.exception)
    assert not (root / "results").exists()
