"""The port's serving executables on CUDA graphs (``utils/aot.py``) on the
CPU: off, or on with CPU tensors, ``cached_compile`` hands back ``fn``
itself (JAX ``tests/test_aot.py``'s disabled case); the keying by shape and
the copy-in of the inputs, through a fake graph; and ``process_image`` /
``process_dir`` under ``STX_AOT_CACHE=1`` writing the PNGs they write
without it. The capture itself runs on the card (``chip_smoke.py``)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from styletransfer_tpu_torch import ckpt, constants
from styletransfer_tpu_torch.engines import fast
from styletransfer_tpu_torch.models import transformer
from styletransfer_tpu_torch.utils import aot


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fn(scale, x, y):
    return torch.tanh(x) * scale.weight.sum() + y


@pytest.fixture()
def scale():
    m = torch.nn.Linear(2, 1, bias=False)
    with torch.no_grad():
        m.weight.fill_(0.5)
    return m


def test_off_returns_fn_itself(monkeypatch, scale):
    monkeypatch.delenv("STX_AOT_CACHE", raising=False)
    x = torch.ones(2, 3)
    assert aot.cached_compile(_fn, (scale, x, x), "t") is _fn
    monkeypatch.setenv("STX_AOT_CACHE", "0")
    assert aot.cached_compile(_fn, (scale, x, x), "t") is _fn


def test_on_with_cpu_tensors_returns_fn_itself(monkeypatch, scale):
    monkeypatch.setenv("STX_AOT_CACHE", "1")
    x = torch.ones(2, 3)
    assert aot.cached_compile(_fn, (scale, x, x), "t") is _fn
    assert aot.cached_compile(_fn, (scale,), "t") is _fn
    assert aot.cached_compile(_fn, (), "t") is _fn


class _FakeGraph:
    """Replays ``fn`` on the static inputs into the static output, in place,
    as a captured graph does."""

    def __init__(self, fn, static, out):
        self.fn, self.static, self.out = fn, static, out

    def replay(self):
        self.out.copy_(self.fn(*self.static))


@pytest.fixture()
def fake_graphs(monkeypatch):
    """``cached_compile`` on CPU tensors with a fake capture; returns the
    calls of ``fn`` it made and the captures."""
    calls, captured = [], []
    monkeypatch.setenv("STX_AOT_CACHE", "1")
    monkeypatch.setattr(aot, "_on_cuda", lambda args: True)
    monkeypatch.setattr(aot, "captures", 0)
    monkeypatch.setattr(aot, "replays", 0)

    def capture(fn, static, device):
        for _ in range(aot.WARMUP):
            fn(*static)
        out = fn(*static)
        captured.append(([tuple(s.shape) for s in static if isinstance(s, torch.Tensor)],
                         [s.data_ptr() for s in static if isinstance(s, torch.Tensor)]))
        return _FakeGraph(fn, static, out), out, None

    def counted(*args):
        calls.append(args)
        return _fn(*args)

    monkeypatch.setattr(aot, "_capture", capture)
    return counted, calls, captured


def test_one_graph_per_shape_and_inputs_copied_in(fake_graphs, scale):
    counted, calls, captured = fake_graphs
    serve = aot.cached_compile(counted, (scale, torch.zeros(1)), "t")
    assert isinstance(serve, aot._Graphed)
    rng = np.random.default_rng(0)

    def inputs(n):
        return (torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32)),
                torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32)))

    a, b, c = inputs(4), inputs(4), inputs(2)
    outs = [serve(scale, *a), serve(scale, *b), serve(scale, *c), serve(scale, *a)]
    for out, (x, y) in zip(outs, [a, b, c, a]):
        torch.testing.assert_close(out, _fn(scale, x, y), rtol=0, atol=0)
    # One capture for each shape (4 and 2 rows), each after WARMUP eager runs;
    # every call replayed, the first of each shape included.
    assert aot.captures == 2 and aot.replays == 4
    assert [shapes for shapes, _ in captured] == [[(4, 3), (4, 3)], [(2, 3), (2, 3)]]
    assert len(calls) == 2 * (aot.WARMUP + 1) + 4  # the fake replays call fn too
    # The static buffers are the graph's own, not the caller's tensors.
    ptrs = captured[0][1]
    assert a[0].data_ptr() not in ptrs and b[0].data_ptr() not in ptrs
    # The caller gets a clone: changing it leaves the next replay alone.
    outs[1].fill_(7.0)
    torch.testing.assert_close(serve(scale, *b), _fn(scale, *b), rtol=0, atol=0)


def test_dtype_and_module_are_part_of_the_key(fake_graphs, scale):
    counted, _, captured = fake_graphs
    serve = aot.cached_compile(counted, (scale,), "t")
    x = torch.ones(2, 3)
    serve(scale, x, x)
    serve(scale, x.double(), x.double())
    other = torch.nn.Linear(2, 1, bias=False)
    serve(other, x, x)
    serve(scale, x, x)
    assert aot.captures == 3 and aot.replays == 4


def test_a_failed_capture_warns_and_runs_eagerly(monkeypatch, scale, caplog):
    monkeypatch.setenv("STX_AOT_CACHE", "1")
    monkeypatch.setattr(aot, "_on_cuda", lambda args: True)
    monkeypatch.setattr(aot, "captures", 0)
    monkeypatch.setattr(aot, "replays", 0)
    tries = []

    def failing(fn, static, device):
        tries.append(1)
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(aot, "_capture", failing)
    serve = aot.cached_compile(_fn, (scale,), "fast_serve")
    x = torch.ones(2, 3)
    with caplog.at_level("WARNING", logger="StyleTransfer"):
        for _ in range(3):
            torch.testing.assert_close(serve(scale, x, x), _fn(scale, x, x))
    assert len(tries) == 1 and aot.captures == 0 and aot.replays == 0
    (warning,) = [r.message for r in caplog.records if "AOT cache" in r.message]
    assert "fast_serve" in warning and "operation not permitted" in warning


@pytest.mark.parametrize("path", ["image", "dir"])
def test_serving_paths_write_the_same_pngs_under_the_flag(tmp_path, monkeypatch, path):
    monkeypatch.setattr(constants, "PROJECT_ROOT_PATH", str(tmp_path))
    monkeypatch.setattr(aot, "captures", 0)
    rng = np.random.default_rng(2)
    (tmp_path / "in").mkdir()
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (40, 36, 3), dtype=np.uint8)).save(
            tmp_path / "in" / f"p{i}.png")
    models = str(tmp_path / "data" / "models")
    ckpt.save(transformer.init_params(seed=1, device="cpu"),
              ckpt.checkpoint_path("fast_st", "sty", 0, models))

    def run(flag):
        monkeypatch.setenv("STX_AOT_CACHE", flag)
        out = f"out{flag}"
        if path == "image":
            paths = [fast.process_image("in/p0.png", "sty", out_dir=out, models_path=models,
                                        size=32, device="cpu")]
        else:
            paths = fast.process_dir("in", "sty", out_dir=out, batch_size=2,
                                     models_path=models, size=32, device="cpu")
        return {os.path.basename(p): np.asarray(Image.open(p)) for p in paths}

    eager, flagged = run("0"), run("1")
    assert sorted(eager) == sorted(flagged) and len(eager) == (1 if path == "image" else 3)
    for name in eager:
        np.testing.assert_array_equal(flagged[name], eager[name])
    assert aot.captures == 0  # CPU tensors: fn itself ran
