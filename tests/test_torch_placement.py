"""Multi-device serving placement in the port (parallel/mesh.py and the
batched serving paths' ``devices``) on the CPU, over the device list
``[cpu, cpu]``: each shard of a batch is launched on its own slot with its
replica and the outputs are gathered, so every path must give what one
device gives. Image outputs are held to the serving limits (1/255, mean
0.05); video lanes and streams to 0/255 (the lanes are batch-invariant);
Gatys lanes to the request alone. Every loop runs in a worker thread joined
with a timeout."""

import io
import logging
import os
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from styletransfer_tpu_torch import ckpt
from styletransfer_tpu_torch.data import video as video_data
from styletransfer_tpu_torch.engines import fast, gatys, multistyle, video
from styletransfer_tpu_torch.models import multistyle as ms_model
from styletransfer_tpu_torch.models import transformer, vgg
from styletransfer_tpu_torch.parallel import mesh
from styletransfer_tpu_torch.utils import images

SIZE = 32
TWO = ["cpu", "cpu"]
LOOP_TIMEOUT_S = 300
# The serving limits of f32 uint8 outputs (PERF.md §2): max steps, mean steps.
SERVE_MAX, SERVE_MEAN = 1, 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def pngs(tmp_path):
    rng = np.random.default_rng(31)

    def make(names, side=40):
        out = {}
        for n in names:
            p = tmp_path / f"{n}.png"
            Image.fromarray(rng.integers(0, 256, (side, side, 3), dtype=np.uint8)).save(p)
            out[n] = str(p)
        return out
    return make


def _serve(loop, lines, **kw):
    out, box = io.StringIO(), {}

    def target():
        try:
            box["n"] = loop(stdin=io.StringIO("".join(f"{ln}\n" for ln in lines) + "\n"),
                            stdout=out, **kw)
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            box["exc"] = exc
    th = threading.Thread(target=target, daemon=True)
    th.start()
    th.join(LOOP_TIMEOUT_S)
    assert not th.is_alive(), f"the serve loop did not end within {LOOP_TIMEOUT_S} s"
    if "exc" in box:
        raise box["exc"]
    return box["n"], out.getvalue().splitlines()


def _u8(path):
    return np.asarray(Image.open(path)).astype(np.int32)


def _within_serving_limits(a, b):
    diff = np.abs(_u8(a) - _u8(b))
    assert diff.max() <= SERVE_MAX and diff.mean() <= SERVE_MEAN, (a, b)


@pytest.mark.parametrize("n,parts,want", [
    (4, 2, [(0, 2), (2, 4)]), (5, 2, [(0, 3), (3, 5)]), (1, 2, [(0, 1)]),
    (7, 3, [(0, 3), (3, 5), (5, 7)]), (0, 2, []), (3, 1, [(0, 3)])])
def test_shard_bounds_split_evenly_and_leave_out_empty_parts(n, parts, want):
    assert mesh.shard_bounds(n, parts) == want


def test_serving_placement_picks_the_devices_that_divide_the_batch(caplog):
    params = transformer.init_params(0, device="cpu")
    with caplog.at_level(logging.WARNING, logger="StyleTransfer"):
        assert mesh.serving_placement(1, params, TWO).devices == [torch.device("cpu")]
        assert not caplog.records  # a serial path is no misconfiguration
        assert len(mesh.serving_placement(4, params, TWO).devices) == 2
        assert not caplog.records
        assert len(mesh.serving_placement(3, params, TWO).devices) == 1
    assert "2 available devices; using a 1-device mesh (1 device(s) idle)" in \
        caplog.records[0].getMessage()
    assert mesh.default_devices("cpu") == [torch.device("cpu")]
    assert mesh.serving_placement(4, params, device="cpu").devices == [torch.device("cpu")]


def test_replicas_are_shared_on_one_device_copied_to_others_and_replaced_on_reload():
    """The meta device stands in for a second card: its replica is a copy;
    place_params (a daemon's RELOAD) replaces every replica."""
    params = transformer.init_params(0, device="cpu")
    placement = mesh.Placement(["cpu", "cpu", "meta"], params)
    first, second, meta = placement.replicas
    assert first is params and second is params
    assert meta is not params and next(meta.parameters()).device.type == "meta"
    new = transformer.init_params(1, device="cpu")
    assert placement.place_params(new) is new
    assert placement.replicas[1] is new and placement.replicas[2] is not meta
    vgg_params = {"conv1_1": {"kernel": torch.ones(2), "bias": torch.zeros(2)}}
    copies = mesh.replicate(vgg_params, [torch.device("cpu"), torch.device("meta")])
    assert copies[0] is vgg_params and copies[1]["conv1_1"]["kernel"].device.type == "meta"


def test_run_splits_each_array_and_gathers_in_order():
    placement = mesh.Placement(TWO, transformer.init_params(0, device="cpu"))
    seen = []

    def fn(params, x, w):
        seen.append((x.shape[0], w.shape[0]))
        return x * w[:, None]

    out = placement.run(fn, np.arange(10, dtype=np.float32).reshape(5, 2),
                        np.arange(5, dtype=np.float32))
    assert seen == [(3, 3), (2, 2)]
    np.testing.assert_array_equal(out.cpu().numpy(),
                                  np.arange(10).reshape(5, 2) * np.arange(5)[:, None])


def test_process_dir_over_two_devices_is_the_one_device_run(tmp_path, pngs):
    """Five images at batch 4 (a ragged last batch of 1), each batch split
    over two slots."""
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    for name, path in pngs([f"img{i}" for i in range(5)]).items():
        os.replace(path, in_dir / f"{name}.png")
    params = transformer.init_params(2, device="cpu")
    kw = dict(style_name="sty", batch_size=4, params=params, size=SIZE, device="cpu")
    two = fast.process_dir(str(in_dir), out_dir=str(tmp_path / "two"), devices=TWO, **kw)
    one = fast.process_dir(str(in_dir), out_dir=str(tmp_path / "one"), **kw)
    assert [os.path.basename(p) for p in two] == [os.path.basename(p) for p in one]
    assert len(two) == 5
    for a, b in zip(two, one):
        _within_serving_limits(a, b)


def test_fast_serve_loop_over_two_devices_and_its_reload(tmp_path, pngs):
    """``fast_st serve -b 4`` over two slots gives the one-device daemon's
    images, before and after a RELOAD that swaps every replica for the
    newer checkpoint (the daemon starts on parameters given to it)."""
    p = pngs(["a", "b", "c", "d", "e"])
    models = str(tmp_path / "models")
    ckpt.save_epoch(transformer.init_params(3, device="cpu"), "fast_st", "sty", 1, models)
    kw = dict(style_name="sty", params=transformer.init_params(2, device="cpu"),
              models_path=models, size=SIZE, batch_size=4, device="cpu")

    def session(sub, **more):
        lines = [p["a"], p["b"], p["c"], "RELOAD", p["d"], p["e"],
                 f"{p['a']}\t{tmp_path}/{sub}_after.png"]
        return _serve(fast.serve_loop, lines, out_dir=str(tmp_path / sub), **kw, **more)

    n2, two = session("two", devices=TWO)
    n1, one = session("one")
    assert n2 == n1 == 7
    assert two[0] == "READY" and two[4] == one[4] == "OK RELOAD epoch=1"
    for a, b in zip(two[1:], one[1:]):
        if "RELOAD" not in a:
            _within_serving_limits(a.split(" ", 1)[1], b.split(" ", 1)[1])
    # The last request (image a again) ran on the reloaded parameters.
    assert (_u8(two[7].split(" ", 1)[1]) != _u8(two[1].split(" ", 1)[1])).any()


def test_multistyle_serve_loop_over_two_devices(tmp_path, pngs):
    p = pngs(["a", "b", "c"])
    params = ms_model.init_params(4, 2, device="cpu")
    lines = [f"{p['a']}\t\t1", f"{p['b']}\t\t0.5,0.5", f"{p['c']}", f"{p['a']}\t\t0"]
    kw = dict(name="duo", num_styles=2, params=params, size=SIZE, batch_size=4, device="cpu")
    n2, two = _serve(multistyle.serve_loop, lines, out_dir=str(tmp_path / "two"),
                     devices=TWO, **kw)
    n1, one = _serve(multistyle.serve_loop, lines, out_dir=str(tmp_path / "one"), **kw)
    assert n2 == n1 == 4
    for a, b in zip(two[1:], one[1:]):
        assert os.path.basename(a) == os.path.basename(b)
        _within_serving_limits(a.split(" ", 1)[1], b.split(" ", 1)[1])


def _write_gif(path, n, seed, side=16):
    from styletransfer_tpu_torch.data.coco import synthetic_image

    base = (synthetic_image(seed, side) * 255).astype(np.uint8)
    frames = [Image.fromarray(np.roll(base, i, axis=1)) for i in range(n)]
    frames[0].save(path, save_all=True, append_images=frames[1:], duration=40, loop=0)
    return path


def test_process_video_dir_lanes_over_two_devices_are_each_clip_alone(tmp_path, monkeypatch):
    """Clips of 2, 3 and 1 frames at batch 3: lanes (a, b) on one slot and
    (c) on the other, each device keeping its lanes' carries; every clip is
    bit for bit ``stylize_clip`` of its frames alone."""
    params = transformer.init_video_params(5, device="cpu")
    written = {}
    real = video._open_video_writer

    class Recorder:
        def __init__(self, writer, frames):
            self.writer, self.frames = writer, frames

        def append_data(self, frame):
            self.frames.append(np.array(frame))
            self.writer.append_data(frame)

        def close(self):
            self.writer.close()

    def opener(base, fps, logger):
        writer, path = real(base, fps, logger)
        return Recorder(writer, written.setdefault(path, [])), path

    monkeypatch.setattr(video, "_open_video_writer", opener)
    in_dir = tmp_path / "clips"
    in_dir.mkdir()
    lengths = {"a": 2, "b": 3, "c": 1}
    for i, (name, n) in enumerate(lengths.items()):
        _write_gif(str(in_dir / f"{name}.gif"), n, i + 1)
    outs = video.process_video_dir(str(in_dir), style_name="sty", out_dir=str(tmp_path / "res"),
                                   params=params, batch_size=3, chunk_size=2, device="cpu",
                                   devices=TWO)
    assert [os.path.basename(p) for p in outs] == [f"video_st_sty_{n}.gif" for n in lengths]
    for (name, n), out in zip(lengths.items(), outs):
        reader = video_data.ImageioFrameReader(str(in_dir / f"{name}.gif"), normalized=False)
        frames = np.stack([reader.next_frame()[0] for _ in range(n)])
        reader.close()
        want = np.stack([images.to_uint8(f) for f in video.stylize_clip(params, frames)])
        np.testing.assert_array_equal(np.stack(written[out]), want, err_msg=name)


def test_video_serve_streams_over_two_devices_are_each_stream_alone(tmp_path, pngs):
    """Three interleaved streams at ``-b 4``: each wave's lanes split over
    two slots, the carries in the first one's slot table; every stream's
    PNGs are exactly ``_stylize_chunk`` of its frames."""
    p = pngs([f"f{i}" for i in range(7)])
    params = transformer.init_video_params(6, device="cpu")
    streams = {"0": ["f0", "f1", "f2"], "cam": ["f3", "f4"], "x": ["f5", "f6"]}
    lines = []
    for t in range(3):
        for sid, names in streams.items():
            if t < len(names):
                lines.append(f"{p[names[t]]}\t{tmp_path}/out_{sid}_{t}.png\t{sid}")
    n, out = _serve(video.serve_stream_loop, lines, style_name="sty", params=params,
                    size=SIZE, batch_size=4, device="cpu", devices=TWO,
                    out_dir=str(tmp_path / "res"))
    assert n == 7 and all(line.startswith("OK ") for line in out[1:])
    for sid, names in streams.items():
        frames = torch.from_numpy(np.stack([
            np.asarray(images.load_image_uint8(p[k], size=SIZE))[0] for k in names]))[:, None]
        want = video._stylize_chunk(params, frames,
                                    images.maybe_normalize_on_device(frames[0]))
        want = images.to_uint8_on_device(want)[:, 0].numpy()
        for t in range(len(names)):
            np.testing.assert_array_equal(_u8(f"{tmp_path}/out_{sid}_{t}.png"), want[t],
                                          err_msg=f"{sid} {t}")


def test_gatys_serve_lanes_over_two_devices_are_each_request_alone(tmp_path, pngs):
    """Two requests with different styles at ``-b 2``, Adam: one lane on
    each slot, each the request served alone."""
    p = pngs(["c1", "c2", "s1", "s2"])
    vgg_params = vgg.init_params(0, device="cpu")
    lines = [f"{p['c1']}\t{p['s1']}", f"{p['c2']}\t{p['s2']}"]
    kw = dict(steps=2, optimizer="adam", size=SIZE, vgg_params=vgg_params, device="cpu")
    n2, two = _serve(gatys.serve_loop, lines, out_dir=str(tmp_path / "two"), batch=2,
                     devices=TWO, **kw)
    n1, alone = _serve(gatys.serve_loop, lines, out_dir=str(tmp_path / "one"), batch=1, **kw)
    assert n2 == n1 == 2
    for a, b in zip(two[1:], alone[1:]):
        assert a.rsplit("loss=", 1)[1] == b.rsplit("loss=", 1)[1]
        np.testing.assert_array_equal(_u8(a.split(" ")[1]), _u8(b.split(" ")[1]))
