"""The port's streaming video daemon (``engines/video.py::serve_stream_loop``,
``video_st serve``) on the CPU at 32 and 48 px.

A stream's PNGs are EXACTLY the port's ``_stylize_chunk`` of its frames
(uint8 equality), alone, after RESET, interleaved with 2 or 4 other streams
at ``-b 4`` and at ``-b 1``: the forward runs with ``fixed_order=True``, so a
lane's bits do not depend on the wave. Then the slot-table cases of JAX
``tests/test_engines.py:1405-1800`` (size buckets per stream, eviction that
spares the wave's streams, lazy growth, the bare-RESET barrier), a failed
request that leaves its carry alone, and one scripted session through JAX
``serve_stream_loop`` and the port's from one set of parameters
(``params_from_jax``): the same response lines, and PNGs within
``U8_STEPS``, the limit ``tests/test_torch_video.py`` holds convert-video to
(the forwards are about 1e-6 apart in f32). Every loop runs in a worker
thread joined with a timeout."""

import io
import os
import threading

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from styletransfer_tpu import ckpt as jckpt
from styletransfer_tpu import constants as jconstants
from styletransfer_tpu.engines import video as jvideo
from styletransfer_tpu.models import transformer as jt
from styletransfer_tpu_torch import constants
from styletransfer_tpu_torch.engines import video
from styletransfer_tpu_torch.models import transformer
from styletransfer_tpu_torch.utils import images

SIZE = 32
# tests/test_torch_video.py's limit for served frames against a reference.
U8_STEPS = 1
LOOP_TIMEOUT_S = 300


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    return transformer.init_video_params(seed=3, device="cpu")


@pytest.fixture
def frames(tmp_path):
    """``frames(names)``: a seeded 40x40 PNG per name, path by name."""
    rng = np.random.default_rng(11)

    def make(names):
        out = {}
        for n in names:
            p = tmp_path / f"{n}.png"
            Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)).save(p)
            out[n] = str(p)
        return out
    return make


def _serve(loop, lines, **kw):
    """Run a serve loop on scripted lines in a worker thread: (n, lines)."""
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


def _port(params, tmp_path, lines, **kw):
    kw.setdefault("size", SIZE)
    return _serve(video.serve_stream_loop, lines, style_name="tst",
                  out_dir=str(tmp_path / "results"), params=params, device="cpu", **kw)


def _reference(params, paths, size=SIZE, **kw):
    """The port's ``_stylize_chunk`` of one stream's frames, as uint8."""
    u8 = torch.from_numpy(np.stack([images.load_image_uint8(p, size=size)[0]
                                    for p in paths]))[:, None]
    outs = video._stylize_chunk(params, u8, images.maybe_normalize_on_device(u8[0]), **kw)
    return images.to_uint8_on_device(outs).numpy()[:, 0]


def _png(path):
    return np.asarray(Image.open(path))


@pytest.mark.parametrize("pad_mode", ["reflect", "zeros"])
def test_a_stream_is_exactly_stylize_chunk_and_reset_starts_fresh(params, frames, tmp_path,
                                                                  pad_mode):
    f = frames(["f0", "f1", "f2"])
    n, lines = _port(params, tmp_path, [f["f0"], f["f1"], "RESET", f["f2"]], pad_mode=pad_mode)
    assert n == 3 and lines[0] == "READY" and lines[3] == "OK RESET"
    assert [ln.split()[0] for ln in lines[1:]] == ["OK"] * 4
    want = _reference(params, [f["f0"], f["f1"]], pad_mode=pad_mode)
    assert lines[1] == f"OK {tmp_path}/results/video_st_tst_f0.png"
    for t in (0, 1):
        np.testing.assert_array_equal(_png(lines[1 + t][3:]), want[t])
    # After RESET, f2 pairs with itself: a fresh stream, not the old carry.
    np.testing.assert_array_equal(_png(lines[4][3:]),
                                  _reference(params, [f["f2"]], pad_mode=pad_mode)[0])


@pytest.mark.parametrize("n_streams,batch_size", [(2, 4), (4, 4), (4, 1)])
def test_interleaved_streams_are_each_stream_alone(params, frames, tmp_path, n_streams,
                                                   batch_size):
    """Ragged streams, round-robin interleaved: one answer per request in
    order, and every stream's PNGs exactly its own ``_stylize_chunk``,
    however the requests group into waves."""
    lengths = dict(zip("ABCD"[:n_streams], (5, 3, 4, 2)))
    f = frames([f"{s}{t}" for s, n in lengths.items() for t in range(n)])
    order = [(s, t) for t in range(5) for s, n in lengths.items() if t < n]
    outs = {k: str(tmp_path / f"out_{k[0]}{k[1]}.png") for k in order}
    n, lines = _port(params, tmp_path, [f"{f[s + str(t)]}\t{outs[(s, t)]}\t{s}"
                                        for s, t in order], batch_size=batch_size)
    assert n == len(order) and lines == ["READY"] + [f"OK {outs[k]}" for k in order]
    for s, count in lengths.items():
        want = _reference(params, [f[f"{s}{t}"] for t in range(count)])
        for t in range(count):
            np.testing.assert_array_equal(_png(outs[(s, t)]), want[t], err_msg=f"{s}{t}")


def test_default_names_tag_streams_other_than_0(params, frames, tmp_path):
    f = frames(["a"])
    _, lines = _port(params, tmp_path, [f["a"], f"{f['a']}\t\tcam/1 x", f"{f['a']}\t\t0"],
                     batch_size=2)
    res = f"{tmp_path}/results"
    assert lines[1:] == [f"OK {res}/video_st_tst_a.png", f"OK {res}/video_st_tst_scam_1_x_a.png",
                         f"OK {res}/video_st_tst_a.png"]


@pytest.mark.parametrize("batch_size", [1, 2])
def test_size_buckets_per_stream(params, frames, tmp_path, batch_size):
    """A stream's bucket is fixed by its first frame and remembered; naming
    another size for a live stream is an ERR until RESET (JAX's texts)."""
    img = frames(["f"])["f"]
    o = tmp_path
    _, lines = _port(params, tmp_path, [
        f"{img}\t{o}/a1.png\tA", f"{img}\t{o}/b1.png\tB\t48", f"{img}\t{o}/a2.png\tA\t48",
        f"{img}\t{o}/a3.png\tA", "RESET\t\tA", f"{img}\t{o}/a4.png\tA\t48",
        f"{img}\t{o}/x.png\tC\t40", f"{img}\t{o}/y.png\tC\tbig", "RESET\tx",
        f"{img}\ta\tb\tc\td"], sizes=[32, 48], batch_size=batch_size)
    assert lines[:3] == ["READY", f"OK {o}/a1.png", f"OK {o}/b1.png"]
    assert lines[3] == f"ERR {img}: stream 'A' is 32px; RESET it before changing size to 48"
    assert lines[4:7] == [f"OK {o}/a3.png", "OK RESET A", f"OK {o}/a4.png"]
    assert lines[7] == f"ERR {img}: size 40 not in serving buckets [32, 48]"
    assert lines[8] == f"ERR {img}: SIZE must be an integer, got 'big'"
    assert lines[9].startswith("ERR RESET: RESET takes no OUTPUT/SIZE field")
    assert lines[10] == f"ERR {img}: expected FRAME[\\tOUTPUT[\\tSTREAM[\\tSIZE]]], got 5 fields"
    for name, side in (("a1", 32), ("b1", 48), ("a3", 32), ("a4", 48)):
        assert _png(o / f"{name}.png").shape == (side, side, 3)


def test_eviction_protects_same_wave_streams(params, frames, tmp_path):
    """At capacity (4), a wave of warm A, B and fresh E, F evicts C and D,
    never A or B: their later frames stay exactly their references."""
    counts = {"A": 3, "B": 3, "C": 1, "D": 1, "E": 1, "F": 1}
    f = frames([f"{s}{t}" for s, n in counts.items() for t in range(n)])
    order = [("A", 0), ("B", 0), ("C", 0), ("D", 0), ("A", 1), ("B", 1), ("E", 0), ("F", 0),
             ("A", 2), ("B", 2)]
    outs = {k: str(tmp_path / f"out_{k[0]}{k[1]}.png") for k in order}
    n, lines = _port(params, tmp_path, [f"{f[s + str(t)]}\t{outs[(s, t)]}\t{s}"
                                        for s, t in order], batch_size=4, max_streams=4)
    assert n == len(order) and lines[1:] == [f"OK {outs[k]}" for k in order]
    for s in "ABEF":
        want = _reference(params, [f[f"{s}{t}"] for t in range(counts[s])])
        for t in range(counts[s]):
            np.testing.assert_array_equal(_png(outs[(s, t)]), want[t])


def test_lone_lane_eviction_protects_the_wave(params, frames, tmp_path):
    """A fresh stream alone in its bucket of a wave must not evict a warm
    stream with a lane in the other bucket of the same wave: at capacity 2,
    C0 (48 px, fresh) beside W1 (32 px, warm) evicts X, not W."""
    f = frames(["W0", "W1", "X0", "C0"])
    order = [("W", 0, ""), ("X", 0, ""), ("C", 0, "48"), ("W", 1, "")]
    outs = {(s, t): str(tmp_path / f"out_{s}{t}.png") for s, t, _ in order}
    n, lines = _port(params, tmp_path, [f"{f[s + str(t)]}\t{outs[(s, t)]}\t{s}\t{sz}"
                                        for s, t, sz in order],
                     batch_size=2, max_streams=2, sizes=[32, 48])
    assert n == 4 and lines[1:] == [f"OK {outs[(s, t)]}" for s, t, _ in order]
    want = _reference(params, [f["W0"], f["W1"]])
    np.testing.assert_array_equal(_png(outs[("W", 1)]), want[1])
    np.testing.assert_array_equal(_png(outs[("C", 0)]), _reference(params, [f["C0"]], 48)[0])


def test_slot_table_grows_lazily(params, frames, tmp_path, caplog):
    """Ten streams through a daemon of 8 initial rows (batch 2, max 12): one
    growth to 12 rows and no eviction; streams placed before (S0) and after
    (S9) the growth keep their carries."""
    streams = [f"S{i}" for i in range(10)]
    f = frames([f"{s}_{t}" for s in streams for t in range(2 if s in ("S0", "S9") else 1)])
    order = [(s, 0) for s in streams] + [("S0", 1), ("S9", 1)]
    outs = {k: str(tmp_path / f"out_{k[0]}_{k[1]}.png") for k in order}
    with caplog.at_level("INFO", logger="StyleTransfer"):
        n, lines = _port(params, tmp_path, [f"{f[f'{s}_{t}']}\t{outs[(s, t)]}\t{s}"
                                            for s, t in order], batch_size=2, max_streams=12)
    assert n == len(order) and lines[1:] == [f"OK {outs[k]}" for k in order]
    assert "growing the 32px slot table 8 -> 12 rows" in caplog.text
    assert "evicted" not in caplog.text
    for s in ("S0", "S9"):
        want = _reference(params, [f[f"{s}_0"], f[f"{s}_1"]])
        for t in range(2):
            np.testing.assert_array_equal(_png(outs[(s, t)]), want[t])


def test_bare_reset_is_a_barrier(params, frames, tmp_path):
    """A bare RESET in a batched group also resets the stream whose frame came
    before it in the same group: a1 starts a fresh stream."""
    f = frames(["a0", "a1"])
    o1, o2 = str(tmp_path / "o1.png"), str(tmp_path / "o2.png")
    n, lines = _port(params, tmp_path, [f"{f['a0']}\t{o1}\tA", "RESET", f"{f['a1']}\t{o2}\tA"],
                     batch_size=2)
    assert n == 3 and lines[1:] == [f"OK {o1}", "OK RESET", f"OK {o2}"]
    np.testing.assert_array_equal(_png(o2), _reference(params, [f["a1"]])[0])


@pytest.mark.parametrize("batch_size", [1, 3])
def test_a_failed_request_does_not_advance_its_carry(params, frames, tmp_path, batch_size):
    """An unreadable frame, and a frame whose PNG cannot be written, answer
    ERR; the stream's next frame follows the last frame that succeeded."""
    f = frames(["f0", "f1", "bad"])
    (tmp_path / "blocker").write_text("a file where a directory is needed")
    ok0, ok1 = str(tmp_path / "ok0.png"), str(tmp_path / "ok1.png")
    lines = [f"{f['f0']}\t{ok0}", f"{tmp_path}/missing.png", f"{f['bad']}\tblocker/x.png",
             f"{f['f1']}\t{ok1}"]
    saved_root = constants.PROJECT_ROOT_PATH
    constants.PROJECT_ROOT_PATH = str(tmp_path)  # OUTPUT resolves under the project root
    try:
        n, out = _port(params, tmp_path, lines, batch_size=batch_size)
    finally:
        constants.PROJECT_ROOT_PATH = saved_root
    assert n == 2 and out[1] == f"OK {ok0}" and out[4] == f"OK {ok1}"
    assert out[2].startswith(f"ERR {tmp_path}/missing.png: ")
    assert out[3].startswith(f"ERR {f['bad']}: ")
    want = _reference(params, [f["f0"], f["f1"]])
    np.testing.assert_array_equal(_png(ok1), want[1])


def test_refuses_bad_batch_and_stream_counts(params, tmp_path):
    with pytest.raises(ValueError, match="batch_size must be >= 1"):
        video.serve_stream_loop("tst", params=params, batch_size=0, device="cpu")
    with pytest.raises(ValueError, match="max_streams must be >= batch_size"):
        video.serve_stream_loop("tst", params=params, batch_size=4, max_streams=3,
                                device="cpu")


def test_session_matches_jax_serve_stream_loop(tmp_path, frames, monkeypatch):
    """One scripted session (two streams, a per-stream and a bare RESET,
    RELOAD to a newer epoch, an unreadable frame, a bad SIZE) through JAX
    ``serve_stream_loop`` and the port's at batch 2, from the same
    parameters: the same lines, and PNGs within U8_STEPS."""
    tree = jax.device_get(jt.init_video_params(jax.random.PRNGKey(4)))
    tree1 = jax.device_get(jt.init_video_params(jax.random.PRNGKey(5)))
    models = str(tmp_path / "data" / "models")
    jckpt.save_epoch(tree, "video_st", "sty", 0, models)
    jckpt.save_epoch(tree1, "video_st", "sty", 1, models)
    monkeypatch.setattr(jconstants, "PROJECT_ROOT_PATH", str(tmp_path))
    monkeypatch.setattr(constants, "PROJECT_ROOT_PATH", str(tmp_path))
    f = frames(["a0", "a1", "a2", "b0", "b1"])
    names = {k: os.path.basename(v) for k, v in f.items()}

    def script(tag):
        return [f"{names['a0']}\t{tag}/a0.png\tA", f"{names['b0']}\t\tB",
                f"{names['a1']}\t{tag}/a1.png\tA", "RESET\t\tB", f"{names['b1']}\t{tag}/b1.png\tB",
                "RELOAD", f"{names['a2']}\t{tag}/a2.png\tA", "missing.png\t\tA",
                f"{names['a0']}\t\tC\t64", "RESET", f"{names['a0']}\t{tag}/fresh.png\tA"]

    runs = {}
    for tag, loop, kw in (("jax", jvideo.serve_stream_loop, {"params": tree}),
                          ("port", video.serve_stream_loop,
                           {"params": transformer.params_from_jax(tree, device="cpu"),
                            "device": "cpu"})):
        runs[tag] = _serve(loop, script(tag), style_name="sty", out_dir=f"{tag}_res/",
                           models_path=models, size=SIZE, batch_size=2, **kw)
    (jn, jlines), (tn, tlines) = runs["jax"], runs["port"]
    assert tn == jn == 9
    norm = [ln.replace(f"{tmp_path}/", "").replace("port", "X") for ln in tlines]
    assert norm == [ln.replace(f"{tmp_path}/", "").replace("jax", "X") for ln in jlines]
    assert "OK RELOAD epoch=1" in tlines and "OK RESET B" in tlines
    assert tlines[2] == f"OK {tmp_path}/port_res/video_st_sty_sB_b0.png"
    pngs = [(t[3:], j[3:]) for t, j in zip(tlines, jlines) if t.startswith("OK ")
            and t.endswith(".png")]
    assert len(pngs) == 6
    for t, j in pngs:
        gap = np.abs(_png(t).astype(np.int32) - _png(j).astype(np.int32)).max()
        assert gap <= U8_STEPS, (t, gap)
    # The carry survived RELOAD: a2 follows a0, a1 under epoch 1's weights.
    cpu0 = transformer.params_from_jax(tree, device="cpu")
    cpu1 = transformer.params_from_jax(tree1, device="cpu")
    carry = video._stylize_chunk(cpu0, torch.from_numpy(np.stack(
        [images.load_image_uint8(f[k], SIZE)[0] for k in ("a0", "a1")]))[:, None],
        images.maybe_normalize_on_device(torch.from_numpy(
            np.array(images.load_image_uint8(f["a0"], SIZE)))))[-1]
    a2 = torch.from_numpy(np.array(images.load_image_uint8(f["a2"], SIZE)))[None]
    want = images.to_uint8_on_device(video._stylize_chunk(cpu1, a2, carry)).numpy()[0, 0]
    np.testing.assert_array_equal(_png(tmp_path / "port" / "a2.png"), want)
