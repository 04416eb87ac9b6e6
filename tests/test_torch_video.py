"""Video in the port (ops/losses.py's temporal loss, data/video.py,
engines/video.py, clis/video_st.py, models/transformer.py's video net)
against the JAX package, on the CPU, at small sizes. Parameters cross with
``params_from_jax``; inputs come from numpy seeds."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from styletransfer_tpu import ckpt as jckpt
from styletransfer_tpu.engines import video as jvideo
from styletransfer_tpu.models import transformer as jt
from styletransfer_tpu.models import vgg as jv
from styletransfer_tpu.ops import losses as jlosses
from styletransfer_tpu_torch import ckpt as tckpt
from styletransfer_tpu_torch.data import video as tdata
from styletransfer_tpu_torch.engines import fast as tfast
from styletransfer_tpu_torch.engines import video
from styletransfer_tpu_torch.models import transformer as tt
from styletransfer_tpu_torch.models import vgg as tv
from styletransfer_tpu_torch.ops import losses

SIZE = 32
# The forward and the losses against JAX's in f32: the port's instance norms
# take the exact two-pass variance, JAX's the one-pass form (about 1e-6
# apart, compounded over 15 norms; see tests/test_torch_transformer.py).
F32_ATOL = 1e-4
# Gradients of the whole frame loss against jax.grad, relative L2 per
# parameter (the same measure and reasons as tests/test_torch_training.py).
GRAD_REL_L2 = 1e-4
# Served frames (uint8): one step where a value lands near a half step.
U8_STEPS = 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU ops here are small: one thread each, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_vgg():
    return jax.device_get(jv.init_params(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def jax_video_params():
    return jax.device_get(jt.init_video_params(jax.random.PRNGKey(2)))


def _x(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _flat(tree):
    """A JAX tree's leaves by the port's dotted parameter names."""
    return {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_temporal_loss_matches_jax():
    a, b, c, d = (_x(i, (2, 8, 8, 3)) for i in range(4))
    want = float(jlosses.temporal_loss(*(jnp.asarray(t) for t in (a, b, c, d)), 0.8))
    got = float(losses.temporal_loss(*(torch.from_numpy(t) for t in (a, b, c, d)), 0.8))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_init_video_params_warm_starts_all_but_conv1():
    fast = jax.device_get(jt.init_params(jax.random.PRNGKey(5)))
    warm = tt.params_to_tree(tt.init_video_params(3, fast_params=fast, device="cpu"))
    fresh = tt.params_to_tree(tt.init_video_params(3, device="cpu"))
    from_module = tt.params_to_tree(tt.init_video_params(
        3, fast_params=tt.params_from_jax(fast, device="cpu"), device="cpu"))
    for name, value in _flat(warm).items():
        want = _flat(fresh)[name] if name.startswith("conv1.") else _flat(fast)[name]
        np.testing.assert_array_equal(value, want, err_msg=name)
        np.testing.assert_array_equal(_flat(from_module)[name], want, err_msg=name)
    assert warm["conv1"]["kernel"].shape == (9, 9, 6, 32)
    assert list(_flat(warm)) == list(_flat(fresh))  # the module order is kept


@pytest.mark.parametrize("frozen", [False, True])
def test_freeze_mask_matches_jax(jax_video_params, frozen):
    want = {k: float(v) for k, v in _flat(jvideo.freeze_mask(jax_video_params, frozen)).items()}
    got = video.freeze_mask(tt.params_from_jax(jax_video_params, device="cpu"), frozen)
    assert got == want
    assert sum(v == 1.0 for v in got.values()) == (2 if frozen else len(got))


@pytest.mark.parametrize("n,pad_tail", [(7, False), (7, True), (8, True), (2, True)])
def test_chunk_frames_matches_jax(n, pad_tail):
    frames = [np.full((2, 1, 1, 3), i, np.float32) for i in range(n)]
    want = list(jvideo._chunk_frames(iter(frames), 4, pad_tail))
    got = list(video._chunk_frames(iter(frames), 4, pad_tail))
    assert len(got) == len(want)
    for (gf, gv), (wf, wv) in zip(got, want):
        np.testing.assert_array_equal(gf, wf)
        np.testing.assert_array_equal(gv, wv)


def test_frame_loss_fn_value_and_gradients_match_jax(jax_video_params, jax_vgg):
    style, frame, old_content = _x(20, (1, SIZE, SIZE, 3)), _x(21, (2, SIZE, SIZE, 3)), \
        _x(22, (2, SIZE, SIZE, 3))
    old_stylized = _x(23, (2, SIZE, SIZE, 3))
    jgrams = jv.style_gram_targets(jax_vgg, jnp.asarray(style))
    grad_fn = jax.jit(jax.grad(jvideo.frame_loss_fn, has_aux=True), static_argnums=(6, 7, 8))
    jgrads, (jout, want) = grad_fn(jax_video_params, jnp.asarray(frame), jnp.asarray(old_content),
                                   jnp.asarray(old_stylized), jax_vgg, jgrams, 1e5, 1.0, 0.8)
    params = tt.params_from_jax(jax_video_params, device="cpu")
    port_vgg = tv.params_from_jax(jax_vgg, device="cpu")
    grams = tv.style_gram_targets(port_vgg, torch.from_numpy(style))
    total, (out, got) = video.frame_loss_fn(
        params, torch.from_numpy(frame), torch.from_numpy(old_content),
        torch.from_numpy(old_stylized), port_vgg, grams, 1e5, 1.0, 0.8)
    total.backward()
    for k in ("total", "style", "content", "tv", "temporal"):
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=F32_ATOL)
    flat = _flat(jgrads)
    scale = max(np.linalg.norm(g) for g in flat.values())
    for name, p in params.named_parameters():
        w, g = flat[name], p.grad.numpy()
        if np.linalg.norm(w) < 1e-6 * scale:
            # Biases that an instance norm cancels: zero up to rounding.
            assert np.linalg.norm(g) < 1e-6 * scale, name
            continue
        assert np.linalg.norm(g - w) / np.linalg.norm(w) < GRAD_REL_L2, name


def _golden_inputs(jax_vgg):
    """tests/test_golden.py::test_video_scan_step_golden's inputs."""
    rng = np.random.default_rng(7)
    style = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    frames = rng.standard_normal((3, 2, 32, 32, 3)).astype(np.float32)
    port_vgg = tv.params_from_jax(jax_vgg, device="cpu")
    return port_vgg, tv.style_gram_targets(port_vgg, torch.from_numpy(style)), frames


def test_scan_step_reproduces_the_golden_totals(jax_video_params, jax_vgg):
    """tests/test_golden.py::test_video_scan_step_golden through the port:
    the third frame is padded, so its metrics are exactly 0 and it takes no
    step; the carry is the second frame and its stylized output."""
    port_vgg, grams, frames = _golden_inputs(jax_vgg)
    opt, step = video.make_scan_train_step(port_vgg, grams)
    params = tt.params_from_jax(jax_video_params, device="cpu")
    optimizer = opt(params)
    x = torch.from_numpy(frames)
    _, optimizer, old_c, old_s, metrics = step(
        params, optimizer, x, np.array([True, True, False]), x[0], x[0],
        video.freeze_mask(params, False))
    np.testing.assert_allclose(metrics["total"].numpy(), [328.488068, 831.681946, 0.0],
                               rtol=1e-3, atol=1e-6)
    for k, v in metrics.items():
        assert v.shape == (3,) and float(v[2]) == 0.0, k
    param_l1 = sum(float(p.detach().abs().sum()) for p in params.parameters())
    np.testing.assert_allclose(param_l1, 27398.423828, rtol=1e-3)
    assert torch.equal(old_c, x[1]) and not old_s.requires_grad
    assert int(tckpt.adam_state_to_tree(params, optimizer)["0"]["count"]) == 2


def test_freeze_then_unfreeze_matches_optax(jax_video_params, jax_vgg):
    """Two frozen frames, then one unfrozen, in both packages: the frozen
    parameters keep taking Adam steps with zero gradients, so at the
    unfreeze each one's step count, and with it its bias correction, is
    optax's. Their one real update is then (1 - 0.9) / (1 - 0.9**3) /
    sqrt((1 - 0.999) / (1 - 0.999**3)) = 0.639 lr against the gradient's
    sign, where a count that lagged at 1 would give lr."""
    port_vgg, grams, frames = _golden_inputs(jax_vgg)
    jgrams = jv.style_gram_targets(jax_vgg, jnp.asarray(
        np.random.default_rng(7).standard_normal((1, 32, 32, 3)).astype(np.float32)))
    jopt, jstep = jvideo.make_scan_train_step(jax_vgg, jgrams)
    jp, jst = jax_video_params, jopt.init(jax_video_params)
    old_c = old_s = jnp.asarray(frames[0])
    for t, frozen in enumerate((True, True, False)):
        jp, jst, old_c, old_s, _ = jstep(jp, jst, jnp.asarray(frames[t:t + 1]),
                                         jnp.asarray([True]), old_c, old_s,
                                         jvideo.freeze_mask(jp, frozen))
    opt, step = video.make_scan_train_step(port_vgg, grams)
    params = tt.params_from_jax(jax_video_params, device="cpu")
    optimizer = opt(params)
    x = torch.from_numpy(frames)
    c = s = x[0]
    for t, frozen in enumerate((True, True, False)):
        _, _, c, s, _ = step(params, optimizer, x[t:t + 1], [True], c, s,
                             video.freeze_mask(params, frozen))
    tree = tckpt.adam_state_to_tree(params, optimizer)
    assert int(tree["0"]["count"]) == int(jst[0].count) == 3
    assert all(float(optimizer.state[p]["step"]) == 3 for p in params.parameters())
    # Adam turns small gradients into steps of about lr of either sign, so
    # after conv1's two frozen-epoch steps (its elements of small gradient
    # moved by +-lr) the two runs' third gradients are about 1% apart.
    # Where the gradient's sign is clear the update is +-0.639 lr in both.
    init, want = _flat(jax_video_params), _flat(jax.device_get(jp))
    jmu = _flat(jax.device_get(jst[0].mu))
    for name, p in params.named_parameters():
        if name.startswith("conv1.") or (name.endswith(".bias")
                                         and name not in ("conv_out.bias", "up2_in.bias")):
            # conv1 trained on all three frames. A bias before the last
            # instance norm is a per-channel shift that the next norm
            # cancels (a 3x3 reflect-padded conv keeps a shift constant):
            # its gradient is rounding noise.
            continue
        clear = np.abs(jmu[name]) > 0.05 * np.abs(jmu[name]).max()
        np.testing.assert_allclose((p.detach().numpy() - init[name])[clear],
                                   (want[name] - init[name])[clear], rtol=1e-3, err_msg=name)
        np.testing.assert_allclose(np.abs(want[name] - init[name])[clear], 0.639e-3, rtol=1e-3)


@pytest.mark.parametrize("pad_mode", ["reflect", "zeros"])
def test_stylize_clip_matches_jax(jax_video_params, pad_mode):
    frames = np.random.default_rng(30).integers(0, 256, (3, 2, SIZE, SIZE, 3), dtype=np.uint8)
    want = jvideo.stylize_clip(jax_video_params, frames, pad_mode=pad_mode)
    got = video.stylize_clip(tt.params_from_jax(jax_video_params, device="cpu"), frames,
                             pad_mode=pad_mode)
    assert got.shape == want.shape == (3, 2, SIZE, SIZE, 3)
    np.testing.assert_allclose(got, want, atol=F32_ATOL)
    one = video.stylize_clip(tt.params_from_jax(jax_video_params, device="cpu"), frames[:, 0],
                             pad_mode=pad_mode)
    np.testing.assert_allclose(one, got[:, 0], atol=1e-5)


# ---------------------------------------------------------------------------
# Video files: process_video, process_video_dir and the readers.
# ---------------------------------------------------------------------------


def _write_gif(path, n, seed, size=16):
    from styletransfer_tpu_torch.data.coco import synthetic_image

    base = (synthetic_image(seed, size) * 255).astype(np.uint8)
    frames = [Image.fromarray(np.roll(base, i, axis=1)) for i in range(n)]
    frames[0].save(path, save_all=True, append_images=frames[1:], duration=40, loop=0)
    return path


@pytest.fixture
def recorded(monkeypatch):
    """The frames each output video was given, by path (the files are
    written as well)."""
    seen = {}
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
        return Recorder(writer, seen.setdefault(path, [])), path

    monkeypatch.setattr(video, "_open_video_writer", opener)
    return seen


@pytest.fixture(scope="module")
def cpu_video_params(jax_video_params):
    return tt.params_from_jax(jax_video_params, device="cpu")


def _gif_frames(path):
    with Image.open(path) as im:
        return im.n_frames


def test_process_video_writes_every_frame(tmp_path, cpu_video_params, recorded):
    clip = _write_gif(str(tmp_path / "clip.gif"), 3, 5)
    out = video.process_video(clip, style_name="sty", out_dir=str(tmp_path / "res"),
                              params=cpu_video_params, chunk_size=2, save_frames=True,
                              working_dir=str(tmp_path / "work"), device="cpu")
    assert out == str(tmp_path / "res" / "video_st_sty.gif") and _gif_frames(out) == 3
    frames = recorded[out]
    assert len(frames) == 3 and frames[0].shape == (256, 256, 3)
    assert sorted(os.listdir(tmp_path / "work")) == ["0.png", "1.png", "2.png"]
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "work" / "2.png")), frames[2])
    # The same clip through stylize_clip, on the decoded uint8 frames.
    reader = tdata.ImageioFrameReader(clip, normalized=False)
    decoded = np.stack([reader.next_frame()[0] for _ in range(3)])
    assert reader.next_frame() is None
    reader.close()
    want = np.stack([tdata.img_utils.to_uint8(f)
                     for f in video.stylize_clip(cpu_video_params, decoded)])
    assert np.abs(np.stack(frames).astype(np.int32) - want).max() <= U8_STEPS


def test_process_video_dir_ragged_groups_and_unreadable_clips(tmp_path, cpu_video_params,
                                                              recorded):
    """Clips of 3, 4 and 2 frames at batch 2, with a clip that opens but
    yields no frame (ae: frame 0 truncated) and a file that does not open
    (broken): groups (a, ae), (b, broken: skipped), (c). The empty clip
    rides a zero lane and writes nothing; each clip's frames are bit for bit
    those of processing it alone (the lanes are batch-invariant)."""
    in_dir = tmp_path / "clips"
    in_dir.mkdir()
    for name, n, seed in (("a", 3, 1), ("b", 4, 2), ("c", 2, 3)):
        _write_gif(str(in_dir / f"{name}.gif"), n, seed)
    data = open(_write_gif(str(tmp_path / "whole.gif"), 2, 4), "rb").read()
    (in_dir / "ae.gif").write_bytes(data[:int(len(data) * 0.45)])
    (in_dir / "broken.gif").write_bytes(b"not a gif at all")
    (in_dir / "notes.txt").write_text("not a video")
    outs = video.process_video_dir(str(in_dir), style_name="sty", out_dir=str(tmp_path / "res"),
                                   params=cpu_video_params, batch_size=2, chunk_size=2,
                                   device="cpu")
    assert [os.path.basename(p) for p in outs] == [
        "video_st_sty_a.gif", "video_st_sty_b.gif", "video_st_sty_c.gif"]
    assert [_gif_frames(p) for p in outs] == [3, 4, 2]
    assert [len(recorded[p]) for p in outs] == [3, 4, 2]
    assert sorted(os.listdir(tmp_path / "res")) == [
        "video_st_sty_a.gif", "video_st_sty_b.gif", "video_st_sty_c.gif"]
    for name, out in zip("abc", outs):
        single = video.process_video(str(in_dir / f"{name}.gif"), style_name="sty",
                                     out_dir=str(tmp_path / f"single_{name}"),
                                     params=cpu_video_params, chunk_size=3, device="cpu")
        np.testing.assert_array_equal(np.stack(recorded[out]), np.stack(recorded[single]))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="No videos"):
        video.process_video_dir(str(tmp_path / "empty"), "sty", params=cpu_video_params,
                                device="cpu")


def test_a_corrupt_frame_ends_its_clip(tmp_path, caplog):
    path = _write_gif(str(tmp_path / "clip.gif"), 6, 4, size=32)
    data = open(path, "rb").read()
    cut = str(tmp_path / "cut.gif")
    with open(cut, "wb") as f:  # frames 0-4 whole, frame 5 truncated
        f.write(data[:int(len(data) * 0.95)])
    reader = tdata.ImageioFrameReader(cut, size=8, normalized=False)
    frames = []
    while (f := reader.next_frame()) is not None:
        frames.append(f)
    reader.close()
    assert len(frames) == 5 and frames[0].shape == (1, 8, 8, 3)
    assert "treating clip as ended" in caplog.text
    whole = tdata.ImageioFrameReader(path, size=8)
    first = whole.next_frame()
    whole.close()
    # A normalized frame is its uint8 frame (the same crop and resize),
    # normalized.
    assert first.dtype == np.float32
    np.testing.assert_allclose(
        first, tdata.img_utils.normalize(frames[0].astype(np.float32) / 255.0), atol=1e-6)


def test_readers_decode_as_the_jax_package(tmp_path):
    from styletransfer_tpu.data import video as jdata

    path = _write_gif(str(tmp_path / "clip.gif"), 4, 6, size=40)
    for normalized in (False, True):
        want, got = jdata.ImageioFrameReader(path, 24, normalized), \
            tdata.ImageioFrameReader(path, 24, normalized)
        for _ in range(5):
            w, g = want.next_frame(), got.next_frame()
            if w is None:
                assert g is None
                break
            np.testing.assert_array_equal(g, w)
    synth = np.concatenate(list(tdata.iterate_on_video_batches(
        [tdata.SyntheticFrameReader(s, 3, 16) for s in (0, 1)])))
    jsynth = np.concatenate(list(jdata.iterate_on_video_batches(
        [jdata.SyntheticFrameReader(s, 3, 16) for s in (0, 1)])))
    np.testing.assert_array_equal(synth, jsynth)
    assert tdata.make_batches(list(range(7)), 3) == jdata.make_batches(list(range(7)), 3)


def test_video_dataset_batches_like_jax(tmp_path, monkeypatch):
    import socket

    from styletransfer_tpu.data import video as jdata
    from styletransfer_tpu_torch import constants
    from styletransfer_tpu_torch.data import download

    # Built from a directory, the dataset first tries the sample videos'
    # download: point it at a closed local port.
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        closed = s.getsockname()[1]
    monkeypatch.setattr(download, "SAMPLE_VIDEO_URLS", [f"http://127.0.0.1:{closed}/a.mp4"])
    monkeypatch.setattr(constants, "PROJECT_ROOT_PATH", str(tmp_path))

    clips = [str(tmp_path / f"{i}.gif") for i in range(5)]
    got = tdata.VideoDataset(videos=clips, batch_size=2)
    want = jdata.VideoDataset(videos=clips, batch_size=2)
    assert got.video_batches == want.video_batches and len(got) == 2
    synth = tdata.VideoDataset(video_dir=str(tmp_path / "none"), batch_size=9, size=8)
    assert synth.synthetic and synth.batch_size == 4 and len(synth) == 1
    (readers,) = list(synth)
    assert all(isinstance(r, tdata.SyntheticFrameReader) for r in readers)
    empty = tdata.VideoDataset(video_dir=str(tmp_path / "none"), synthetic_fallback=False)
    assert len(empty) == 0 and list(empty) == []


def test_open_video_writer_mp4_first_then_gif(tmp_path, monkeypatch):
    import imageio

    from styletransfer_tpu_torch.utils.logging import get_logger

    made = []
    monkeypatch.setattr(imageio, "get_writer",
                        lambda path, **kw: made.append((path, kw)) or "mp4-writer")
    w, path = video._open_video_writer(str(tmp_path / "v"), 24.0, get_logger())
    assert (w, path) == ("mp4-writer", str(tmp_path / "v.mp4"))
    assert made == [(path, {"fps": 24.0})]

    def no_backend(path, **kw):
        raise ValueError("no ffmpeg")

    monkeypatch.setattr(imageio, "get_writer", no_backend)
    w, path = video._open_video_writer(str(tmp_path / "v"), 24.0, get_logger())
    assert path == str(tmp_path / "v.gif") and isinstance(w, video.GifWriter)
    assert (w.duration, w.loop) == (1000.0 / 24.0, 0)


# ---------------------------------------------------------------------------
# video_train.
# ---------------------------------------------------------------------------


class _Clips:
    """Two video batches of two synthetic 5-frame clips at 32 px, fresh
    readers on every pass."""

    def __iter__(self):
        for batch in ((0, 1), (2, 3)):
            yield [tdata.SyntheticFrameReader(s, 5, SIZE) for s in batch]


def _train(tmp_path, jax_vgg, params=None, **kw):
    args = dict(style_name="tiny", epochs=1, batch_size=2, vgg_params=tv.params_from_jax(
        jax_vgg, device="cpu"), params=params, video_loader=_Clips(), chunk_size=2,
        runs_dir=str(tmp_path / "runs"), models_path=str(tmp_path / "models"), device="cpu")
    args.update(kw)
    return video.video_train(_x(40, (1, SIZE, SIZE, 3)), **args)


class _Stop(Exception):
    pass


def test_video_train_resumes_exactly_after_a_mid_epoch_stop(tmp_path, monkeypatch,
                                                             jax_video_params, jax_vgg):
    """A run stopped right after its step state at frame 7 (video batch 1,
    after its first chunk) and resumed ends with the parameters of a run
    that never stopped; the resumed run trains only the 3 frames left."""
    whole = _train(tmp_path / "whole", jax_vgg,
                   tt.params_from_jax(jax_video_params, device="cpu"), step_checkpoint_every=2)
    save = tckpt.save_step_state

    def save_then_stop(*args, **kw):
        path = save(*args, **kw)
        if args[3] == 7:
            raise _Stop
        return path

    monkeypatch.setattr(tckpt, "save_step_state", save_then_stop)
    with pytest.raises(_Stop):
        _train(tmp_path / "cut", jax_vgg, tt.params_from_jax(jax_video_params, device="cpu"),
               step_checkpoint_every=2)
    monkeypatch.setattr(tckpt, "save_step_state", save)
    state = tckpt.load_step_state("video_st", "tiny", str(tmp_path / "cut" / "models"),
                                  extra_keys=("batch_in_epoch", "chunk_in_batch"),
                                  array_keys=("old_content", "old_stylized"))
    assert (state["epoch"], state["iteration"]) == (0, 7)
    assert (state["extra"]["batch_in_epoch"], state["extra"]["chunk_in_batch"]) == (1, 1)
    assert state["arrays"]["old_stylized"].shape == (2, SIZE, SIZE, 3)
    steps = []
    real_step = video.make_scan_train_step

    def counting(*a, **kw):
        opt, step = real_step(*a, **kw)
        return opt, lambda *s: steps.append(len(s[2])) or step(*s)

    monkeypatch.setattr(video, "make_scan_train_step", counting)
    resumed = _train(tmp_path / "cut", jax_vgg, step_checkpoint_every=2)
    assert steps == [2, 1]
    for (name, a), b in zip(whole.named_parameters(), resumed.parameters()):
        assert torch.equal(a, b), name
    # The JAX trainer reads the epoch checkpoint and the final step state.
    models = str(tmp_path / "cut" / "models")
    template = jt.init_video_params(jax.random.PRNGKey(0))
    loaded = jckpt.load(jckpt.existing_checkpoint_path("video_st", "tiny", 0, models), template)
    for name, value in _flat(jax.device_get(loaded)).items():
        np.testing.assert_array_equal(value, dict(resumed.named_parameters())[name]
                                      .detach().numpy(), err_msg=name)
    jstate = jckpt.load_step_state(template, optax.adam(1e-3).init(template), "video_st", "tiny",
                                   models, extra_keys=("batch_in_epoch", "chunk_in_batch"))
    assert (int(jstate["epoch"]), int(jstate["iteration"])) == (1, 10)
    assert int(jstate["opt_state"][0].count) == 10


def test_frozen_epoch_adam_state_round_trips_with_optax(tmp_path, jax_vgg):
    """Warm-started from a fast_st checkpoint: epoch 0 trains conv1 only,
    and the step state after it holds optax's Adam state (one count for
    all, zero moments for the frozen parameters), which the JAX package
    reads and the port reads back unchanged."""
    models = str(tmp_path / "models")
    fast = jax.device_get(jt.init_params(jax.random.PRNGKey(8)))
    jckpt.save_epoch(fast, "fast_st", "tiny", 2, models)
    params = _train(tmp_path, jax_vgg, use_pretrained_fast_st=True, step_checkpoint_every=4,
                    max_frames=3)
    for name, value in _flat(fast).items():
        if not name.startswith("conv1."):
            np.testing.assert_array_equal(dict(params.named_parameters())[name].detach().numpy(),
                                          value, err_msg=name)
    template = jt.init_video_params(jax.random.PRNGKey(0))
    jstate = jckpt.load_step_state(template, optax.adam(1e-3).init(template), "video_st", "tiny",
                                   models, extra_keys=("has_external_weights",))
    assert int(jstate["extra"]["has_external_weights"]) == 1
    adam = jstate["opt_state"][0]
    assert int(adam.count) == 6 and int(jstate["iteration"]) == 6
    for name, mu in _flat(jax.device_get(adam.mu)).items():
        if not name.startswith("conv1."):
            assert not np.any(mu), name
    assert np.any(jax.device_get(adam.mu["conv1"]["kernel"]))
    state = tckpt.load_step_state("video_st", "tiny", models)
    restored = tt.params_from_jax(state["params"], device="cpu")
    optimizer = tfast.make_optimizer(restored)
    tckpt.adam_state_from_tree(restored, optimizer, state["opt_state"])
    back = tckpt.adam_state_to_tree(restored, optimizer)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(state["opt_state"])
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(state["opt_state"])):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The video_st CLI.
# ---------------------------------------------------------------------------


def test_train_cli_passes_its_options(monkeypatch, tmp_path):
    from styletransfer_tpu_torch import constants
    from styletransfer_tpu_torch.clis import cli

    (tmp_path / "styles").mkdir()
    Image.fromarray(np.zeros((40, 30, 3), np.uint8)).save(tmp_path / "styles" / "wave.png")
    monkeypatch.setattr(constants, "PROJECT_ROOT_PATH", str(tmp_path))
    seen = {}
    monkeypatch.setattr(video, "video_train", lambda img, **kw: seen.update(kw, img=img))
    result = CliRunner().invoke(cli, ["video_st", "train", "styles/wave.png", "-e", "2", "-b",
                                      "3", "-tw", "0.5", "--use-pretrained-fast-st",
                                      "--precision", "bf16", "--step-checkpoint-every", "5",
                                      "--device", "cpu"])
    assert result.exit_code == 0, result.output
    assert seen.pop("img").shape == (1, 256, 256, 3)
    assert seen == {"style_name": "wave.png", "epochs": 2, "batch_size": 3,
                    "style_weight": 100_000, "content_weight": 1, "temporal_weight": 0.5,
                    "use_pretrained_fast_st": True, "precision": "bf16",
                    "step_checkpoint_every": 5, "device": "cpu"}


@pytest.mark.parametrize("command", ["convert-video", "convert-dir"])
def test_convert_clis_run_on_the_cpu(monkeypatch, tmp_path, jax_video_params, command):
    from styletransfer_tpu_torch import constants
    from styletransfer_tpu_torch.clis import cli

    monkeypatch.setattr(constants, "PROJECT_ROOT_PATH", str(tmp_path))
    (tmp_path / "clips").mkdir()
    _write_gif(str(tmp_path / "clips" / "a.gif"), 2, 9)
    tckpt.save_epoch(jax_video_params, "video_st", "sty", 0,
                     str(tmp_path / constants.MODELS_PATH))
    src = "clips/a.gif" if command == "convert-video" else "clips"
    result = CliRunner().invoke(cli, ["video_st", command, src, "sty", "--pad-mode", "zeros",
                                      "--fps", "12", "--device", "cpu"])
    assert result.exit_code == 0, result.output
    name = "video_st_sty.gif" if command == "convert-video" else "video_st_sty_a.gif"
    out = tmp_path / "results" / name
    assert _gif_frames(out) == 2
    with Image.open(out) as im:
        assert im.info["duration"] == pytest.approx(1000 / 12, abs=10)  # centiseconds
