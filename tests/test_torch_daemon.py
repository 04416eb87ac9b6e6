"""The port's stdin serving daemons (engines/daemon.py, ``fast.serve_loop``,
``multistyle.serve_loop``, ``fast_st serve`` and ``serve-multi``) against
the JAX package's, on the CPU at 32 and 48 px: the same scripted requests
through both packages' loops, serial and batched, answer the same lines
(output paths aside) and write PNGs within one step of 255. Every loop runs
in a worker thread joined with a timeout."""

import io
import os
import re
import threading
import time

import jax
import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from styletransfer_tpu import ckpt as jckpt
from styletransfer_tpu import constants as jconstants
from styletransfer_tpu.clis import common as jcommon
from styletransfer_tpu.engines import daemon as jdaemon
from styletransfer_tpu.engines import fast as jfast
from styletransfer_tpu.engines import multistyle as jmulti
from styletransfer_tpu.models import multistyle as jms
from styletransfer_tpu.models import transformer as jt
from styletransfer_tpu_torch import constants as tconstants
from styletransfer_tpu_torch.clis import cli as tcli
from styletransfer_tpu_torch.clis import common
from styletransfer_tpu_torch.engines import daemon
from styletransfer_tpu_torch.engines import fast
from styletransfer_tpu_torch.engines import multistyle as multi

S = 3
SIZES = [32, 48]
# A loop's whole run, warm-up included, must end within this many seconds.
LOOP_TIMEOUT_S = 300
# PNGs of the two packages from one checkpoint: one step of 255 (the
# forwards are about 1e-6 apart in f32).
U8_STEPS = 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU ops here are small: one thread each, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- The shared helpers --------------------------------------------------------

@pytest.mark.parametrize("line", ["img.png", "img.png\t\t", "img.png\tout.png\t32",
                                  "RESET\t\t", " a \t b ", "img\t\tA\t", "\t", ""])
def test_split_fields_matches_jax(line):
    assert daemon.split_fields(line) == jdaemon.split_fields(line)


@pytest.mark.parametrize("sizes,fallback", [(None, 256), ([], 64), ([512, 256, 512], 1),
                                            (["48", 32], 8)])
def test_normalize_buckets_matches_jax(sizes, fallback):
    assert daemon.normalize_buckets(sizes, fallback) == jdaemon.normalize_buckets(
        sizes, fallback)


@pytest.mark.parametrize("sizes", [[0], [256, -1]])
def test_normalize_buckets_refuses_what_jax_refuses(sizes):
    with pytest.raises(ValueError) as got:
        daemon.normalize_buckets(sizes, 256)
    with pytest.raises(ValueError) as want:
        jdaemon.normalize_buckets(sizes, 256)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("explicit", ["", "sub/dir/out.png", "flat.png"])
def test_resolve_out_path_matches_jax(tmp_path, monkeypatch, explicit):
    monkeypatch.setattr(jconstants, "PROJECT_ROOT_PATH", str(tmp_path / "j"))
    monkeypatch.setattr(tconstants, "PROJECT_ROOT_PATH", str(tmp_path / "t"))
    got = daemon.resolve_out_path(explicit, "OUT", "name.png")
    want = jdaemon.resolve_out_path(explicit, "OUT", "name.png")
    assert got.replace(str(tmp_path / "t"), "") == want.replace(str(tmp_path / "j"), "")
    if explicit:
        assert os.path.isdir(os.path.dirname(got))


@pytest.mark.parametrize("text", [None, "", "256", "256,512", "512, 256,", "a,1", ",",
                                  "1.5"])
def test_parse_sizes_option_matches_jax(text):
    def run(fn):
        try:
            return fn(text)
        except Exception as exc:  # noqa: BLE001 - compared below
            return type(exc).__name__, str(exc)
    assert run(common.parse_sizes_option) == run(jcommon.parse_sizes_option)


@pytest.mark.parametrize("spec", ["1", "0.2,0.3,0.5", "5", "nan,1,0", "1,2", "x", None])
def test_style_parser_of_serve_multi_matches_jax(spec):
    def run(make):
        try:
            w, tag = make(S)(spec)
            return w.tolist(), tag
        except ValueError as exc:
            return str(exc)
    got, want = run(multi._make_style_parser), run(jmulti._make_style_parser)
    assert got == pytest.approx(want) if isinstance(want, tuple) else got == want


def _join_probes():
    for t in threading.enumerate():
        if t.name == "stats-rtt-probe":
            t.join(10.0)


def test_device_rtt_probe_answers_and_can_be_turned_off(monkeypatch):
    monkeypatch.setitem(daemon._rtt_state, "last", {})
    monkeypatch.setitem(daemon._rtt_state, "running", set())
    daemon.prime_device_rtt("cpu")  # what the loops do before the first request
    v = daemon.device_rtt_ms("cpu")
    assert isinstance(v, float) and v >= 0
    monkeypatch.setenv("STX_STATS_RTT", "0")
    assert daemon.device_rtt_ms("cpu") is None
    monkeypatch.delenv("STX_STATS_RTT")
    _join_probes()
    # A probe still running and none finished: no value, and no second probe.
    calls = []
    monkeypatch.setattr(daemon, "_probe", lambda device: calls.append(device) or 1.0)
    monkeypatch.setitem(daemon._rtt_state, "last", {})
    monkeypatch.setitem(daemon._rtt_state, "running", {"cpu"})
    assert daemon.device_rtt_ms("cpu") is None
    _join_probes()
    assert calls == []


class _Lines:
    """A loop's stdout: each line with the time it was written."""

    def __init__(self):
        self.lines, self._buf, self._cond = [], "", threading.Condition()

    def write(self, text):
        with self._cond:
            self._buf += text
            while "\n" in self._buf:
                line, self._buf = self._buf.split("\n", 1)
                self.lines.append((line, time.perf_counter()))
                self._cond.notify_all()

    def flush(self):
        pass

    def wait(self, n, timeout=10.0):
        with self._cond:
            assert self._cond.wait_for(lambda: len(self.lines) >= n, timeout), self.lines
        return self.lines[:n]


@pytest.mark.parametrize("batched", [False, True])
def test_stats_never_waits_on_a_slow_probe(monkeypatch, batched):
    """A probe that takes seconds: STATS answers within 0.5 s without a value
    (none has finished), the requests beside it in a batched group are not
    held up, and a STATS sent after the probe finished carries its value.
    The JAX ``device_rtt_ms`` joins its probe for up to
    ``STX_STATS_RTT_TIMEOUT_S`` on every STATS."""
    import queue

    release = threading.Event()

    def slow_probe(device):  # sleeps until the test lets it finish
        release.wait(10.0)
        return 12.5

    monkeypatch.setattr(daemon, "_probe", slow_probe)
    monkeypatch.setitem(daemon._rtt_state, "last", {})
    monkeypatch.setitem(daemon._rtt_state, "running", set())
    # The default 2 s wait: the loop's priming gives up on the probe after it,
    # where the JAX STATS would wait as long again.
    monkeypatch.delenv("STX_STATS_RTT_TIMEOUT_S", raising=False)
    feed: "queue.Queue" = queue.Queue()
    out = _Lines()
    if batched:
        def loop():
            daemon.run_batched_request_loop(
                lambda reqs: [f"done {r[0]}" for r in reqs], 4,
                stdin=iter(feed.get, None), stdout=out, device="cpu")
    else:
        def loop():
            daemon.run_request_loop(lambda *f: f"done {f[0]}", stdin=iter(feed.get, None),
                                    stdout=out, device="cpu")
    th = threading.Thread(target=loop, daemon=True)
    th.start()
    feed.put("warm\n")
    out.wait(1)
    t0 = time.perf_counter()
    for line in ("a\n", "STATS\n", "b\n"):
        feed.put(line)
    got = out.wait(4)[1:]
    assert got[0][0] == "OK done a" and got[2][0] == "OK done b"
    assert re.fullmatch(r"OK STATS ok=[12] err=0 p50_ms=[0-9.]+ p95_ms=[0-9.]+ mean_ms=[0-9.]+"
                        r"( .*)?", got[1][0]) and "device_rtt_ms" not in got[1][0]
    assert max(t for _, t in got) - t0 < 0.5, [t - t0 for _, t in got]
    release.set()
    _join_probes()
    feed.put("STATS\n")
    last = out.wait(5)[4][0]
    assert last.startswith("OK STATS ok=3 err=0 ") and last.endswith(" device_rtt_ms=12.50")
    feed.put("\n")
    th.join(10.0)
    assert not th.is_alive()
    _join_probes()  # the probe the last STATS started ends on this test's state


# --- Both serve loops against JAX's ---------------------------------------------

def _run(loop, lines, **kw):
    """Run ``loop(stdin=, stdout=, **kw)`` on scripted lines in a worker
    thread; returns (served count, stdout lines)."""
    out, box = io.StringIO(), {}

    def target():
        try:
            box["n"] = loop(stdin=io.StringIO("".join(f"{ln}\n" for ln in lines)), stdout=out,
                            **kw)
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            box["exc"] = exc
    th = threading.Thread(target=target, daemon=True)
    th.start()
    th.join(LOOP_TIMEOUT_S)
    assert not th.is_alive(), f"the serve loop did not end within {LOOP_TIMEOUT_S} s"
    if "exc" in box:
        raise box["exc"]
    return box["n"], out.getvalue().splitlines()


@pytest.fixture
def project(tmp_path, monkeypatch):
    """A project root for both packages with two photos and the epoch 0 and
    1 checkpoints of a single-style and a 3-style net."""
    rng = np.random.default_rng(4)
    for name, shape in (("a.png", (40, 36, 3)), ("b.png", (30, 50, 3))):
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(tmp_path / name)
    models = str(tmp_path / "data" / "models")
    for epoch in (0, 1):
        key = jax.random.PRNGKey(epoch)
        jckpt.save_epoch(jax.device_get(jt.init_params(key)), "fast_st", "sty", epoch, models)
        tree = jax.device_get(jms.init_params(key, num_styles=S))
        noise = np.random.default_rng(epoch)
        tree = jax.tree_util.tree_map_with_path(
            lambda p, v: (np.asarray(v) + noise.normal(0, 0.3, v.shape)).astype(np.float32)
            if jms._is_affine_path(p) else np.asarray(v), tree)
        jckpt.save_epoch(tree, jmulti.MODEL_NAME, "trio", epoch, models)
    monkeypatch.setattr(jconstants, "PROJECT_ROOT_PATH", str(tmp_path))
    monkeypatch.setattr(tconstants, "PROJECT_ROOT_PATH", str(tmp_path))
    return tmp_path


def _script(tag, styles=None):
    """The request lines of one run: each photo by default and explicit
    output, the second bucket, a line of too many fields, an unknown and a
    malformed size, a missing file, STATS, RELOAD (epoch 0 -> 1) and a photo
    again; for serve-multi (``styles``: each photo request's STYLE field)
    also bad blends and an index out of range."""
    mid = (lambda k: f"\t{styles[k]}") if styles else (lambda k: "")
    return [
        "a.png" + (f"\t{mid(0)}" if styles else ""),
        f"b.png\t{tag}/explicit_b.png{mid(1)}",
        f"a.png\t{tag}/a48.png{mid(2)}\t48" if styles else f"a.png\t{tag}/a48.png\t48",
        "a.png\tx\t" + ("0\t32\textra" if styles else "32\textra"),
        "a.png\t" + ("\t0\t64" if styles else "\t64"),
        "a.png\t" + ("\t0\tbig" if styles else "\tbig"),
        "missing.png",
        "STATS",
        "RELOAD",
        f"a.png\t{tag}/after_reload.png{mid(3)}",
    ] + ([f"a.png\t\t{bad}" for bad in ("nan,1,0", "5", "1,1")] if styles else [])


def _normalized(lines, root, tag):
    """Lines with the package's output paths made relative, and STATS
    reduced to its counts."""
    out = []
    for ln in lines:
        ln = ln.replace(str(root) + "/", "").replace(f"{tag}/", "OUT/")
        if ln.startswith("OK STATS"):
            assert re.search(r"device_rtt_ms=[0-9.]+", ln) or tag == "jax", ln
            ln = " ".join(ln.split()[:4])  # OK STATS ok=.. err=..
        out.append(ln)
    return out


def _pngs(root, lines):
    return [np.asarray(Image.open(os.path.join(root, ln[3:]))).astype(np.int32)
            for ln in lines if ln.startswith("OK ") and ln.endswith(".png")]


def _compare(project, jloop, tloop, kw, styles=None):
    outs = {}
    for tag, loop in (("jax", jloop), ("port", tloop)):
        extra = {} if tag == "jax" else {"device": "cpu"}
        n, lines = _run(loop, _script(tag, styles), out_dir=f"{tag}/", sizes=SIZES,
                        **kw, **extra)
        outs[tag] = (n, lines)
    (jn, jlines), (tn, tlines) = outs["jax"], outs["port"]
    assert tlines[0] == jlines[0] == "READY"
    # Served: the four photos; the batched loop counts RELOAD's answer too,
    # in both packages.
    served = 4 if kw["batch_size"] == 1 else 5
    assert (tn, jn) == (served, served), (tlines, jlines)
    assert _normalized(tlines, project, "port") == _normalized(jlines, project, "jax")
    assert "OK RELOAD epoch=1" in tlines
    got, want = _pngs(project, tlines), _pngs(project, jlines)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.abs(g - w).max() <= U8_STEPS
    # The answer after RELOAD comes from epoch 1's weights.
    assert np.abs(got[-1] - got[0]).max() > U8_STEPS
    return tlines


@pytest.mark.parametrize("batch_size", [1, 3])
def test_fast_serve_loop_answers_as_jax_does(project, batch_size):
    path = os.path.join(project, "data", "models", "fast_st_sty_epoch0.msgpack")
    params = fast.ckpt.load(path)
    jparams = jckpt.load(path, jt.init_params(jax.random.PRNGKey(0)))

    def tloop(**kw):
        return fast.serve_loop(params=fast.transformer.params_from_jax(params, device="cpu"),
                               **kw)

    def jloop(**kw):
        return jfast.serve_loop(params=jparams, **kw)

    lines = _compare(project, jloop, tloop, dict(style_name="sty", batch_size=batch_size))
    assert lines[-1] == f"OK {project}/port/after_reload.png"


@pytest.mark.parametrize("batch_size", [1, 4])
def test_multi_serve_loop_answers_as_jax_does(project, batch_size):
    path = os.path.join(project, "data", "models", "fast_multi_st_trio_epoch0.msgpack")
    tree = fast.ckpt.load(path)
    jparams = jckpt.load(path, jms.init_params(jax.random.PRNGKey(0), num_styles=S))

    def tloop(**kw):
        return multi.serve_loop(params=multi.multistyle.params_from_jax(tree, device="cpu"),
                                **kw)

    def jloop(**kw):
        return jmulti.serve_loop(params=jparams, **kw)

    lines = _compare(project, jloop, tloop, dict(name="trio", num_styles=S,
                                                 batch_size=batch_size),
                     styles=["2", "0.2,0.3,0.5", "1", "0,0,1"])
    errs = [ln for ln in lines if ln.startswith("ERR a.png: ")]
    assert any("finite" in e for e in errs) and any("out of range" in e for e in errs)
    assert any("expected 3 blend weights" in e for e in errs)


def test_serve_clis_run_on_stdin_and_refuse_the_network_options(project):
    r = CliRunner().invoke(tcli, ["fast_st", "serve", "sty", "--size", "32", "-b", "2",
                                  "--device", "cpu"], input="a.png\nSTATS\n\n")
    assert r.exit_code == 0, r.output + repr(r.exception)
    lines = r.stdout.splitlines()
    # In a batched group STATS answers the counts from before the group.
    assert lines[0] == "READY" and lines[1].startswith("OK ")
    assert re.fullmatch(r"OK STATS ok=0 err=0 device_rtt_ms=[0-9.]+", lines[2])
    r = CliRunner().invoke(tcli, ["fast_st", "serve-multi", "trio", "--num-styles", str(S),
                                  "--sizes", "32,48", "--device", "cpu"],
                           input="a.png\t\t0.5,0.5,0\t48\n\n")
    assert r.exit_code == 0, r.output + repr(r.exception)
    assert r.stdout.splitlines()[1].endswith("converted_fast_multi_st_trio_a_blend_0.5_0.5_0.png")
    # The network options exist now (tests/test_torch_serve_cli.py); taken
    # together, or with a malformed port, they are usage errors.
    for cmd in (["serve", "sty"], ["serve-multi", "trio", "--num-styles", "3"]):
        r = CliRunner().invoke(tcli, ["fast_st", *cmd, "--tcp", "7000", "--http", "7000",
                                      "--device", "cpu"])
        assert r.exit_code == 2 and "--tcp and --http are mutually exclusive" in r.output
        for opt in ("--tcp", "--http"):
            r = CliRunner().invoke(tcli, ["fast_st", *cmd, opt, "x:port", "--device", "cpu"])
            assert r.exit_code == 2 and f"invalid {opt} PORT 'port'" in r.output
