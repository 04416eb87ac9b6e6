"""The port's four daemon commands (``fast_st serve``, ``fast_st serve-multi``,
``video_st serve``, ``gatys_st --serve``) as a user starts them: the JAX
CLIs' usage errors for the transport options, refused before any serving
state is built; ``video_st serve`` and ``gatys_st --serve`` on stdin (the
daemon's L-BFGS history defaults to 16, the one-shot run's to 100); and one
subprocess run of ``python -m styletransfer_tpu_torch fast_st serve ...
--device cpu --tcp 127.0.0.1:0`` with two socket clients (as JAX
``tests/test_daemon_e2e.py:126``), which ``examples/daemon_client.py``,
unchanged, drives over ``--tcp`` as well.

Every socket, pipe read and subprocess has a timeout."""

import os
import queue
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from styletransfer_tpu.clis import cli as jcli
from styletransfer_tpu_torch import ckpt, constants
from styletransfer_tpu_torch.clis import cli
from styletransfer_tpu_torch.engines import gatys
from styletransfer_tpu_torch.models import transformer

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32
PROC_TIMEOUT_S = 300
SOCKET_TIMEOUT_S = 300

DAEMONS = {
    "fast": (["fast_st", "serve", "sty"], ["--device", "cpu"]),
    "multi": (["fast_st", "serve-multi", "trio", "--num-styles", "3"], ["--device", "cpu"]),
    "video": (["video_st", "serve", "sty"], ["--device", "cpu"]),
    "gatys": (["gatys_st", "--serve"], ["--device", "cpu"]),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("opts", [["--tcp", "7000", "--http", "7001"], ["--tcp", "nope"],
                                  ["--http", "host:99999"], ["--tcp", "h:1:x"]],
                         ids=["both", "bad-tcp", "bad-http", "bad-tcp-port"])
@pytest.mark.parametrize("kind", sorted(DAEMONS))
def test_transport_usage_errors_match_jax(kind, opts, tmp_path, monkeypatch):
    """Each is exit code 2 with JAX's message, and no serving state: the
    project root stays empty (no results directory, no model loaded)."""
    monkeypatch.setattr(constants, "PROJECT_ROOT_PATH", str(tmp_path))
    args, port_only = DAEMONS[kind]
    got = CliRunner().invoke(cli, args + opts + port_only)
    want = CliRunner().invoke(jcli, args + opts)
    assert got.exit_code == want.exit_code == 2, got.output
    error = [ln for ln in got.output.splitlines() if ln.startswith("Error: ")]
    assert error == [ln for ln in want.output.splitlines() if ln.startswith("Error: ")]
    assert error and ("mutually exclusive" in error[0] or "--tcp" in error[0]
                      or "--http" in error[0])
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("args,phrase", [
    (["c.png", "s.png", "--tcp", "7000"], "--tcp/--http require --serve"),
    (["c.png", "s.png", "--http", "7000"], "--tcp/--http require --serve"),
    (["--serve", "--coarse-steps", "3"], "--coarse-steps is not supported in --serve mode"),
    ([], "CONTENT-IMAGE-PATH and STYLE-IMAGE-PATH are required"),
])
def test_gatys_usage_errors(args, phrase, tmp_path, monkeypatch):
    monkeypatch.setattr(constants, "PROJECT_ROOT_PATH", str(tmp_path))
    got = CliRunner().invoke(cli, ["gatys_st", *args, "--device", "cpu"])
    want = CliRunner().invoke(jcli, ["gatys_st", *args])
    assert got.exit_code == want.exit_code == 2 and phrase in got.output
    assert phrase in want.output
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("args,history", [(["--serve"], 16),
                                          (["--serve", "--history-size", "100"], 100)])
def test_gatys_serve_history_default(args, history, monkeypatch):
    seen = {}
    monkeypatch.setattr(gatys, "serve_loop", lambda **kw: seen.update(kw) or 0)
    r = CliRunner().invoke(cli, ["gatys_st", *args, "-b", "3", "--device", "cpu"])
    assert r.exit_code == 0, r.output
    assert seen["history_size"] == history and seen["batch"] == 3 and seen["device"] == "cpu"


def test_gatys_one_shot_history_default(monkeypatch, tmp_path):
    seen = {}

    def fake(vgg_params, **kw):
        seen.update(kw)
        raise RuntimeError("stop here")

    monkeypatch.setattr(constants, "PROJECT_ROOT_PATH", str(tmp_path))
    rng = np.random.default_rng(0)
    for n in ("c.png", "s.png"):
        Image.fromarray(rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)).save(tmp_path / n)
    monkeypatch.setattr(gatys, "train_gatys", fake)
    r = CliRunner().invoke(cli, ["gatys_st", "c.png", "s.png", "--size", str(SIZE),
                                 "--device", "cpu"])
    assert "stop here" in str(r.exception) and seen["history_size"] == 100


def _project(tmp_path):
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)).save(
        tmp_path / "content.png")
    models = str(tmp_path / "data" / "models")
    ckpt.save(transformer.init_params(seed=0, device="cpu"),
              ckpt.checkpoint_path("fast_st", "sty", 0, models))
    ckpt.save(transformer.init_video_params(seed=0, device="cpu"),
              ckpt.checkpoint_path("video_st", "sty", 0, models))
    return "content.png"


def test_video_and_gatys_daemons_on_stdin(tmp_path, monkeypatch):
    monkeypatch.setattr(constants, "PROJECT_ROOT_PATH", str(tmp_path))
    content = _project(tmp_path)
    r = CliRunner().invoke(cli, ["video_st", "serve", "sty", "--size", str(SIZE), "-b", "2",
                                 "--device", "cpu"],
                           input=f"{content}\n{content}\t\tcam\nRESET\n{content}\ta\tb\tc\td\n"
                                 "RELOAD\n\n")
    assert r.exit_code == 0, r.output + repr(r.exception)
    lines = r.stdout.splitlines()
    assert lines[0] == "READY" and lines[1] == f"OK {tmp_path}/results/video_st_sty_content.png"
    assert lines[2] == f"OK {tmp_path}/results/video_st_sty_scam_content.png"
    assert lines[3] == "OK RESET"
    assert lines[4] == f"ERR {content}: expected FRAME[\\tOUTPUT[\\tSTREAM[\\tSIZE]]], got 5 fields"
    assert lines[5] == "OK RELOAD epoch=0"
    Image.open(tmp_path / content).save(tmp_path / "style.png")
    r = CliRunner().invoke(cli, ["gatys_st", "--serve", "-s", "1", "--size", str(SIZE),
                                 "--optimizer", "adam", "--device", "cpu"],
                           input=f"{content}\tstyle.png\n{content}\nRELOAD\n\n")
    assert r.exit_code == 0, r.output + repr(r.exception)
    lines = r.stdout.splitlines()
    assert lines[0] == "READY"
    assert lines[1].startswith(f"OK {tmp_path}/results/gatys_content_style.png loss=")
    assert lines[2] == f"ERR {content}: expected CONTENT\\tSTYLE[\\tOUTPUT]"
    assert lines[3].startswith("ERR RELOAD: the gatys daemon has no RELOAD")


# --- The shipped command over TCP, in a subprocess --------------------------------------

class _Lines:
    """A subprocess pipe read by a thread (so that a full pipe never blocks
    the process): ``get()`` waits at most a timeout; None is the end."""

    def __init__(self, pipe):
        self.q: "queue.Queue" = queue.Queue()
        self.seen: list = []

        def pump():
            for line in pipe:
                self.seen.append(line)
                self.q.put(line.rstrip("\n"))
            self.q.put(None)
        self.thread = threading.Thread(target=pump, daemon=True)
        self.thread.start()

    def get(self, timeout=PROC_TIMEOUT_S):
        return self.q.get(timeout=timeout)

    def text(self):
        self.thread.join(PROC_TIMEOUT_S)
        return "".join(self.seen)


def _connect(port):
    s = socket.create_connection(("127.0.0.1", port), timeout=SOCKET_TIMEOUT_S)
    s.settimeout(SOCKET_TIMEOUT_S)
    return s, s.makefile("r", encoding="utf-8")


@pytest.mark.subprocess
def test_fast_serve_tcp_subprocess_with_two_clients_and_the_example_client(tmp_path):
    content = _project(tmp_path)
    env = dict(os.environ, STX_PROJECT_ROOT=str(tmp_path), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "styletransfer_tpu_torch", "fast_st", "serve", "sty", "--size",
         str(SIZE), "--device", "cpu", "--tcp", "127.0.0.1:0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO_ROOT, env=env)
    try:
        out, err = _Lines(proc.stdout), _Lines(proc.stderr)
        banner = out.get()
        assert banner is not None and banner.startswith("TCP 127.0.0.1 "), banner
        port = int(banner.split()[2])

        c1, r1 = _connect(port)
        assert r1.readline().strip() == "READY"  # waits out the warm-up
        assert out.get() == "READY"  # the supervisor's handshake on stdout
        c1.sendall(f"{content}\n".encode())
        resp = r1.readline().strip()
        assert resp == f"OK {tmp_path}/results/converted_fast_st_sty_content.png"

        c2, r2 = _connect(port)
        assert r2.readline().strip() == "READY"  # greeted after the warm-up
        c2.sendall(b"missing.png\n")
        assert r2.readline().strip().startswith("ERR missing.png: ")
        c2.sendall(b"\n")  # goodbye closes only this connection
        assert r2.readline() == ""

        # The JAX package's example client, unchanged, over --tcp.
        client = subprocess.run(
            [sys.executable, os.path.join(REPO_ROOT, "examples", "daemon_client.py"), "fast",
             "sty", "--tcp", f"127.0.0.1:{port}", content, content],
            capture_output=True, text=True, timeout=PROC_TIMEOUT_S, cwd=str(tmp_path))
        assert client.returncode == 0, client.stderr[-2000:]
        assert client.stdout.splitlines() == [
            f"OK {tmp_path}/results/converted_fast_st_sty_content.png"] * 2

        c1.sendall(f"{content}\tout/tcp.png\n".encode())
        assert r1.readline().strip() == f"OK {tmp_path}/out/tcp.png"
        c1.sendall(b"SHUTDOWN\n")
        assert r1.readline().strip() == "OK SHUTDOWN"
        assert proc.wait(timeout=PROC_TIMEOUT_S) == 0, err.text()[-2000:]
        assert out.get(timeout=10) is None  # nothing else on the protocol stream
        assert "shutting down after 4 request(s)" in err.text()
        for f in (r1, r2, c1, c2):
            f.close()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
