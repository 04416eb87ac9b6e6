"""The port's TCP transport (``styletransfer_tpu_torch/engines/netserve.py``)
against the JAX package's: ``parse_hostport`` on a table of specs, then the
scripted sessions of ``tests/test_netserve.py`` (two clients, goodbye,
SHUTDOWN, READY on both sides of the warm-up, owed responses before a
goodbye, a vanished client, a slow reader, batched routing across clients)
through BOTH packages' ``serve_over_tcp``, each over its own package's
request loops with the same deterministic handler: the per-client
transcripts must be identical. Last, the port's real ``fast.serve_loop``
behind TCP writes the same PNGs as its stdin daemon on the same requests.

Every socket has a timeout and every thread join has one, so no test can
hang."""

import io
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from styletransfer_tpu.engines import daemon as jdaemon
from styletransfer_tpu.engines import netserve as jnet
from styletransfer_tpu_torch import ckpt, constants
from styletransfer_tpu_torch.engines import daemon as tdaemon
from styletransfer_tpu_torch.engines import fast
from styletransfer_tpu_torch.engines import netserve as tnet
from styletransfer_tpu_torch.models import transformer

PACKAGES = {"jax": (jnet, jdaemon), "port": (tnet, tdaemon)}
SOCKET_TIMEOUT_S = 20
JOIN_TIMEOUT_S = 60


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- parse_hostport ------------------------------------------------------------

@pytest.mark.parametrize("spec", ["7000", "0.0.0.0:81", ":81", "0", "localhost:65535",
                                  "[::1]:80", "nope", "host:99999", "host:-1", "a:b:12", ""])
@pytest.mark.parametrize("flag", ["--tcp", "--http"])
def test_parse_hostport_matches_jax(spec, flag):
    def run(parse):
        try:
            return parse(spec, flag=flag)
        except ValueError as exc:
            return "ValueError", str(exc)
    got, want = run(tnet.parse_hostport), run(jnet.parse_hostport)
    assert got == want
    if isinstance(want[0], str) and want[0] == "ValueError":
        assert flag in want[1]


# --- The harness: one server and its clients, for either package -----------------

class _Server:
    """``serve_over_tcp`` of one package on a loop, in a thread."""

    def __init__(self, net, run_loop, name="t"):
        self.port, self.result, self.error = None, None, None
        self.stdout = io.StringIO()
        bound = threading.Event()

        def on_listen(p):
            self.port = p
            bound.set()

        def main():
            try:
                self.result = net.serve_over_tcp(run_loop, host="127.0.0.1", port=0,
                                                 stdout=self.stdout, name=name,
                                                 _on_listen=on_listen)
            except BaseException as exc:  # noqa: BLE001 - re-raised in join()
                self.error = exc
                bound.set()

        self.thread = threading.Thread(target=main, daemon=True)
        self.thread.start()
        assert bound.wait(SOCKET_TIMEOUT_S), "the listener never bound"

    def join(self):
        self.thread.join(JOIN_TIMEOUT_S)
        assert not self.thread.is_alive(), "the server did not shut down"
        if self.error is not None:
            raise self.error

    def banner(self):
        """The supervisor-facing stdout with the bound port named."""
        return [ln.replace(str(self.port), "PORT") for ln in self.stdout.getvalue().splitlines()]


_OPEN_CLIENTS: list = []


@pytest.fixture(autouse=True)
def _close_clients():
    """Close every test client's socket after its test."""
    yield
    while _OPEN_CLIENTS:
        _OPEN_CLIENTS.pop().close()


class _Client:
    def __init__(self, port, log, name):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=SOCKET_TIMEOUT_S)
        self.sock.settimeout(SOCKET_TIMEOUT_S)
        self.rfile = self.sock.makefile("r", encoding="utf-8")
        self.log, self.name = log, name
        _OPEN_CLIENTS.append(self)

    def send(self, line):
        self.sock.sendall((line + "\n").encode())

    def recv(self):
        line = self.rfile.readline().rstrip("\n")
        self.log.append((self.name, line))
        return line

    def close(self):
        self.rfile.close()
        self.sock.close()


def _upper(*fields):
    if fields[0] == "boom":
        raise ValueError("kapow")
    return "+".join(fields).upper()


def _serial_loop(daemon, handle=_upper, go=None):
    def run(stdin, stdout):
        if go is not None:
            assert go.wait(SOCKET_TIMEOUT_S)
        print("READY", file=stdout, flush=True)
        return daemon.run_request_loop(handle, stdin=stdin, stdout=stdout, name="t")
    return run


# --- The sessions of tests/test_netserve.py, recorded ----------------------------

def _two_clients(net, daemon, log, monkeypatch):
    srv = _Server(net, _serial_loop(daemon))
    c1, c2 = _Client(srv.port, log, "c1"), _Client(srv.port, log, "c2")
    c1.recv(), c2.recv()
    c1.send("a")
    c1.recv()
    c2.send("b\tc")
    c2.recv()
    c1.send("boom")
    c1.recv()
    c1.send("")  # goodbye: closes c1 only
    c1.recv()
    c2.send("still\there")
    c2.recv()
    c2.send("SHUTDOWN")
    c2.recv()
    srv.join()
    return srv


def _ready_both_sides(net, daemon, log, monkeypatch):
    go = threading.Event()
    srv = _Server(net, _serial_loop(daemon, go=go))
    early = _Client(srv.port, log, "early")
    time.sleep(0.1)
    go.set()
    early.recv()
    late = _Client(srv.port, log, "late")
    late.recv()
    late.send("x")
    late.recv()
    late.send("SHUTDOWN")
    late.recv()
    srv.join()
    return srv


def _batched_across_clients(net, daemon, log, monkeypatch):
    go = threading.Event()

    def run(stdin, stdout):
        assert go.wait(SOCKET_TIMEOUT_S)
        print("READY", file=stdout, flush=True)
        return daemon.run_batched_request_loop(
            lambda reqs: ["+".join(f).upper() for f in reqs], max_batch=4, stdin=stdin,
            stdout=stdout, name="t")

    srv = _Server(net, run)
    c1, c2 = _Client(srv.port, log, "c1"), _Client(srv.port, log, "c2")
    for i in range(3):  # queued before the loop consumes: groups span both clients
        c1.send(f"a{i}")
        c2.send(f"b{i}")
    go.set()
    c1.recv(), c2.recv()
    for _ in range(3):
        c1.recv()
    for _ in range(3):
        c2.recv()
    c1.send("SHUTDOWN")
    c1.recv()
    srv.join()
    return srv


def _owed_before_goodbye(net, daemon, log, monkeypatch):
    def slow(*fields):
        time.sleep(0.2)
        return fields[0].upper()

    srv = _Server(net, _serial_loop(daemon, handle=slow))
    c1 = _Client(srv.port, log, "c1")
    c1.recv()
    c1.sock.sendall(b"gone\n\n")  # a request and the goodbye in one segment
    c1.recv(), c1.recv()
    c2 = _Client(srv.port, log, "c2")
    c2.recv()
    c2.sock.sendall(b"last\nSHUTDOWN\n")
    c2.recv(), c2.recv(), c2.recv()
    srv.join()
    return srv


def _vanished_client(net, daemon, log, monkeypatch):
    started = threading.Event()

    def slow(*fields):
        started.set()
        time.sleep(0.3)
        return fields[0].upper()

    srv = _Server(net, _serial_loop(daemon, handle=slow))
    c1 = _Client(srv.port, log, "c1")
    c1.recv()
    c1.send("gone")
    assert started.wait(SOCKET_TIMEOUT_S)
    c1.close()  # vanish with the response in flight
    c2 = _Client(srv.port, log, "c2")
    c2.recv()
    c2.send("alive")
    c2.recv()
    c2.send("SHUTDOWN")
    c2.recv()
    srv.join()
    return srv


def _slow_reader(net, daemon, log, monkeypatch):
    monkeypatch.setattr(net._Client, "SEND_QUEUE", 4)
    monkeypatch.setattr(net._Client, "SEND_TIMEOUT_S", 1.0)
    big = "X" * 65536
    srv = _Server(net, _serial_loop(daemon, handle=lambda *f: big if f[0] == "big"
                                    else f[0].upper()))
    slow = _Client(srv.port, [], "slow")  # its lines are not part of the transcript
    slow.recv()
    fast_c = _Client(srv.port, log, "fast")
    fast_c.recv()
    for _ in range(40):
        slow.send("big")  # and never read
    deadline = time.time() + 15
    served = 0
    while time.time() < deadline and served < 20:
        fast_c.send("ping")
        fast_c.recv()
        served += 1
        time.sleep(0.05)
    fast_c.send("SHUTDOWN")
    fast_c.recv()
    srv.join()
    slow.close()
    return srv


SESSIONS = {
    "two_clients": (_two_clients, 3, [
        ("c1", "READY"), ("c2", "READY"), ("c1", "OK A"), ("c2", "OK B+C"),
        ("c1", "ERR boom: kapow"), ("c1", ""), ("c2", "OK STILL+HERE"), ("c2", "OK SHUTDOWN")]),
    "ready_both_sides": (_ready_both_sides, 1, [
        ("early", "READY"), ("late", "READY"), ("late", "OK X"), ("late", "OK SHUTDOWN")]),
    "batched_across_clients": (_batched_across_clients, 6, [
        ("c1", "READY"), ("c2", "READY"), ("c1", "OK A0"), ("c1", "OK A1"), ("c1", "OK A2"),
        ("c2", "OK B0"), ("c2", "OK B1"), ("c2", "OK B2"), ("c1", "OK SHUTDOWN")]),
    "owed_before_goodbye": (_owed_before_goodbye, 2, [
        ("c1", "READY"), ("c1", "OK GONE"), ("c1", ""), ("c2", "READY"), ("c2", "OK LAST"),
        ("c2", "OK SHUTDOWN"), ("c2", "")]),
    "vanished_client": (_vanished_client, 2, [
        ("c1", "READY"), ("c2", "READY"), ("c2", "OK ALIVE"), ("c2", "OK SHUTDOWN")]),
    "slow_reader": (_slow_reader, None, [("fast", "READY")] + [("fast", "OK PING")] * 20
                    + [("fast", "OK SHUTDOWN")]),
}


@pytest.mark.parametrize("session", sorted(SESSIONS))
def test_tcp_session_transcripts_match_jax(session, monkeypatch):
    script, served, want = SESSIONS[session]
    runs = {}
    for pkg, (net, daemon) in PACKAGES.items():
        log = []
        srv = script(net, daemon, log, monkeypatch)
        runs[pkg] = (log, srv.result, srv.banner())
    assert runs["port"] == runs["jax"]
    log, result, banner = runs["port"]
    assert log == want
    if served is not None:
        assert result == served
    assert banner[0] == "TCP 127.0.0.1 PORT" and "READY" in banner


# --- A client that reads nothing --------------------------------------------------

SEND_LIMIT_S = 0.05  # the longest a send_line call may take


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_send_line_to_a_client_that_reads_nothing(pkg, monkeypatch):
    """One client whose peer reads nothing, its send queue made small: the
    JAX ``send_line`` blocks for ``SEND_TIMEOUT_S`` once the queue is full;
    the port's returns at once every time, and the first call after the
    deadline drops the client."""
    net = PACKAGES[pkg][0]
    monkeypatch.setattr(net._Client, "SEND_QUEUE", 2)
    monkeypatch.setattr(net._Client, "SEND_TIMEOUT_S", 0.3)
    ours, peer = socket.socketpair()
    peer.settimeout(SOCKET_TIMEOUT_S)
    client = net._Client(ours, "peer", 0)
    big = "X" * (1 << 20)  # past any socket buffer: the writer stays in sendall
    try:
        times, sent = [], []
        for _ in range(6):
            t0 = time.perf_counter()
            sent.append(client.send_line(big))
            times.append(time.perf_counter() - t0)
        if pkg == "jax":  # the fault: the engine thread waits out the deadline
            assert max(times) >= 0.3 and not all(sent)
            return
        assert all(sent) and max(times) < SEND_LIMIT_S, times
        time.sleep(0.35)  # the queue has now been full past the deadline
        t0 = time.perf_counter()
        assert client.send_line("late") is False
        assert time.perf_counter() - t0 < SEND_LIMIT_S and not client.alive
    finally:
        client.close()
        peer.close()


def test_a_stalled_client_holds_up_no_other(monkeypatch):
    """Behind TCP, a client that sends requests with large answers and reads
    nothing, beside one that reads: no ``send_line`` call takes more than
    50 ms, the second client's answers arrive meanwhile, and the first is
    dropped at the first answer due after its deadline."""
    monkeypatch.setattr(tnet._Client, "SEND_QUEUE", 4)
    monkeypatch.setattr(tnet._Client, "SEND_TIMEOUT_S", 1.0)
    durations, dropped = [], []
    real_send = tnet._Client.send_line

    def timed_send(self, line):
        t0 = time.perf_counter()
        ok = real_send(self, line)
        durations.append(time.perf_counter() - t0)
        if not ok and line.startswith("OK X"):
            dropped.append(time.perf_counter())
        return ok

    monkeypatch.setattr(tnet._Client, "send_line", timed_send)
    big = "X" * (1 << 20)
    srv = _Server(tnet, _serial_loop(tdaemon, handle=lambda *f: big if f[0] == "big"
                                     else f[0].upper()))
    slow = _Client(srv.port, [], "slow")
    slow.recv()
    fast_c = _Client(srv.port, [], "fast")
    fast_c.recv()
    # 32 MiB of answers, more than the kernel's socket buffers take in: the
    # writer blocks and the send queue fills.
    for _ in range(32):
        slow.send("big")  # and never read
    t_stall = time.perf_counter()
    answers = []
    while time.perf_counter() - t_stall < 1.5:
        fast_c.send("ping")
        answers.append(fast_c.recv())
        time.sleep(0.02)
    slow.send("big")  # its answer is due after the deadline
    fast_c.send("ping")
    answers.append(fast_c.recv())
    fast_c.send("SHUTDOWN")
    answers.append(fast_c.recv())
    srv.join()
    assert answers[-1] == "OK SHUTDOWN" and set(answers[:-1]) == {"OK PING"}
    assert len(answers) > 20
    assert max(durations) < SEND_LIMIT_S, max(durations)
    assert dropped and dropped[0] - t_stall >= 1.0


# --- The real fast_st daemon behind TCP ----------------------------------------------

def test_fast_serve_loop_over_tcp_writes_the_stdin_daemons_pngs(tmp_path, monkeypatch):
    """Two clients of a ``fast.serve_loop`` at batch 2 behind TCP, against the
    same loop on scripted stdin: the same answers, the same PNG bytes."""
    monkeypatch.setattr(constants, "PROJECT_ROOT_PATH", str(tmp_path))
    rng = np.random.default_rng(3)
    names = [f"img{i}.png" for i in range(4)]
    for n in names:
        Image.fromarray(rng.integers(0, 256, (36, 40, 3), dtype=np.uint8)).save(tmp_path / n)
    models = str(tmp_path / "data" / "models")
    ckpt.save(transformer.init_params(seed=5, device="cpu"),
              ckpt.checkpoint_path("fast_st", "sty", 0, models))

    def loop(stdin, stdout, tag):
        return fast.serve_loop("sty", out_dir=f"{tag}/", models_path=models, size=32,
                               batch_size=2, stdin=stdin, stdout=stdout, device="cpu")

    lines = [f"{n}\tpipe/{n}" for n in names] + ["missing.png"]
    out = io.StringIO()
    box = {}
    th = threading.Thread(target=lambda: box.update(n=loop(
        io.StringIO("".join(f"{ln}\n" for ln in lines) + "\n"), out, "pipe")), daemon=True)
    th.start()
    th.join(JOIN_TIMEOUT_S)
    assert not th.is_alive() and box["n"] == 4
    piped = out.getvalue().splitlines()

    srv = _Server(tnet, lambda i, o: loop(i, o, "tcp"))
    log = []
    c1, c2 = _Client(srv.port, log, "c1"), _Client(srv.port, log, "c2")
    assert c1.recv() == "READY" and c2.recv() == "READY"
    for n in names[:2]:
        c1.send(f"{n}\ttcp/{n}")
    for n in names[2:]:
        c2.send(f"{n}\ttcp/{n}")
    c2.send("missing.png")
    got1, got2 = [c1.recv() for _ in range(2)], [c2.recv() for _ in range(3)]
    c1.send("")
    assert c1.recv() == ""
    c2.send("SHUTDOWN")
    assert c2.recv() == "OK SHUTDOWN"
    srv.join()
    assert srv.result == 4
    assert [ln.replace("tcp/", "pipe/") for ln in got1 + got2] == piped[1:]
    assert piped[-1].startswith("ERR missing.png: ")
    for n in names:
        a = np.asarray(Image.open(tmp_path / "tcp" / n))
        b = np.asarray(Image.open(tmp_path / "pipe" / n))
        assert a.shape == (32, 32, 3) and np.array_equal(a, b), n
    assert os.path.getsize(tmp_path / "tcp" / names[0]) > 0


_SLOW_NETWORK_DAEMON = """
import socket, sys, time
real = socket.socket.sendall

def slow(self, data, *args):
    time.sleep(0.3)
    return real(self, data, *args)

socket.socket.sendall = slow
from {pkg}.engines import daemon, netserve

def run(stdin, stdout):
    print("READY", file=stdout, flush=True)
    return daemon.run_request_loop(lambda *f: f[0].upper(), stdin=stdin, stdout=stdout)

netserve.serve_over_tcp(run, port=0)
"""


@pytest.mark.subprocess
def test_shutdown_ack_is_delivered_before_the_process_exits():
    """A daemon process on a slow network (every send takes 0.3 s): the
    ``OK SHUTDOWN`` ack is still on its client's writer thread when the
    engine loop ends, and the writers are daemon threads, so the process
    must wait for that writer before it exits. (JAX's transport closes every
    connection and returns at once: the same script loses the ack there.)"""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen([sys.executable, "-c", _SLOW_NETWORK_DAEMON.format(
        pkg="styletransfer_tpu_torch")], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True, cwd=root)
    try:
        banner = proc.stdout.readline().split()
        assert banner[:2] == ["TCP", "127.0.0.1"], banner
        log = []
        c = _Client(int(banner[2]), log, "c")
        c.recv()
        c.send("SHUTDOWN")
        c.recv()
        c.recv()
        assert log == [("c", "READY"), ("c", "OK SHUTDOWN"), ("c", "")]
        out, _ = proc.communicate(timeout=JOIN_TIMEOUT_S)
        assert proc.returncode == 0 and out.strip() == "READY"
        c.close()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=JOIN_TIMEOUT_S)
