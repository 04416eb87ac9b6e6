"""The port's HTTP gateway (``styletransfer_tpu_torch/engines/httpserve.py``)
against the JAX package's: ``build_request_line``, ``_stats_to_json`` and
``_stats_to_prometheus`` on the same inputs (one of them a real STATS payload
of the port's loop, with ``device_rtt_ms``); per daemon kind (fast, multi,
video, gatys) one scripted HTTP session through both gateways, each over its
own package's request loop with the same fake engine, which must give the
same status codes, headers and bodies; blend weights that are NaN or inf
answer 422 through the port's style parsers, as through JAX's; and the
keep-alive, spool and no-body cases of ``tests/test_httpserve.py`` on the
port's gateway.

Every socket and HTTP call has a timeout and every thread join has one."""

import io
import json
import os
import socket
import tempfile
import threading
import time
import urllib.error
import urllib.request

import pytest

from styletransfer_tpu.engines import daemon as jdaemon
from styletransfer_tpu.engines import gatys as jgatys
from styletransfer_tpu.engines import httpserve as jhttp
from styletransfer_tpu.engines import multistyle as jmulti
from styletransfer_tpu_torch.engines import daemon as tdaemon
from styletransfer_tpu_torch.engines import gatys as tgatys
from styletransfer_tpu_torch.engines import httpserve as thttp
from styletransfer_tpu_torch.engines import multistyle as tmulti

PACKAGES = {"jax": (jhttp, jdaemon), "port": (thttp, tdaemon)}
TIMEOUT_S = 30
# The headers a response is compared by (Date and Server vary).
HEADERS = ("Content-Type", "Content-Length", "Connection", "X-Final-Loss")
FIXED_STATS = ("STATS ok=3 err=1 p50_ms=4.0 p95_ms=9.0 mean_ms=5.0 latency=enqueue-to-reply "
               "amort_mean_ms=2.5 amort_p50_ms=2.0 mean_batch_fill=1.5 device_rtt_ms=0.25")


# --- The pure functions ------------------------------------------------------------

REQUEST_PARAMS = [
    ("fast", {}), ("fast", {"size": ["512"]}), ("multi", {}),
    ("multi", {"style": ["0.3,0.7"], "size": ["512"]}), ("multi", {"style": ["nan,1"]}),
    ("multi", {"style": ["inf,1"]}), ("video", {"stream": ["cam1"]}), ("video", {}),
    ("video", {"stream": ["cam 7"], "size": ["64"]}), ("gatys", {"style": ["s.png"]}),
    ("gatys", {"style": ["a.png,b.png:0.3,0.7"]}), ("gatys", {}),
    ("multi", {"style": ["0\tinjected"]}), ("fast", {"size": ["5\n"]}),
    ("video", {"stream": ["a\rb"]}),
]


@pytest.mark.parametrize("kind,params", REQUEST_PARAMS)
def test_build_request_line_matches_jax(kind, params):
    def run(build):
        try:
            return build(kind, "i", "o", params)
        except ValueError as exc:
            return "ValueError", str(exc)
    assert run(thttp.build_request_line) == run(jhttp.build_request_line)


@pytest.mark.parametrize("spec", ["nan,1,0", "inf,1,0", "1,-inf,1", "NaN,NaN,1", "0,0,0"])
def test_nonfinite_blend_weights_are_refused_as_jax_refuses_them(spec):
    """The gateway passes STYLE through; the engines' parsers refuse
    non-finite weights (serve-multi's index/blend parser and the Gatys blend
    spec) with JAX's messages, so /v1/stylize answers 422 for them."""
    def run(fn):
        try:
            fn()
            return None
        except ValueError as exc:
            return str(exc)
    want = run(lambda: jmulti._make_style_parser(3)(spec))
    assert want is not None and run(lambda: tmulti._make_style_parser(3)(spec)) == want
    gspec = "a.png,b.png,c.png:" + spec
    want = run(lambda: jgatys.parse_style_spec(gspec))
    assert want is not None and run(lambda: tgatys.parse_style_spec(gspec)) == want


def _port_stats_payload():
    stats = tdaemon._ServeStats("t", tdaemon.get_logger())
    stats.record(3, 1, 0.02, group_size=4, request_times_ms=[5.0, 6.0, 7.0, 8.0])
    stats.record(1, 0, 0.004)
    tdaemon.prime_device_rtt("cpu")  # as the loops do: STATS serves the last probe
    return stats.snapshot() + tdaemon._rtt_suffix("cpu")


PAYLOADS = ["ok=12 err=1 p50_ms=4.2 latency=group-amortized",
            "ok=12 err=1 p50_ms=4.0 p95_ms=9.0 mean_ms=5.0 latency=group-amortized "
            "mean_batch_fill=3.5",
            "ok=8 err=0 p50_ms=50.0 p95_ms=60.0 mean_ms=52.0 latency=enqueue-to-reply "
            "amort_mean_ms=13.0 amort_p50_ms=12.0 mean_batch_fill=4.0",
            "ok=1 err=0 p50_ms=5.0 device_rtt_ms=26.4", "ok=0 err=0", "", "junk k= =v",
            FIXED_STATS[len("STATS "):], "port"]


@pytest.mark.parametrize("payload", PAYLOADS)
def test_stats_to_json_and_prometheus_match_jax(payload):
    if payload == "port":
        payload = _port_stats_payload()
        assert "device_rtt_ms=" in payload and "amort_p50_ms=" in payload
    assert thttp._stats_to_json(payload) == jhttp._stats_to_json(payload)
    for name in ("fast-http", 'we"ird\\name'):
        assert thttp._stats_to_prometheus(payload, name) == jhttp._stats_to_prometheus(
            payload, name)


def test_serve_transport_refuses_what_jax_refuses():
    for tcp, http in (("9999", "9999"), (None, "x:notaport"), ("70000", None)):
        with pytest.raises(ValueError) as got:
            thttp.serve_transport(lambda i, o: 0, tcp=tcp, http=http, kind="fast", name="x")
        with pytest.raises(ValueError) as want:
            jhttp.serve_transport(lambda i, o: 0, tcp=tcp, http=http, kind="fast", name="x")
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown daemon kind"):
        thttp.serve_over_http(lambda i, o: 0, kind="nope")


# --- The harness ---------------------------------------------------------------------

class _Server:
    """``serve_over_http`` of one package on a loop, in a thread."""

    def __init__(self, http, run_loop, kind="fast", name="t"):
        self.port, self.result, self.error = None, None, None
        self.stdout = io.StringIO()
        bound = threading.Event()

        def on_listen(p):
            self.port = p
            bound.set()

        def main():
            try:
                self.result = http.serve_over_http(run_loop, host="127.0.0.1", port=0,
                                                   kind=kind, stdout=self.stdout, name=name,
                                                   _on_listen=on_listen)
            except BaseException as exc:  # noqa: BLE001 - re-raised in join()
                self.error = exc
                bound.set()

        self.thread = threading.Thread(target=main, daemon=True)
        self.thread.start()
        assert bound.wait(TIMEOUT_S), "the gateway never bound"

    def request(self, path, data=None, method=None):
        """(status, the compared headers, body bytes)."""
        req = urllib.request.Request(f"http://127.0.0.1:{self.port}{path}", data=data,
                                     method=method)
        try:
            with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
                status, headers, body = r.status, r.headers, r.read()
        except urllib.error.HTTPError as e:
            status, headers, body = e.code, e.headers, e.read()
        return status, {h: headers[h] for h in HEADERS if headers[h] is not None}, body

    def join(self):
        self.thread.join(TIMEOUT_S)
        assert not self.thread.is_alive(), "the gateway did not shut down"
        if self.error is not None:
            raise self.error


def _fake_loop(daemon, kind, batched=False, gate=None, stats=True):
    """A fake engine of one daemon kind on one package's request loop. Its
    OUTPUT is the input's bytes reversed, then the request's non-path fields;
    a body of ``BOOM`` or a STYLE of ``bad`` fails the request; for multi
    and gatys the STYLE field goes through the port's style parser, as the
    real engines' do; gatys answers ``<out> loss=1.2345``."""
    parse = tmulti._make_style_parser(3)

    def handle(*fields):
        if fields[0] == "RESET":
            return f"RESET {fields[2]}" if len(fields) > 2 else "RESET"
        if kind == "gatys":
            in_path, style, out_path = fields
            tgatys.parse_style_spec(style)
            extra = [style]
        else:
            in_path, out_path, extra = fields[0], fields[1], list(fields[2:])
            if kind == "multi":
                parse(extra[0])
        with open(in_path, "rb") as f:
            data = f.read()
        if data == b"BOOM" or "bad" in extra:
            raise ValueError("bad image payload")
        with open(out_path, "wb") as f:
            f.write(data[::-1] + b"|" + "|".join(extra).encode())
        return f"{out_path} loss=1.2345" if kind == "gatys" else out_path

    commands = {"RELOAD": lambda: "RELOAD epoch=7"}
    if stats:
        commands["STATS"] = lambda: FIXED_STATS

    def run_loop(stdin, stdout):
        if gate is not None:
            assert gate.wait(TIMEOUT_S)
        print("READY", file=stdout, flush=True)
        if batched:
            def handle_batch(requests):
                out = []
                for fields in requests:
                    if fields == ["STATS"]:
                        continue  # answered by the loop
                    try:
                        out.append(commands[fields[0]]() if fields[0] in commands
                                   else handle(*fields))
                    except Exception as exc:  # noqa: BLE001 - answered per request
                        out.append(exc)
                return out
            return daemon.run_batched_request_loop(handle_batch, max_batch=4, stdin=stdin,
                                                   stdout=stdout, name="fake")
        return daemon.run_request_loop(handle, stdin=stdin, stdout=stdout, name="fake",
                                       commands=commands)

    return run_loop


KIND_SCRIPTS = {
    "fast": [("POST", "/v1/stylize", b"pixels!"), ("POST", "/v1/stylize?size=512", b"abc"),
             ("POST", "/v1/stylize", b"BOOM"), ("POST", "/v1/stylize?size=5%09x", b"x")],
    "multi": [("POST", "/v1/stylize", b"pixels"), ("POST", "/v1/stylize?style=2", b"abc"),
              ("POST", "/v1/stylize?style=0.2,0.3,0.5&size=64", b"xyz"),
              ("POST", "/v1/stylize?style=nan,1,0", b"n"),
              ("POST", "/v1/stylize?style=inf,1,0", b"i"),
              ("POST", "/v1/stylize?style=7", b"o")],
    "video": [("POST", "/v1/stylize?stream=cam7", b"f0"), ("POST", "/v1/stylize", b"f1"),
              ("POST", "/v1/stylize?stream=cam7&size=48", b"f2"),
              ("POST", "/reset?stream=cam7", b""), ("POST", "/reset", b""),
              ("POST", "/v1/stylize?stream=bad", b"f3")],
    "gatys": [("POST", "/v1/stylize", b"c"), ("POST", "/v1/stylize?style=s.png", b"content"),
              ("POST", "/v1/stylize?style=a.png,b.png:0.3,0.7", b"c2"),
              ("POST", "/v1/stylize?style=a.png,b.png:nan,1", b"c3")],
}
COMMON = [("GET", "/healthz", None), ("POST", "/reload", b""), ("POST", "/reset", b""),
          ("GET", "/nope", None), ("POST", "/nope", b"")]
# The serial fake answers STATS with FIXED_STATS; the batched loop answers it
# itself, with its own timings, so only the serial sessions ask for it.
STATS_ROUTES = [("GET", "/stats", None), ("GET", "/stats?format=json", None),
                ("GET", "/metrics", None)]


def _session(http, daemon, kind, batched):
    srv = _Server(http, _fake_loop(daemon, kind, batched), kind=kind)
    deadline = time.time() + TIMEOUT_S
    while srv.request("/healthz")[0] != 200 and time.time() < deadline:
        time.sleep(0.02)
    script = KIND_SCRIPTS[kind] + COMMON + ([] if batched else STATS_ROUTES)
    out = [srv.request(path, data=body, method=method) for method, path, body in script]
    out.append(srv.request("/shutdown", data=b"", method="POST"))
    srv.join()
    return out, srv.result


@pytest.mark.parametrize("batched", [False, True], ids=["serial", "batched"])
@pytest.mark.parametrize("kind", sorted(KIND_SCRIPTS))
def test_http_session_per_kind_matches_jax(kind, batched):
    runs = {pkg: _session(http, daemon, kind, batched)
            for pkg, (http, daemon) in PACKAGES.items()}
    assert runs["port"] == runs["jax"]
    responses, served = runs["port"]
    statuses = [r[0] for r in responses]
    assert 200 in statuses and 422 in statuses and statuses[-1] == 200
    ok = [r for r in responses if r[1].get("Content-Type") == "image/png"]
    assert ok and all(r[0] == 200 for r in ok)
    if kind == "gatys":
        assert all(r[1]["X-Final-Loss"] == "1.2345" for r in ok)
        assert responses[0][0] == 400 and b"style" in responses[0][2]
        assert ok[1][2] == b"2c|a.png,b.png:0.3,0.7"
    if kind == "multi":
        nonfinite = responses[3:5]
        assert all(r[0] == 422 and b"finite" in r[2] for r in nonfinite)
    if kind == "video":
        assert responses[0][2] == b"0f|cam7" and responses[1][2] == b"1f|0"
        assert [r[2] for r in responses[3:5]] == [b"RESET cam7\n", b"RESET\n"]
    if not batched:
        stats, stats_json, metrics = responses[-4:-1]
        assert stats[0] == 200 and stats[2] == FIXED_STATS[len("STATS "):].encode() + b"\n"
        assert json.loads(stats_json[2])["device_rtt_ms"] == 0.25
        assert metrics[0] == 200 and b"styletransfer_device_rtt_seconds" in metrics[2]


def test_metrics_carry_the_port_loops_device_rtt_gauge():
    """No fixed STATS here: the port's own loop answers it, with the probe of
    its serving device (the CPU), and /metrics exposes the gauge."""
    srv = _Server(thttp, _fake_loop(tdaemon, "fast", stats=False))
    status, _, body = srv.request("/v1/stylize", data=b"abc", method="POST")
    assert status == 200 and body == b"cba|"
    status, headers, body = srv.request("/metrics")
    assert status == 200 and headers["Content-Type"].startswith("text/plain; version=0.0.4")
    text = body.decode()
    assert 'styletransfer_requests_total{daemon="t",outcome="ok"} 1' in text
    assert 'styletransfer_device_rtt_seconds{daemon="t"} ' in text
    status, _, body = srv.request("/stats?format=json")
    assert json.loads(body)["ok"] == 1
    srv.request("/shutdown", data=b"", method="POST")
    srv.join()
    assert srv.result == 1


# --- The robustness cases of tests/test_httpserve.py on the port ---------------------

def test_healthz_waits_for_ready_and_shutdown_refuses_connections():
    gate = threading.Event()
    srv = _Server(thttp, _fake_loop(tdaemon, "fast", gate=gate))
    status, _, body = srv.request("/healthz")
    assert status == 503 and b"compiling" in body
    gate.set()
    deadline = time.time() + TIMEOUT_S
    while srv.request("/healthz")[0] != 200 and time.time() < deadline:
        time.sleep(0.02)
    assert "READY" in srv.stdout.getvalue().splitlines()
    assert srv.stdout.getvalue().startswith(f"HTTP 127.0.0.1 {srv.port}\n")
    srv.request("/shutdown", data=b"", method="POST")
    srv.join()
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/healthz", timeout=5)


def _recv_head(s):
    resp = b""
    while b"\r\n\r\n" not in resp:
        chunk = s.recv(4096)
        if not chunk:
            break
        resp += chunk
    return resp


def test_body_error_closes_keepalive_connection():
    """A 413 leaves the body unread: the gateway answers Connection: close
    and closes, so the stray bytes cannot poison the connection."""
    srv = _Server(thttp, _fake_loop(tdaemon, "fast"))
    try:
        with socket.create_connection(("127.0.0.1", srv.port), timeout=TIMEOUT_S) as s:
            s.settimeout(TIMEOUT_S)
            s.sendall(b"POST /v1/stylize HTTP/1.1\r\nHost: t\r\nContent-Length: 99999999999\r\n"
                      b"\r\nthese-body-bytes-would-poison-a-kept-alive-connection")
            head = _recv_head(s).split(b"\r\n\r\n", 1)[0].decode("latin-1").lower()
            assert " 413 " in head.splitlines()[0] and "connection: close" in head
            while s.recv(4096):
                pass  # the server closes after the response
    finally:
        srv.request("/shutdown", data=b"", method="POST")
        srv.join()


def test_no_body_post_routes_drain_keepalive_body():
    """/reload and unknown POST routes consume a declared body, so the same
    keep-alive connection answers the next request; a negative
    Content-Length answers 400."""
    srv = _Server(thttp, _fake_loop(tdaemon, "fast"))
    try:
        with socket.create_connection(("127.0.0.1", srv.port), timeout=TIMEOUT_S) as s:
            s.settimeout(TIMEOUT_S)

            def roundtrip(req):
                s.sendall(req)
                resp = _recv_head(s)
                assert b"\r\n\r\n" in resp, "connection closed unexpectedly"
                head, rest = resp.split(b"\r\n\r\n", 1)
                length = next(int(ln.split(b":")[1]) for ln in head.split(b"\r\n")
                              if ln.lower().startswith(b"content-length:"))
                while len(rest) < length:
                    rest += s.recv(4096)
                return head.splitlines()[0]

            assert b" 200 " in roundtrip(b"POST /reload HTTP/1.1\r\nHost: t\r\n"
                                         b"Content-Length: 5\r\n\r\nxxxxx")
            assert b" 200 " in roundtrip(b"GET /healthz HTTP/1.1\r\nHost: t\r\n\r\n")
            assert b" 404 " in roundtrip(b"POST /nope HTTP/1.1\r\nHost: t\r\n"
                                         b"Content-Length: 3\r\n\r\nabc")
            assert b" 200 " in roundtrip(b"GET /healthz HTTP/1.1\r\nHost: t\r\n\r\n")
        with socket.create_connection(("127.0.0.1", srv.port), timeout=TIMEOUT_S) as s:
            s.settimeout(TIMEOUT_S)
            s.sendall(b"POST /v1/stylize HTTP/1.1\r\nHost: t\r\nContent-Length: -1\r\n\r\n")
            assert b" 400 " in _recv_head(s).splitlines()[0]
    finally:
        srv.request("/shutdown", data=b"", method="POST")
        srv.join()


def test_spool_files_cleaned_up():
    tmp = tempfile.gettempdir()

    def spool_dirs():
        return {os.path.join(tmp, d) for d in os.listdir(tmp) if d.startswith("stx-torchspool-")}

    before = spool_dirs()
    srv = _Server(thttp, _fake_loop(tdaemon, "fast"), name="torchspool")
    assert srv.request("/v1/stylize", data=b"abc", method="POST")[0] == 200
    mine = spool_dirs() - before
    assert mine, "the spool directory was never created"
    deadline = time.time() + TIMEOUT_S
    while any(os.listdir(d) for d in mine) and time.time() < deadline:
        time.sleep(0.05)  # the handler cleans up after the client has the bytes
    assert not any(os.listdir(d) for d in mine)
    srv.request("/shutdown", data=b"", method="POST")
    srv.join()
    assert not any(os.path.isdir(d) for d in mine)


def test_batched_loop_routes_concurrent_requests():
    """Concurrent POSTs reach a batched loop, and each answer goes back to its
    own requester."""
    srv = _Server(thttp, _fake_loop(tdaemon, "fast", batched=True))
    barrier = threading.Barrier(4, timeout=TIMEOUT_S)
    results = {}

    def post(i):
        barrier.wait()
        results[i] = srv.request("/v1/stylize", data=f"payload-{i}".encode(), method="POST")

    threads = [threading.Thread(target=post, args=(i,), daemon=True) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT_S)
    assert sorted(results) == [0, 1, 2, 3]
    for i, (status, _, body) in results.items():
        assert status == 200 and body == f"payload-{i}".encode()[::-1] + b"|"
    srv.request("/shutdown", data=b"", method="POST")
    srv.join()
    assert srv.result == 4


def _answer_then_stop(daemon):
    """A loop whose one request's answer comes just before the daemon stops:
    the handler queues the shutdown sentinel itself."""
    def run_loop(stdin, stdout):
        def handle(in_path, out_path):
            with open(in_path, "rb") as f:
                data = f.read()
            with open(out_path, "wb") as f:
                f.write(data[::-1])
            stdin.mux.q.put((None, ""))
            return out_path

        print("READY", file=stdout, flush=True)
        return daemon.run_request_loop(handle, stdin=stdin, stdout=stdout, name="t")
    return run_loop


def test_shutdown_lets_an_answered_request_read_its_png(monkeypatch):
    """The engine answers a request and stops at once, while that request's
    handler thread is slow to read its PNG back from the spool (1 s): the
    gateway must not remove the spool under it. (JAX's gateway removes it
    once its server loop has stopped, about 0.5 s: the same request answers
    500 there.)"""
    real = thttp._HttpMux.submit

    def slow(self, line):
        out = real(self, line)
        time.sleep(1.0)
        return out

    monkeypatch.setattr(thttp._HttpMux, "submit", slow)
    srv = _Server(thttp, _answer_then_stop(tdaemon))
    status, headers, body = srv.request("/v1/stylize", data=b"abc", method="POST")
    srv.join()
    assert (status, body) == (200, b"cba") and headers["Content-Type"] == "image/png"
    assert srv.result == 1
