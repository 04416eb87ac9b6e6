"""HTTP/REST gateway for the warm-process serving daemons.

The port of ``styletransfer_tpu/engines/httpserve.py`` (standard library
only, so it is a copy). The same engine serve loops (``engines/daemon.py``),
untouched, behind a REST endpoint, so any HTTP client can reach a warm model
without speaking the line protocol or mounting the daemon's filesystem.

Like the TCP transport (``engines/netserve.py``), the gateway rides the one
invariant every serve loop pins: exactly one response line per consumed
request line, in consume order. Each HTTP request becomes one protocol line
tagged with a waiter; a stdin-shaped iterator feeds the lines to the engine
loop, and a stdout-shaped writer routes the k-th response line to the k-th
consumed line's waiter. Concurrent HTTP requests therefore dynamic-batch
across connections when the loop runs with ``-b N``. The gateway never
touches the device: the handler threads move lines and spool files, and
every CUDA call stays on the engine thread (the caller's).

Image bytes ride the request and response bodies; the gateway spools them
through per-request temp files because the engine protocol (and every
engine's host IO path) is path-based.

Endpoints (one surface for all four daemons; ``kind`` selects the line
shape):

- ``POST /v1/stylize``: body = image bytes (PNG/JPEG/...), response =
  stylized PNG. Query params: ``size`` (resolution bucket, bucketed
  daemons), ``style`` (serve-multi: hard index or comma blend weights;
  gatys: REQUIRED server-side style path or blend spec
  ``a.png,b.png:0.3,0.7``), ``stream`` (video: stream id, default 0).
  Requests the engine answers ``ERR`` map to 422 with the reason text.
- ``GET /healthz``: 200 once the engine printed ``READY``, 503 before.
- ``GET /stats``: the loop's in-band ``STATS`` summary; text by default,
  ``?format=json`` parses the ``k=v`` payload into JSON.
- ``GET /metrics``: the same summary in Prometheus text exposition format
  (with the device round-trip gauge when STATS carries ``device_rtt_ms``).
- ``POST /reload``: hot-swap the latest checkpoint (``RELOAD``).
- ``POST /reset[?stream=ID]``: video only: drop all carries, or one
  stream's.
- ``POST /shutdown``: stop the whole daemon (acks 200 first).

The daemon prints ``HTTP <host> <port>`` (the BOUND port: pass 0 to let the
OS pick) and then ``READY`` on its real stdout, so process supervisors keep
the same handshake as the pipe and TCP forms.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import queue
import shutil
import sys
import tempfile
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlsplit

from styletransfer_tpu_torch.engines import netserve
from styletransfer_tpu_torch.utils.logging import get_logger

# One help string shared by every serve CLI's --http option.
HTTP_HELP = (
    "Serve a REST gateway over the same warm engine instead of the line "
    "protocol: listen on [HOST:]PORT (port 0 = OS-assigned; the daemon "
    "prints 'HTTP <host> <port>' then 'READY' on stdout). POST /v1/stylize "
    "with image bytes as the body returns the stylized PNG (query params: "
    "size, style, stream per daemon); GET /healthz, GET /stats"
    "[?format=json], POST /reload, POST /reset (video), POST /shutdown. "
    "Concurrent requests dynamic-batch across connections with -b. "
    "Mutually exclusive with --tcp."
)

# Request bodies above this answer 413: a decoded 8k x 8k RGBA is about
# 256 MB of host RAM per in-flight request.
MAX_BODY_BYTES = 64 * 1024 * 1024

# At shutdown, how long requests that already have their answer may take to
# read their PNG back before the spool directory is removed.
SHUTDOWN_DRAIN_S = 30.0

_VALID_KINDS = ("fast", "multi", "video", "gatys")


class _Waiter:
    """One in-flight HTTP request's slot for its protocol response line."""

    __slots__ = ("event", "line")

    def __init__(self):
        self.event = threading.Event()
        self.line: Optional[str] = None


class _HttpMux:
    """Request queue and response FIFO shared by the HTTP handler threads
    (producers) and the engine loop's streams (consumer)."""

    def __init__(self, name: str):
        self.name = name
        self.logger = get_logger()
        # Bounded like the other transports: a flood of HTTP requests blocks
        # its handler threads here instead of buffering without bound.
        self.q: "queue.Queue" = queue.Queue(maxsize=1024)
        self.pending: "collections.deque[_Waiter]" = collections.deque()
        self.plock = threading.Lock()
        self.ready = threading.Event()
        self.closed = threading.Event()

    def submit(self, line: str) -> str:
        """Enqueue one protocol line; block until ITS response line.

        No gateway-side timeout: a Gatys request legitimately runs for
        minutes, and HTTP clients own their read timeouts. The one hang this
        must not allow, the engine loop exiting with the response still owed,
        is broken by the ``closed`` flag."""
        if self.closed.is_set():
            raise RuntimeError("daemon is shutting down")
        w = _Waiter()
        # A bounded put WITH a closed check: once the engine loop exits,
        # nothing drains ``q``, and a plain blocking put on a full queue would
        # strand this handler thread (and its client) for good.
        while True:
            if self.closed.is_set():
                raise RuntimeError("daemon is shutting down")
            try:
                self.q.put((w, line), timeout=0.5)
                break
            except queue.Full:
                continue
        while True:
            if w.event.wait(0.5):
                break
            if self.closed.is_set():
                # The response may have raced the close; one last look.
                if w.event.wait(0.1):
                    break
                raise RuntimeError("daemon shut down before responding")
        if w.line is None:
            # close() wakes pending waiters without a response line (the loop
            # died mid-request): that is the 503 path.
            raise RuntimeError("daemon shut down before responding")
        return w.line

    def close(self) -> None:
        """The engine loop is gone: wake every still-blocked submitter."""
        self.closed.set()
        with self.plock:
            waiters = list(self.pending)
            self.pending.clear()
        for w in waiters:
            w.event.set()  # w.line stays None -> submit() raises


class _HttpStdin:
    """stdin-shaped iterator over the gateway's queued protocol lines. The
    ``(None, "")`` sentinel, queued by ``POST /shutdown``, yields a blank
    line: every engine loop's shutdown condition."""

    def __init__(self, mux: _HttpMux):
        self.mux = mux

    def __iter__(self):
        return self

    def __next__(self) -> str:
        waiter, line = self.mux.q.get()
        if waiter is None:
            return "\n"
        with self.mux.plock:
            self.mux.pending.append(waiter)
        return line + "\n"


class _HttpStdout:
    """stdout-shaped writer routing each response line to its waiter.

    Engine loops write through ``print`` (text and newline may be separate
    ``write`` calls; the batched loop defers ``flush``), so lines are
    reassembled here. Lines with no waiter owed (``READY``) go to the
    daemon's real stdout; ``READY`` also opens /healthz."""

    def __init__(self, mux: _HttpMux, real_stdout):
        self.mux = mux
        self.real = real_stdout
        self._buf = ""

    def write(self, s: str) -> int:
        self._buf += s
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self._emit(line)
        return len(s)

    def flush(self) -> None:  # responses dispatch per line in write()
        pass

    def _emit(self, line: str) -> None:
        with self.mux.plock:
            waiter = self.mux.pending.popleft() if self.mux.pending else None
        if waiter is None:
            # Open /healthz BEFORE the stdout banner: a supervisor that reacts
            # to READY on stdout must not then see a 503.
            if line == "READY":
                self.mux.ready.set()
            print(line, file=self.real, flush=True)
            return
        waiter.line = line
        waiter.event.set()


class _BadRequest(ValueError):
    """A client error the handler answers 400 before touching the engine."""


class _Handled(Exception):
    """Flow control: the handler already sent a response."""


def _param(params: dict, key: str) -> str:
    vals = params.get(key) or [""]
    val = vals[0].strip()
    # A tab or newline inside a query value would smuggle extra protocol
    # fields or lines into the engine: reject rather than sanitize.
    if any(c in val for c in "\t\n\r"):
        raise _BadRequest(f"query param {key!r} must not contain tabs/newlines")
    return val


def build_request_line(kind: str, in_path: str, out_path: str, params: dict) -> str:
    """One HTTP request's protocol line, per daemon kind:

    - fast  = INPUT\\tOUTPUT[\\tSIZE]
    - multi = INPUT\\tOUTPUT\\tSTYLE[\\tSIZE]
    - video = FRAME\\tOUTPUT\\tSTREAM[\\tSIZE]
    - gatys = CONTENT\\tSTYLE\\tOUTPUT

    Blend weights are checked by the engine's style parser (NaN, inf and
    negative weights answer ERR, hence 422), as on the other transports."""
    size = _param(params, "size")
    style = _param(params, "style")
    stream = _param(params, "stream")
    if kind == "fast":
        fields = [in_path, out_path] + ([size] if size else [])
    elif kind == "multi":
        fields = [in_path, out_path, style or "0"] + ([size] if size else [])
    elif kind == "video":
        fields = [in_path, out_path, stream or "0"] + ([size] if size else [])
    elif kind == "gatys":
        if not style:
            raise _BadRequest("gatys needs ?style=<server-side style path or blend spec>")
        fields = [in_path, style, out_path]
    else:  # pragma: no cover - guarded at construction
        raise ValueError(f"unknown daemon kind {kind!r}")
    return "\t".join(fields)


def _parse_stats(payload: str) -> dict:
    """``ok=12 err=1 p50_ms=4.2 latency=group-amortized`` -> typed dict."""
    out: dict = {}
    for tok in payload.split():
        if "=" not in tok:
            continue
        k, v = tok.split("=", 1)
        try:
            out[k] = int(v)
        except ValueError:
            try:
                out[k] = float(v)
            except ValueError:
                out[k] = v
    return out


def _summary(stats: dict, esc: str, metric: str, prefix: str, mean_key: str,
             help_text: str) -> list:
    """One Prometheus summary from the ``{prefix}NN_ms`` reservoir
    percentiles (quantile labels, ms -> s) and ``mean_key`` (sum = mean x
    count, count = ok + err)."""
    quantiles = [(k, v) for k, v in stats.items()
                 if k.startswith(prefix) and k.endswith("_ms")
                 and isinstance(v, (int, float))]
    mean = stats.get(mean_key)
    if not quantiles and not isinstance(mean, (int, float)):
        return []
    lines = [f"# HELP {metric} {help_text}", f"# TYPE {metric} summary"]
    for k, v in quantiles:
        q = float(k[len(prefix):-3]) / 100.0
        lines.append(f'{metric}{{daemon="{esc}",quantile="{q:g}"}} {v / 1e3:.6f}')
    if isinstance(mean, (int, float)):
        n = stats.get("ok", 0) + stats.get("err", 0)
        lines += [f'{metric}_sum{{daemon="{esc}"}} {mean / 1e3 * n:.6f}',
                  f'{metric}_count{{daemon="{esc}"}} {n}']
    return lines


def _stats_to_prometheus(payload: str, name: str) -> str:
    """The STATS summary in Prometheus text exposition format.

    Counters map directly; the pXX_ms reservoir percentiles become a summary
    metric with quantile labels (values converted ms -> seconds), and so do
    the batched loop's group-amortized ``amort_pXX_ms``; the mean batch fill
    and ``device_rtt_ms`` become gauges. Non-numeric fields (e.g.
    ``latency=enqueue-to-reply``) are left out."""
    stats = _parse_stats(payload)
    esc = name.replace("\\", "\\\\").replace('"', '\\"')
    lines = [
        "# HELP styletransfer_requests_total Requests served, by outcome.",
        "# TYPE styletransfer_requests_total counter",
        f'styletransfer_requests_total{{daemon="{esc}",outcome="ok"}} {stats.get("ok", 0)}',
        f'styletransfer_requests_total{{daemon="{esc}",outcome="err"}} {stats.get("err", 0)}',
    ]
    lines += _summary(stats, esc, "styletransfer_request_seconds", "p", "mean_ms",
                      "Request latency (reservoir percentiles; enqueue-to-reply in "
                      "batched mode).")
    lines += _summary(stats, esc, "styletransfer_request_amortized_seconds", "amort_p",
                      "amort_mean_ms",
                      "Group-amortized per-request cost (group elapsed / group size).")
    if isinstance(stats.get("mean_batch_fill"), (int, float)):
        lines += [
            "# HELP styletransfer_batch_fill_mean Mean dynamic-batch group size.",
            "# TYPE styletransfer_batch_fill_mean gauge",
            f'styletransfer_batch_fill_mean{{daemon="{esc}"}} {stats["mean_batch_fill"]}',
        ]
    if isinstance(stats.get("device_rtt_ms"), (int, float)):
        lines += [
            "# HELP styletransfer_device_rtt_seconds One-element device dispatch "
            "round-trip at poll time (transport attribution).",
            "# TYPE styletransfer_device_rtt_seconds gauge",
            f'styletransfer_device_rtt_seconds{{daemon="{esc}"}} '
            f"{stats['device_rtt_ms'] / 1e3:.6f}",
        ]
    return "\n".join(lines) + "\n"


def _stats_to_json(payload: str) -> str:
    """``ok=12 err=1 p50_ms=4.2 latency=group-amortized`` -> JSON."""
    return json.dumps(_parse_stats(payload))


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    @property
    def gw(self):
        return self.server.gateway  # type: ignore[attr-defined]

    def log_message(self, fmt, *args):  # route access logs to our logger
        self.gw.logger.info("%s http %s: " + fmt, self.gw.name, self.client_address[0], *args)

    # -- plumbing -------------------------------------------------------------

    def _reply(self, status: int, body: bytes, content_type: str = "text/plain; charset=utf-8",
               headers: Optional[dict] = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _reply_text(self, status: int, text: str, **kw) -> None:
        self._reply(status, (text.rstrip("\n") + "\n").encode("utf-8"), **kw)

    def _submit(self, line: str) -> str:
        try:
            return self.gw.mux.submit(line)
        except RuntimeError as exc:
            self._reply_text(503, str(exc))
            raise _Handled()

    def _read_body(self) -> bytes:
        # Every error reply here leaves the request body UNREAD on the
        # socket; on a keep-alive connection those bytes would be parsed as
        # the next request line. Close the connection instead:
        # send_header("Connection", "close") also sets close_connection.
        close = {"Connection": "close"}
        length_s = self.headers.get("Content-Length")
        if length_s is None:
            self._reply_text(411, "Content-Length required", headers=close)
            raise _Handled()
        try:
            length = int(length_s)
        except ValueError:
            self._reply_text(400, f"bad Content-Length {length_s!r}", headers=close)
            raise _Handled()
        if length < 0:
            # rfile.read(-1) would read until EOF, which never comes on a
            # held-open keep-alive connection.
            self._reply_text(400, f"negative Content-Length {length}", headers=close)
            raise _Handled()
        if length > MAX_BODY_BYTES:
            self._reply_text(413, f"body of {length} bytes exceeds {MAX_BODY_BYTES}",
                             headers=close)
            raise _Handled()
        return self.rfile.read(length)

    def _discard_body(self) -> None:
        """Consume (and ignore) a declared request body.

        POST routes that do not use the body (/reload, /reset, /shutdown,
        unknown routes) must still drain it, or its bytes are parsed as the
        next request line of a keep-alive connection. An invalid or
        oversized declaration closes the connection instead."""
        length_s = self.headers.get("Content-Length")
        if length_s in (None, "0"):
            return
        try:
            length = int(length_s)
        except ValueError:
            self.close_connection = True
            return
        if 0 < length <= MAX_BODY_BYTES:
            self.rfile.read(length)
        elif length != 0:
            self.close_connection = True

    def _failed(self, method: str, exc: Exception) -> None:
        self.gw.logger.warning("%s http: %s %s failed (%s)", self.gw.name, method, self.path,
                               exc)
        try:
            self._reply_text(500, f"internal error: {exc}")
        except OSError:
            pass

    # -- routes ---------------------------------------------------------------

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler contract
        try:
            url = urlsplit(self.path)
            if url.path == "/healthz":
                if self.gw.mux.ready.is_set():
                    self._reply_text(200, "ok")
                else:
                    self._reply_text(503, "compiling")
                return
            if url.path in ("/stats", "/metrics"):
                resp = self._submit("STATS")
                if not resp.startswith("OK STATS"):
                    self._reply_text(502, resp)
                    return
                payload = resp[len("OK STATS"):].strip()
                if url.path == "/metrics":
                    self._reply(200, _stats_to_prometheus(payload, self.gw.name).encode("utf-8"),
                                content_type="text/plain; version=0.0.4; charset=utf-8")
                elif _param(parse_qs(url.query), "format") == "json":
                    self._reply(200, _stats_to_json(payload).encode("utf-8"),
                                content_type="application/json")
                else:
                    self._reply_text(200, payload)
                return
            self._reply_text(404, f"no route GET {url.path}")
        except _Handled:
            pass
        except _BadRequest as exc:
            self._reply_text(400, str(exc))
        except Exception as exc:  # noqa: BLE001 - a request must not kill us
            self._failed("GET", exc)

    def do_POST(self):  # noqa: N802
        try:
            url = urlsplit(self.path)
            params = parse_qs(url.query)
            if url.path == "/v1/stylize":
                self._stylize(params)
            elif url.path == "/reload":
                self._discard_body()
                self._command("RELOAD")
            elif url.path == "/reset":
                self._discard_body()
                if self.gw.kind != "video":
                    self._reply_text(404, "POST /reset is only for video daemons")
                    return
                stream = _param(params, "stream")
                self._command(f"RESET\t\t{stream}" if stream else "RESET")
            elif url.path == "/shutdown":
                self._discard_body()
                # Ack first: once the sentinel lands the loop may exit and
                # close the transport before this response flushes.
                self._reply_text(200, "shutting down")
                self._enqueue_shutdown()
            else:
                self._discard_body()
                self._reply_text(404, f"no route POST {url.path}")
        except _Handled:
            pass
        except _BadRequest as exc:
            self._reply_text(400, str(exc))
        except Exception as exc:  # noqa: BLE001
            self._failed("POST", exc)

    def _enqueue_shutdown(self) -> None:
        """Queue the engine loop's shutdown sentinel without ever blocking the
        handler for good: on a full queue, retry until it fits or the loop is
        already gone."""
        while not self.gw.mux.closed.is_set():
            try:
                self.gw.mux.q.put((None, ""), timeout=0.5)
                return
            except queue.Full:
                continue

    def _command(self, line: str) -> None:
        resp = self._submit(line)
        if resp.startswith("OK "):
            self._reply_text(200, resp[3:])
        else:
            self._reply_text(409, resp[4:] if resp.startswith("ERR ") else resp)

    def _stylize(self, params: dict) -> None:
        with self.gw.stylizing():
            self._stylize_spooled(params)

    def _stylize_spooled(self, params: dict) -> None:
        body = self._read_body()
        tag = uuid.uuid4().hex
        in_path = os.path.join(self.gw.spool_dir, f"in-{tag}")
        out_path = os.path.join(self.gw.spool_dir, f"out-{tag}.png")
        line = build_request_line(self.gw.kind, in_path, out_path, params)
        try:
            with open(in_path, "wb") as f:
                f.write(body)
            resp = self._submit(line)
            if resp.startswith("OK "):
                with open(out_path, "rb") as f:
                    png = f.read()
                headers = {}
                # The gatys payload carries the final loss after the path.
                if " loss=" in resp:
                    headers["X-Final-Loss"] = resp.rsplit("loss=", 1)[1]
                self._reply(200, png, content_type="image/png", headers=headers)
            else:
                reason = resp.split(": ", 1)[1] if ": " in resp else resp
                self._reply_text(422, reason)
        finally:
            for p in (in_path, out_path):
                try:
                    os.unlink(p)
                except OSError:
                    pass


class _Gateway:
    def __init__(self, mux: _HttpMux, kind: str, spool_dir: str, name: str):
        self.mux = mux
        self.kind = kind
        self.spool_dir = spool_dir
        self.name = name
        self.logger = mux.logger
        self._inflight = 0
        self._idle = threading.Condition()

    @contextlib.contextmanager
    def stylizing(self):
        """Count a /v1/stylize request while it uses the spool."""
        with self._idle:
            self._inflight += 1
        try:
            yield
        finally:
            with self._idle:
                self._inflight -= 1
                self._idle.notify_all()

    def wait_idle(self, timeout: float) -> None:
        """At shutdown: let requests that already have their answer read their
        PNG back (the engine loop has ended; the rest are woken with 503)
        before the spool directory is removed."""
        with self._idle:
            self._idle.wait_for(lambda: self._inflight == 0, timeout)


def serve_over_http(
    run_loop: Callable[..., int],
    host: str = "127.0.0.1",
    port: int = 0,
    kind: str = "fast",
    stdout=None,
    name: str = "http-serve",
    _on_listen: Optional[Callable[[int], None]] = None,
) -> int:
    """Run any engine serve loop behind an HTTP gateway.

    ``run_loop(stdin, stdout) -> int`` is a closure over one of the engine
    serve loops; it runs on this thread and its return value (requests
    served) is passed through. Prints ``HTTP <host> <port>`` on the daemon's
    real stdout as soon as the socket is bound, BEFORE the engine warms up,
    so clients can connect early; their requests queue until the engine
    prints ``READY``. ``_on_listen`` (tests) receives the bound port."""
    if kind not in _VALID_KINDS:
        raise ValueError(f"unknown daemon kind {kind!r}; one of {_VALID_KINDS}")
    logger = get_logger()
    real = stdout if stdout is not None else sys.stdout

    mux = _HttpMux(name)
    spool_dir = tempfile.mkdtemp(prefix=f"stx-{name.replace('/', '_')}-")
    httpd = ThreadingHTTPServer((host, port), _Handler)
    httpd.daemon_threads = True
    gateway = _Gateway(mux, kind, spool_dir, name)
    httpd.gateway = gateway  # type: ignore[attr-defined]
    bound = httpd.server_address[1]
    print(f"HTTP {host} {bound}", file=real, flush=True)
    logger.info("%s: HTTP gateway on %s:%d (kind=%s)", name, host, bound, kind)
    if _on_listen is not None:
        _on_listen(bound)

    server_thread = threading.Thread(target=httpd.serve_forever, daemon=True,
                                     name=f"{name}-httpd")
    server_thread.start()
    try:
        n = run_loop(_HttpStdin(mux), _HttpStdout(mux, real))
    finally:
        mux.close()
        gateway.wait_idle(SHUTDOWN_DRAIN_S)
        httpd.shutdown()
        httpd.server_close()
        shutil.rmtree(spool_dir, ignore_errors=True)
        logger.info("%s: HTTP gateway closed", name)
    return n


def serve_transport(run_loop: Callable[..., int], tcp: Optional[str], http: Optional[str],
                    kind: str, name: str) -> int:
    """CLI glue: pick the serving transport (pipes, ``--tcp`` or ``--http``).

    Raises ValueError (CLIs wrap it in a UsageError) on conflicting flags or
    a malformed ``[HOST:]PORT``, before any serving state is built."""
    if tcp is not None and http is not None:
        raise ValueError("--tcp and --http are mutually exclusive")
    if http is not None:
        host, port = netserve.parse_hostport(http, flag="--http")
        return serve_over_http(run_loop, host=host, port=port, kind=kind, name=f"{name}-http")
    return netserve.maybe_serve_tcp(run_loop, tcp, f"{name}-tcp")
