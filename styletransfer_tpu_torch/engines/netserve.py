"""TCP transport for the warm-process serving daemons.

The port of ``styletransfer_tpu/engines/netserve.py`` (standard library
only, so it is a copy: the port imports nothing of the JAX package). The
daemons (``fast_st serve``, ``fast_st serve-multi``, ``video_st serve``,
``gatys_st --serve``) speak a line protocol on stdin/stdout, and every serve
loop takes those two streams as parameters (``engines/daemon.py``). This
module puts the SAME loops behind a TCP listener: N concurrent clients, each
speaking the unchanged line protocol on its own connection, are multiplexed
into the one warm engine process. Cross-client dynamic batching then falls
out of the loops' cross-line batching: ``-b 8`` groups whatever requests
have arrived across ALL connections into one device call.

Design, one queue in and FIFO routing out:

- a reader thread per client pushes ``(client, line)`` into one queue; the
  engine loop consumes lines through a stdin-shaped iterator
  (``_MuxStdin``) that records, per consumed line, which client sent it;
- every engine loop answers EXACTLY one response line per consumed request
  line, in consume order (``engines/daemon.py`` pins this contract), so the
  stdout-shaped ``_DemuxStdout`` routes the k-th response line to the
  sender of the k-th consumed request;
- lines the engine emits with NO request outstanding (``READY``) are
  broadcast: to the daemon's real stdout and to every connected client.
  Clients that connect after the engine is ready are greeted with
  ``READY`` on accept, so the handshake is connection-local.

Only the engine thread (the caller's, which runs the serve loop) touches the
device; the reader, writer and acceptor threads move lines.

Per-connection protocol deltas against the pipe form:

- a blank line closes THAT connection only (on a pipe it shuts the daemon
  down; a multi-client daemon must survive one client leaving). The
  goodbye is graceful: responses the engine still owes the connection are
  delivered first, then the socket closes;
- ``SHUTDOWN`` stops the whole daemon; its ``OK SHUTDOWN`` ack is sent
  AFTER the sender's owed responses (count-pairing order preserved);
- an abrupt disconnect (EOF or reset without goodbye) is absorbed:
  in-flight responses for the vanished client are dropped with a warning,
  everyone else keeps being served.

The daemon prints ``TCP <host> <port>`` (the BOUND port: pass 0 to let the
OS pick) and ``READY`` on its real stdout, so process supervisors keep
their handshake.
"""

from __future__ import annotations

import collections
import queue
import socket
import sys
import threading
import time
from typing import Callable, Optional, Tuple

from styletransfer_tpu_torch.utils.logging import get_logger

# One help string shared by every serve CLI's --tcp option, so the four
# daemons document the same transport contract.
TCP_HELP = (
    "Serve the same line protocol over TCP instead of stdin/stdout: "
    "listen on [HOST:]PORT (port 0 = OS-assigned; the daemon prints "
    "'TCP <host> <port>' then 'READY' on stdout), accept any number of "
    "concurrent clients, and dynamic-batch across them (-b). Per "
    "connection: a blank line closes that connection; SHUTDOWN stops "
    "the whole daemon."
)


def maybe_serve_tcp(run_loop: Callable[..., int], tcp: Optional[str], name: str) -> int:
    """CLI glue: run an engine serve loop over TCP when ``--tcp`` was given,
    else directly on the process pipes. ``run_loop(stdin, stdout)`` must pass
    the streams through to the engine loop (None = pipes). Raises ValueError
    on a malformed ``[HOST:]PORT`` before any serving state is built (CLIs
    wrap it in a UsageError)."""
    if tcp is None:
        return run_loop(None, None)
    host, port = parse_hostport(tcp)
    return serve_over_tcp(run_loop, host=host, port=port, name=name)


def parse_hostport(spec: str, flag: str = "--tcp") -> Tuple[str, int]:
    """Parse a ``[HOST:]PORT`` value (port 0 = OS picks). ``flag`` names the
    CLI option in error text: this parser serves both ``--tcp`` and
    ``--http``, and a usage error must blame the flag the user typed."""
    host, sep, port_s = spec.rpartition(":")
    if not sep:
        host, port_s = "127.0.0.1", spec
    try:
        port = int(port_s)
    except ValueError:
        raise ValueError(f"invalid {flag} PORT {port_s!r} (in {spec!r})")
    if not 0 <= port <= 65535:
        raise ValueError(f"{flag} port out of range: {port}")
    return host or "127.0.0.1", port


class _Client:
    """One accepted connection: a per-client WRITER THREAD the demux can
    target without ever blocking (a client that stops reading its socket
    must not stall the engine thread, and with it every other client), plus
    the in-flight accounting that makes goodbyes graceful: a blank line or
    SHUTDOWN must not cut off responses the engine still owes this
    connection."""

    # A single client may have at most this many enqueued-but-unanswered
    # lines; its reader then blocks (pressure rides its TCP window). This
    # bounds how far one flooding client can queue ahead of others in the
    # shared FIFO.
    MAX_INFLIGHT = 256
    # Outbound: responses queue here and a dedicated writer thread drains
    # them into the socket (``sendall`` can block indefinitely on a client
    # that reads nothing; on the engine thread that would stall every
    # connection). Enqueueing never blocks: when the queue has held
    # SEND_QUEUE lines or more for SEND_TIMEOUT_S, the next line declares
    # the client dead and drops it. Its backlog past SEND_QUEUE is bounded by
    # MAX_INFLIGHT (one line per request it sent).
    SEND_QUEUE = 256
    SEND_TIMEOUT_S = 20.0

    _CLOSE = object()  # writer-thread sentinel: drain, then close the socket

    def __init__(self, conn: socket.socket, addr, ident: int):
        self.conn = conn
        self.addr = addr
        self.ident = ident
        self.wlock = threading.Lock()
        self.alive = True
        self.greeted = False  # exactly-once READY; guarded by mux.clock
        self._cond = threading.Condition()
        self._outstanding = 0
        self._closing = False
        self._finished = False
        self._deferred: list = []
        # The send queue, its condition, and when it first held SEND_QUEUE
        # lines (None while it holds fewer).
        self._sendq: "collections.deque" = collections.deque()
        self._send_cond = threading.Condition()
        self._full_since: Optional[float] = None
        self._logger = get_logger()
        self._writer = threading.Thread(target=self._write_loop, daemon=True,
                                        name=f"tcp-writer-{ident}")
        self._writer.start()

    def _put_nowait(self, item) -> bool:
        """Append ``item`` to the send queue without waiting; False once the
        queue has stayed full for SEND_TIMEOUT_S."""
        with self._send_cond:
            if len(self._sendq) >= self.SEND_QUEUE:
                now = time.monotonic()
                if self._full_since is None:
                    self._full_since = now
                elif now - self._full_since >= self.SEND_TIMEOUT_S:
                    return False
            self._sendq.append(item)
            self._send_cond.notify()
            return True

    def send_line(self, line: str) -> bool:
        """Enqueue one response line for delivery; never blocks. False: the
        client is gone, or was just declared dead for reading nothing while
        its queue stayed full for SEND_TIMEOUT_S. (The JAX ``send_line``
        waits up to SEND_TIMEOUT_S on a full queue, holding up the engine
        thread and with it every other client.)"""
        if not self.alive:
            return False
        if self._put_nowait(line):
            return True
        self._logger.warning("client %s read nothing for %.0fs with a full send queue; "
                             "dropping it", self.addr, self.SEND_TIMEOUT_S)
        self.close()
        return False

    def _write_loop(self) -> None:
        while True:
            with self._send_cond:
                while not self._sendq:
                    self._send_cond.wait()
                item = self._sendq.popleft()
                if len(self._sendq) < self.SEND_QUEUE:
                    self._full_since = None
            if item is self._CLOSE:
                break
            try:
                self.conn.sendall((item + "\n").encode("utf-8"))
            except OSError:
                break  # peer gone, or close() shut the socket under us
        self._close_socket()

    def begin_request(self) -> None:
        """Reader thread: account one enqueued line (blocks at the cap)."""
        with self._cond:
            while self._outstanding >= self.MAX_INFLIGHT and self.alive:
                self._cond.wait(timeout=1.0)
            self._outstanding += 1

    def end_request(self) -> None:
        """Demux: one owed response was sent (or dropped)."""
        with self._cond:
            self._outstanding -= 1
            self._cond.notify_all()
            finish = self._should_finish()
        if finish:
            self._finish()

    def request_close(self, deferred_line: Optional[str] = None) -> None:
        """Reader thread: graceful goodbye or SHUTDOWN. Close once every owed
        response has been delivered; ``deferred_line`` (the SHUTDOWN ack) is
        sent last, after them, keeping the count-pairing order."""
        with self._cond:
            self._closing = True
            if deferred_line is not None:
                self._deferred.append(deferred_line)
            finish = self._should_finish()
        if finish:
            self._finish()

    def _should_finish(self) -> bool:
        # Call with self._cond held. One winner closes the socket.
        if self._closing and self._outstanding <= 0 and not self._finished:
            self._finished = True
            return True
        return False

    def _finish(self) -> None:
        # The deferred ack and the sentinel ride the send queue BEHIND the
        # owed responses, so the writer thread closes the socket only after
        # everything queued has been delivered.
        for line in self._deferred:
            self.send_line(line)
        self._deferred = []
        if not self._put_nowait(self._CLOSE):
            self.close()  # not reading: an abrupt close is all that is left

    def writing(self) -> bool:
        return self._writer.is_alive()

    def close_at_exit(self, deadline: float) -> None:
        """At daemon exit: a client whose goodbye or SHUTDOWN is under way (its
        writer closes the socket after the last queued line) gets until
        ``deadline`` (``time.monotonic()``) to receive what it is owed; any
        other is closed now. Writers are daemon threads: without this wait
        the process can end before the SHUTDOWN ack has left."""
        with self._cond:
            finished = self._finished
        if finished:
            self._writer.join(max(0.0, deadline - time.monotonic()))
        self.close()

    def close(self) -> None:
        """Abrupt close: shut the socket NOW (a writer blocked in sendall
        errors out and exits through _close_socket)."""
        self._close_socket()
        with self._send_cond:  # wake an idle writer; one mid-send errors out
            self._sendq.append(self._CLOSE)
            self._send_cond.notify()

    def _close_socket(self) -> None:
        with self.wlock:
            self.alive = False
            try:
                self.conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self.conn.close()
            except OSError:
                pass
        with self._cond:
            self._cond.notify_all()  # unblock a reader waiting at the cap


class _Mux:
    """Shared transport state: the request queue, the FIFO of clients whose
    responses are still owed, and the live-connection set."""

    def __init__(self, name: str):
        self.name = name
        self.logger = get_logger()
        # One shared, bounded FIFO: the engine consumes in arrival order, as
        # from piped stdin. A flooding client's lead is capped twice: its
        # in-flight lines (_Client.MAX_INFLIGHT) and this bound; then
        # readers block and the pressure rides each sender's TCP window.
        self.q: "queue.Queue" = queue.Queue(maxsize=1024)
        self.pending: "collections.deque[_Client]" = collections.deque()
        self.plock = threading.Lock()
        self.clients: set = set()
        # Clients that said goodbye or SHUTDOWN and may still be writing.
        self.leaving: set = set()
        self.clock = threading.Lock()
        self.ready = threading.Event()

    def add_client(self, client: _Client) -> None:
        # ``greeted`` flips under clock in BOTH greeting paths (here and the
        # demux READY broadcast), so a client connecting while the engine
        # prints READY gets exactly one: a duplicate would shift a
        # count-pairing client's whole response stream by one.
        with self.clock:
            self.clients.add(client)
            greet = self.ready.is_set() and not client.greeted
            if greet:
                client.greeted = True
        if greet:
            client.send_line("READY")

    def drop_client(self, client: _Client) -> None:
        client.close()
        with self.clock:
            self.clients.discard(client)


class _MuxStdin:
    """stdin-shaped iterator over all clients' request lines.

    Yields each line (newline-terminated, like file iteration) and records
    its sender in the FIFO that ``_DemuxStdout`` routes responses from. The
    ``(None, "")`` sentinel, queued on SHUTDOWN, yields a blank line: every
    engine loop's shutdown condition."""

    def __init__(self, mux: _Mux):
        self.mux = mux

    def __iter__(self):
        return self

    def __next__(self) -> str:
        client, line = self.mux.q.get()
        if client is None:
            return "\n"
        with self.mux.plock:
            self.mux.pending.append(client)
        return line + "\n"


class _DemuxStdout:
    """stdout-shaped writer routing each complete line to its requester.

    The engine loops write through ``print(..., file=stdout)``: text and
    newline may arrive as separate ``write`` calls (and the batched loop
    defers ``flush``), so lines are reassembled here and dispatched one at a
    time, to the next pending client, or broadcast when none is owed."""

    def __init__(self, mux: _Mux, real_stdout):
        self.mux = mux
        self.real = real_stdout
        self._buf = ""

    def write(self, s: str) -> int:
        self._buf += s
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self._emit(line)
        return len(s)

    def flush(self) -> None:  # per-line sends are already unbuffered
        pass

    def _emit(self, line: str) -> None:
        with self.mux.plock:
            client = self.mux.pending.popleft() if self.mux.pending else None
        if client is None:
            print(line, file=self.real, flush=True)
            with self.mux.clock:
                if line == "READY":
                    self.mux.ready.set()
                    targets = [c for c in self.mux.clients if not c.greeted]
                    for c in targets:
                        c.greeted = True
                else:
                    targets = list(self.mux.clients)
            for c in targets:
                c.send_line(line)
            return
        if not client.send_line(line):
            self.mux.logger.warning("%s: client %s vanished; dropped response %r",
                                    self.mux.name, client.addr, line[:80])
        client.end_request()


def _client_reader(mux: _Mux, client: _Client) -> None:
    """Per-connection reader: request lines in, connection control out.

    Goodbye (blank line) and SHUTDOWN are graceful: the connection stays
    open until every response the engine owes this client has been
    delivered (request_close); only an abrupt EOF or error closes it on the
    spot, since the peer is gone."""
    graceful = False
    try:
        f = client.conn.makefile("r", encoding="utf-8", errors="replace")
        for raw in f:
            line = raw.rstrip("\n")
            if not line.strip():
                graceful = True
                client.request_close()
                break
            if line.strip() == "SHUTDOWN":
                graceful = True
                client.request_close("OK SHUTDOWN")
                mux.q.put((None, ""))  # the engine loop's shutdown condition
                break
            client.begin_request()  # blocks at the per-client cap
            mux.q.put((client, line))
    except Exception as exc:  # noqa: BLE001 - a broken client must not kill us
        mux.logger.warning("%s: reader for %s failed (%s)", mux.name, client.addr, exc)
    finally:
        if graceful:
            # No more broadcasts for a leaving client; the socket itself
            # closes in _Client._finish once the owed responses drain.
            with mux.clock:
                mux.clients.discard(client)
                mux.leaving = {c for c in mux.leaving if c.writing()}
                mux.leaving.add(client)
        else:
            mux.drop_client(client)


def _acceptor(mux: _Mux, listener: socket.socket) -> None:
    ident = 0
    while True:
        try:
            conn, addr = listener.accept()
        except OSError:
            return  # listener closed: the daemon is shutting down
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        client = _Client(conn, addr, ident)
        ident += 1
        mux.add_client(client)
        mux.logger.info("%s: client %s connected", mux.name, addr)
        threading.Thread(target=_client_reader, args=(mux, client), daemon=True,
                         name=f"{mux.name}-client-{client.ident}").start()


def serve_over_tcp(
    run_loop: Callable[..., int],
    host: str = "127.0.0.1",
    port: int = 0,
    stdout=None,
    name: str = "tcp-serve",
    _on_listen: Optional[Callable[[int], None]] = None,
) -> int:
    """Run any engine serve loop behind a TCP listener.

    ``run_loop(stdin, stdout) -> int`` is a closure over one of the engine
    serve loops (they all take injectable streams); it is called exactly
    once, on this thread, with the transport's multiplexed streams, and its
    return value (requests served) is passed through.

    Prints ``TCP <host> <port>`` on the daemon's real stdout as soon as the
    socket is bound, BEFORE the engine warms up, so clients can connect
    early; their requests queue until the engine prints ``READY`` and starts
    consuming. ``_on_listen`` (tests) receives the bound port."""
    logger = get_logger()
    real = stdout if stdout is not None else sys.stdout

    listener = socket.create_server((host, port), backlog=64)
    bound = listener.getsockname()[1]
    print(f"TCP {host} {bound}", file=real, flush=True)
    logger.info("%s: listening on %s:%d", name, host, bound)
    if _on_listen is not None:
        _on_listen(bound)

    mux = _Mux(name)
    threading.Thread(target=_acceptor, args=(mux, listener), daemon=True,
                     name=f"{name}-acceptor").start()
    try:
        n = run_loop(_MuxStdin(mux), _DemuxStdout(mux, real))
    finally:
        try:
            listener.close()
        except OSError:
            pass
        with mux.clock:
            clients = list(mux.clients)
            leaving = list(mux.leaving - mux.clients)
        deadline = time.monotonic() + _Client.SEND_TIMEOUT_S
        for c in leaving + clients:
            c.close_at_exit(deadline)
        logger.info("%s: listener closed, %d client(s) dropped", name, len(clients))
    return n
