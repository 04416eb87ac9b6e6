"""Shared line-oriented daemon protocol for the warm-process serve CLIs.

The port of ``styletransfer_tpu/engines/daemon.py``, byte for byte the same
protocol, so that a client of the JAX daemons (``examples/daemon_client.py``)
drives the port's unchanged. The port has all four of its daemons (``fast_st
serve``, ``fast_st serve-multi``, ``video_st serve``, ``gatys_st --serve``),
on stdin or behind the TCP and HTTP transports (``engines/netserve.py``,
``engines/httpserve.py``), which hand this loop stdin- and stdout-shaped
streams: requests are TAB-separated fields, one per line; responses are
flushed per line:

- ``READY`` is printed by the caller once its program is compiled (this
  module only runs the request loop);
- each request answers ``OK <result>`` or ``ERR <input>: <reason>`` —
  a failed request never kills the daemon;
- a blank line or EOF shuts down.

The engines own everything model-specific (warm-up, which also builds the
kernels, and how a request is served); this loop owns parsing, error
containment, and the response contract, so the daemons cannot drift apart.
The differences from the JAX module are in :func:`device_rtt_ms`: its probe
is a one-element op on the serving device and a synchronize, and STATS
answers with the last finished probe's value instead of waiting for a new
one (the loops probe once before the first request,
:func:`prime_device_rtt`).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, Dict, Optional

from styletransfer_tpu_torch.utils.logging import get_logger


def normalize_buckets(sizes, fallback_size: int) -> list:
    """Validated, deduped resolution-bucket list (first = the default).

    One contract for every bucketed daemon: positive ints,
    order-preserving dedup, ``sizes=None`` collapses to the single
    ``fallback_size`` bucket, so the serve loops cannot drift.
    """
    if not sizes:
        return [fallback_size]
    buckets: list = []
    for s in sizes:
        s = int(s)
        if s < 1:
            raise ValueError(f"serving size must be >= 1, got {s}")
        if s not in buckets:
            buckets.append(s)
    return buckets


def split_fields(line: str) -> list:
    """TAB-split a request line, dropping TRAILING empty fields.

    The serial loop matches bare command words on ``line.strip()`` (which
    eats trailing tabs), so the batched loops must see ``"RESET\\t\\t"``
    as the same bare ``["RESET"]`` — otherwise identical client bytes
    would reset all streams in one mode and only stream 0 in the other.
    Interior empty fields survive (``"img\\t\\tA"`` keeps its empty OUTPUT
    slot), and dropping trailing empties never changes meaning: every
    protocol gives trailing-optional fields the same default as absent
    ones.
    """
    fields = [f.strip() for f in line.split("\t")]
    while len(fields) > 1 and fields[-1] == "":
        fields.pop()
    return fields


_io_pool = None


def io_pool():
    """Shared thread pool for per-request host image IO in batched groups.

    A drained group's PNG decodes/encodes are independent per request and
    PIL releases the GIL around codec work, so running them serially
    leaves host IO on the critical path next to the one device call. One
    process-wide pool keeps the thread count bounded across daemons that
    share a process in tests.
    """
    global _io_pool
    if _io_pool is None:
        from concurrent.futures import ThreadPoolExecutor

        _io_pool = ThreadPoolExecutor(max_workers=8,
                                      thread_name_prefix="serve-io")
    return _io_pool


def resolve_out_path(explicit_out: str, out_dir: str, default_name: str) -> str:
    """Output path for one request: the explicit TAB field (resolved
    against the project root, parent dirs created) or ``out_dir`` +
    the daemon's default naming."""
    from styletransfer_tpu_torch import constants

    if explicit_out:
        out_file = os.path.join(constants.PROJECT_ROOT_PATH, explicit_out)
        os.makedirs(os.path.dirname(out_file) or ".", exist_ok=True)
        return out_file
    return os.path.join(out_dir, default_name)


class _Reservoir:
    """Uniform reservoir sample (Algorithm R) of wall times, so percentiles
    keep tracking the WHOLE history — a first-N buffer would freeze the
    reported latency at day-one values and hide later regressions."""

    SIZE = 4096

    def __init__(self, seed: int = 0):
        import random

        self.items: list = []
        self._rng = random.Random(seed)
        self._n_seen = 0

    def add(self, value_ms: float) -> None:
        self._n_seen += 1
        if len(self.items) < self.SIZE:
            self.items.append(value_ms)
        else:
            j = self._rng.randrange(self._n_seen)
            if j < self.SIZE:
                self.items[j] = value_ms

    def percentile(self, q: float) -> float:
        ts = sorted(self.items)
        return ts[min(len(ts) - 1, int(q * len(ts)))]

    def mean(self) -> float:
        return sum(self.items) / len(self.items)


class _ServeStats:
    """Request-latency bookkeeping for the daemon loops.

    Two bounded reservoirs of per-request wall times (ms):

    - ``times_ms`` — TRUE per-request latency. In the serial loop this is
      the handler's elapsed time; in the batched loop it is each request's
      enqueue→reply wall time (what the client actually observed), so the
      percentiles no longer understate individual tails in batched mode.
    - ``amort_ms`` — the group-amortized figure (group elapsed / group
      size), batched mode only, kept as a secondary throughput-style
      metric (it is what "cost per request on the device" looks like).

    Plus error and batch-fill counts; logs a one-line summary every
    ``report_every`` requests and at shutdown, so a long-lived daemon's
    health is visible from its stderr without any external metrics stack.
    """

    def __init__(self, name: str, logger, report_every: int = 100):
        self.name, self.logger = name, logger
        self.report_every = report_every
        self.times_ms = _Reservoir(seed=0)
        self.amort_ms = _Reservoir(seed=1)
        self.n_ok = 0
        self.n_err = 0
        self._group_sum = 0
        self._group_n = 0

    def record(self, n_ok: int, n_err: int, elapsed_s: float,
               group_size: Optional[int] = None,
               request_times_ms: Optional[list] = None) -> None:
        n = n_ok + n_err
        if n == 0:
            return
        self.n_ok += n_ok
        self.n_err += n_err
        per_req_ms = elapsed_s * 1e3 / n
        if request_times_ms is None:
            # Serial mode: handler elapsed IS the true per-request time.
            for _ in range(n):
                self.times_ms.add(per_req_ms)
        else:
            for t in request_times_ms:
                self.times_ms.add(t)
            for _ in range(n):
                self.amort_ms.add(per_req_ms)
        if group_size is not None:
            self._group_sum += group_size
            self._group_n += 1
        before = (self.n_ok + self.n_err - n) // self.report_every
        if (self.n_ok + self.n_err) // self.report_every != before:
            self.report("stats")

    def snapshot(self) -> str:
        """One-line machine-readable summary — the ``STATS`` protocol
        command's payload, so ops can poll a daemon's health in-band
        instead of scraping stderr. ``p50_ms/p95_ms/mean_ms`` are true
        per-request latencies (enqueue→reply in batched mode);
        ``amort_*`` fields carry the group-amortized secondary metric."""
        parts = [f"ok={self.n_ok}", f"err={self.n_err}"]
        if self.times_ms.items:
            parts += [
                f"p50_ms={self.times_ms.percentile(0.50):.1f}",
                f"p95_ms={self.times_ms.percentile(0.95):.1f}",
                f"mean_ms={self.times_ms.mean():.1f}",
            ]
            if self._group_n:
                parts += [
                    "latency=enqueue-to-reply",
                    f"amort_mean_ms={self.amort_ms.mean():.1f}",
                    f"amort_p50_ms={self.amort_ms.percentile(0.50):.1f}",
                    f"mean_batch_fill={self._group_sum / self._group_n:.1f}",
                ]
        return " ".join(parts)

    def report(self, label: str) -> None:
        if not self.times_ms.items:
            return
        fill = ""
        metric = "per-request ms"
        if self._group_n:
            metric = "enqueue-to-reply per-request ms"
            fill = (f", group-amortized mean {self.amort_ms.mean():.1f} ms"
                    f", mean batch fill {self._group_sum / self._group_n:.1f}"
                    f" over {self._group_n} group(s)")
        self.logger.info(
            "%s %s: %d ok / %d err, %s p50=%.1f p95=%.1f mean=%.1f%s",
            self.name, label, self.n_ok, self.n_err, metric,
            self.times_ms.percentile(0.50), self.times_ms.percentile(0.95),
            self.times_ms.mean(), fill,
        )


# Per serving device (its name): the last finished probe's round trip in
# milliseconds, and whether a probe is running now.
_rtt_state: dict = {"last": {}, "running": set()}
_rtt_lock = threading.Lock()


def _probe(device) -> float:
    """One tiny op on ``device`` and a synchronize, in milliseconds."""
    import torch

    dev = torch.device(device or "cpu")
    t0 = time.perf_counter()
    v = torch.zeros((1,), dtype=torch.float32, device=dev) + 1.0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    float(v[0])
    return (time.perf_counter() - t0) * 1e3


def _start_probe(device) -> Optional[threading.Thread]:
    """Start a probe of ``device`` in a worker thread unless one is running;
    returns the thread it started, or None."""
    key = str(device or "cpu")
    last, running = _rtt_state["last"], _rtt_state["running"]
    with _rtt_lock:
        if key in running:
            return None
        running.add(key)

    def work() -> None:
        try:
            last[key] = _probe(device)
        except Exception:  # noqa: BLE001 - diagnostics must not break STATS
            pass
        finally:
            with _rtt_lock:
                running.discard(key)

    th = threading.Thread(target=work, daemon=True, name="stats-rtt-probe")
    th.start()
    return th


def _rtt_disabled() -> bool:
    return os.environ.get("STX_STATS_RTT") == "0"


def device_rtt_ms(device=None) -> Optional[float]:
    """The round trip of the last finished probe of the serving device: one
    tiny op and a synchronize, in milliseconds.

    Every daemon's ``STATS`` reply carries ``device_rtt_ms``, so an operator
    can tell a slow daemon from a slow device path. ``device`` is the
    serving device (a ``torch.device`` or its name; None: the CPU). Never
    waits: it starts a new probe in the background when none is running and
    returns the value of the last one that finished, or None before one has
    finished (and when disabled with ``STX_STATS_RTT=0``). So STATS answers
    at once even when the device is the thing that is sick, and slow probes
    never pile up. The JAX function joins its probe for up to
    ``STX_STATS_RTT_TIMEOUT_S``, which held up every answer of a batched
    group behind a STATS line.
    """
    if _rtt_disabled():
        return None
    _start_probe(device)
    return _rtt_state["last"].get(str(device or "cpu"))


def prime_device_rtt(device=None) -> None:
    """Probe ``device`` once before the first request, waiting for the probe
    up to ``STX_STATS_RTT_TIMEOUT_S`` (default 2 s), so that the first STATS
    of a healthy device carries ``device_rtt_ms``. A probe that outlasts the
    wait goes on in the background."""
    if _rtt_disabled():
        return
    th = _start_probe(device)
    if th is not None:
        th.join(float(os.environ.get("STX_STATS_RTT_TIMEOUT_S", "2.0")))


def _rtt_suffix(device=None) -> str:
    v = device_rtt_ms(device)
    return f" device_rtt_ms={v:.2f}" if v is not None else ""


class _ShutdownSignal(BaseException):
    """Raised by the SIGTERM/SIGINT handler at a SAFE point — only while
    the loop is blocked waiting for input, never mid-request. BaseException
    on purpose: the loops' per-request ``except Exception`` containment
    must not swallow a shutdown into an ERR response."""


class _GracefulSignals:
    """Graceful SIGTERM/SIGINT for warm daemons (the supervisor contract:
    systemd/k8s stop with SIGTERM and expect in-flight work to finish).

    First signal = graceful: sets ``requested``; in-flight work finishes
    and its responses are written before the loop exits. How the loop
    notices depends on its blocking primitive: the batched loop polls its
    queue (``raise_first_idle=False`` — the handler never raises on the
    first signal, so a request can never be consumed-then-dropped), while
    the serial loop blocks in ``readline`` with no timeout, so an IDLE
    first signal raises :class:`_ShutdownSignal` out of the read (the
    loop marks ``busy = True`` around request processing; a busy first
    signal defers). Serial boundary case: a signal landing in the
    instants between ``readline`` returning a line and the busy mark
    drops that just-consumed request unanswered — indistinguishable, to
    the client, from the request still being queued at shutdown (the
    transports surface daemon-gone to waiters either way).

    A SECOND signal always raises, wherever execution is — the operator
    insists; partially-written groups and the response drain are
    abandoned.

    Handlers install only in the main thread (CPython delivers signals
    there; ``signal.signal`` elsewhere raises) and are restored on exit.
    Note for in-process main-thread embedders (e.g. tests): while the
    loop runs, Ctrl-C is a graceful stop of the LOOP (it returns
    normally) rather than a KeyboardInterrupt out of the embedding
    program. EOF / blank line / SHUTDOWN remain the in-band shutdown
    paths; this adds the out-of-band one.
    """

    def __init__(self, name: str, logger, raise_first_idle: bool = True):
        self.requested = False
        self.busy = False
        self.signals = 0
        self._raise_first_idle = raise_first_idle
        self._installed = []
        self._name = name
        self._logger = logger

    def __enter__(self):
        import signal
        import threading

        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._installed.append((sig, signal.signal(sig, self._on)))
                except (ValueError, OSError):  # pragma: no cover - platform
                    pass
        return self

    def __exit__(self, *exc):
        import signal

        for sig, prev in self._installed:
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):  # pragma: no cover - platform
                pass
        return False

    def _on(self, signum, frame):
        self.signals += 1
        self.requested = True
        if self.signals >= 2:
            raise _ShutdownSignal()  # operator insists: abort in place
        if self.busy or not self._raise_first_idle:
            self._logger.info(
                "%s: got signal %d; finishing in-flight request(s) then "
                "shutting down", self._name, signum,
            )
            return
        raise _ShutdownSignal()


def run_request_loop(
    handle: Callable[..., str],
    stdin=None,
    stdout=None,
    name: str = "serve",
    commands: Optional[Dict[str, Callable[[], str]]] = None,
    device=None,
) -> int:
    """Run the request loop. Returns the number of successful requests.

    ``handle(*fields)`` serves one request (fields = the TAB-split line,
    stripped) and returns the response payload (usually the output path);
    raising answers ``ERR`` with the exception text. ``commands`` maps
    bare keyword lines (e.g. ``"RESET"``) to zero-arg handlers whose
    return value is echoed after ``OK`` without counting as a served
    request. Every daemon answers a bare ``STATS`` line with the loop's
    own latency/error summary (``OK STATS ok=.. err=.. p50_ms=..``) —
    in-band health polling, handled here so no engine can forget it
    (an engine-provided ``commands["STATS"]`` wins, for tests).

    Logs per-request latency percentiles every 100 requests and at
    shutdown (`_ServeStats`) — a warm daemon's health is visible from
    stderr alone. ``device`` is the serving device, which STATS probes
    (:func:`device_rtt_ms`; probed once here before the first request).
    """
    logger = get_logger()
    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    stats = _ServeStats(name, logger)

    commands = dict(commands or {})
    commands.setdefault(
        "STATS", lambda: f"STATS {stats.snapshot()}{_rtt_suffix(device)}"
    )
    prime_device_rtt(device)

    n_served = 0
    sig = _GracefulSignals(name, logger)
    with sig:
        try:
            for line in stdin:
                line = line.rstrip("\n")
                if not line.strip():
                    break
                sig.busy = True
                try:
                    if commands and line.strip() in commands:
                        word = line.strip()
                        try:
                            print(f"OK {commands[word]()}",
                                  file=stdout, flush=True)
                        except Exception as exc:  # noqa: BLE001 - e.g. RELOAD with no ckpt
                            logger.warning("%s: command %s failed (%s)",
                                           name, word, exc)
                            print(f"ERR {word}: {_reason(exc)}",
                                  file=stdout, flush=True)
                    else:
                        fields = split_fields(line)
                        t0 = time.perf_counter()
                        try:
                            result = handle(*fields)
                            n_served += 1
                            print(f"OK {result}", file=stdout, flush=True)
                            stats.record(1, 0, time.perf_counter() - t0)
                        except Exception as exc:  # noqa: BLE001 - daemon must not die per-request
                            logger.warning("%s: failed on %s (%s)",
                                           name, fields[0], exc)
                            print(f"ERR {fields[0]}: {_reason(exc)}",
                                  file=stdout, flush=True)
                            stats.record(0, 1, time.perf_counter() - t0)
                finally:
                    sig.busy = False
                if sig.requested:
                    break
        except _ShutdownSignal:
            pass
    if sig.requested:
        logger.info("%s: graceful shutdown on signal", name)
    logger.info("%s: shutting down after %d request(s)", name, n_served)
    stats.report("final")
    return n_served


def _reason(exc: Exception) -> str:
    # Exception text can span lines (e.g. CUDA runtime errors); the protocol
    # is one response line per request, so collapse it.
    return " ".join(str(exc).split()) or type(exc).__name__


def make_pooled_segment_submit(decode, launch, save):
    """Build a ``submit_segment`` with the shared batched-wave skeleton:
    pooled host decode → group by resolution bucket → one async device
    launch per bucket → ``finalize`` that copies the outputs to the host
    (which waits for the device) and pool-saves.

    Shared by ``fast.serve_loop`` and ``multistyle.serve_loop`` (which
    differ only in per-request extras: style weights, output tags) so the
    decode/group/pad/launch/finalize protocol cannot drift between them
    — hand-synced copies of this skeleton are exactly the maintenance
    trap ``segmented_submit_batch`` exists to prevent one level up.

    - ``decode(i, fields) -> (i, bucket, meta, exc)``: host-side parse +
      image load for ONE request (runs on :func:`io_pool`); ``meta`` is
      any tuple whose ``[0]`` is the request index; a non-None ``exc``
      answers that request ``ERR``.
    - ``launch(bucket, metas) -> tensor``: stack/pad the group and START
      the device call (CUDA launches return before the device is done);
      raising answers the whole bucket group ``ERR``.
    - ``save(meta, img) -> payload``: encode/write one output (pooled);
      raising answers that request ``ERR``.
    """
    def submit_segment(segment, results):
        by_bucket: dict = {}
        for i, bucket, meta, exc in io_pool().map(
                lambda job: decode(*job), segment):
            if exc is not None:
                results[i] = exc
            else:
                by_bucket.setdefault(bucket, []).append(meta)
        launched = []
        for bucket, metas in by_bucket.items():
            try:
                launched.append((metas, launch(bucket, metas)))
            except Exception as exc:  # noqa: BLE001 - keep per-request ERRs
                for meta in metas:
                    results[meta[0]] = exc

        def finalize():
            for metas, out_dev in launched:
                try:
                    out = out_dev.cpu().numpy()[: len(metas)]
                except Exception as exc:  # noqa: BLE001 - e.g. runtime error
                    for meta in metas:
                        results[meta[0]] = exc
                    continue

                def save_job(meta_img):
                    meta, img = meta_img
                    try:
                        results[meta[0]] = save(meta, img)
                    except Exception as exc:  # noqa: BLE001
                        results[meta[0]] = exc

                list(io_pool().map(save_job, zip(metas, out)))

        return finalize

    return submit_segment


def segmented_submit_batch(submit_segment, commands: Dict[str, Callable]):
    """Build a ``submit_batch`` that splits groups on bare command lines.

    ``submit_segment(segment, results)`` STARTS one command-free run —
    host decode plus the (async) device dispatch — and returns a zero-arg
    ``finalize`` that fetches the outputs and fills ``results``. ``results``
    is indexed by request position; each outcome is a payload string or an
    Exception; ``commands`` maps bare single-field words (e.g. ``"RELOAD"``)
    to zero-arg handlers whose exception answers ERR for that line only.
    The returned ``submit_batch(requests)`` submits every segment of the
    group (running command handlers between them, in order) and returns
    one ``finalize()`` for the whole group, so the batched loop CAN keep
    the next group's decode+dispatch in flight behind this group's
    fetch+encode when pipelining is opted in
    (:func:`run_batched_request_loop` ``submit_batch=``). Shared by
    ``fast.serve_loop`` and ``multistyle.serve_loop`` so the two batched
    protocols cannot drift.

    Command ordering is preserved: a RELOAD between segments runs at
    submit time, AFTER the earlier segment's device call is dispatched
    (which bound the old params at call time) and BEFORE the later
    segment's — so "requests before the command see the old state" holds
    exactly as in the serial form (a launched call has read the old
    parameters' pointers; RELOAD builds new tensors and does not write the
    old ones).
    """

    def submit_batch(requests):
        results: list = [None] * len(requests)
        finals: list = []
        segment: list = []
        for i, fields in enumerate(requests):
            if len(fields) == 1 and fields[0] in commands:
                finals.append(submit_segment(segment, results))
                segment = []
                try:
                    results[i] = commands[fields[0]]()
                except Exception as exc:  # noqa: BLE001 - answered per-line
                    results[i] = exc
                continue
            segment.append((i, fields))
        finals.append(submit_segment(segment, results))

        def finalize():
            for fin in finals:
                fin()
            return results

        return finalize

    return submit_batch


def run_batched_request_loop(
    handle_batch: Optional[Callable],
    max_batch: int,
    stdin=None,
    stdout=None,
    name: str = "serve",
    submit_batch: Optional[Callable] = None,
    depth: Optional[int] = None,
    device=None,
) -> int:
    """Dynamic-batching variant of :func:`run_request_loop`.

    A reader thread feeds a queue; the main loop blocks for the first
    pending request, then drains (without waiting) whatever else has
    already arrived, up to ``max_batch``, and hands the group to
    ``handle_batch(requests)`` — one device call for the whole group. A
    lone request therefore keeps single-request latency, while a client
    that pipes N lines at once gets them served ``max_batch`` at a time.

    ``handle_batch`` receives a list of field-lists and returns one result
    per request IN ORDER: a string payload (answered ``OK <payload>``) or
    an Exception instance (answered ``ERR <input>: <reason>``). Responses
    are written in request order, one line each, so clients pairing
    responses to requests by count work unchanged. Bare ``STATS`` lines
    are answered by the loop itself (in order, like every response) and
    never reach ``handle_batch``.

    ``submit_batch`` (instead of ``handle_batch``) supports WAVE
    PIPELINING: ``submit_batch(requests)`` starts the group — host decode
    plus the async device dispatch — and returns a zero-arg ``finalize()``
    yielding the results list. With ``depth`` > 0 and more requests
    already queued, the loop submits the next group before finalizing the
    current one, overlapping group k's fetch+encode with group k+1's
    decode+dispatch (CUDA launches are async; the device executes groups in
    launch order on one stream). The contract is unchanged: responses
    stream in request order (groups finalize FIFO), and a lone request —
    nothing else queued — is finalized immediately.

    ``depth`` (default ``STX_SERVE_PIPELINE_DEPTH`` or 0) is the number
    of groups held in flight behind the one being drained. The default is
    0, strictly serial, as in the JAX package: depth>0 reorders cross-group
    side effects (group k+1's input decode runs before group k's output
    save — back-to-back dependent requests may read a not-yet-written or
    stale file). Opt in via the env var where host IO is a large fraction
    of the wave. When only ``handle_batch`` is given the work is
    synchronous — there is nothing to overlap — so ``depth`` is forced to 0
    (depth>0 would only delay group k's responses until group k+1 finished
    computing). ``device`` is the serving device, which STATS probes.

    Returns the number of successful requests.
    """
    import queue

    logger = get_logger()
    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    stats = _ServeStats(name, logger)

    # Bounded: when the device falls behind a flooding client, the reader
    # blocks instead of buffering the whole backlog in host memory — the
    # pressure propagates down the pipe/socket to the sender (TCP window /
    # pipe buffer), which is the correct production failure mode.
    prime_device_rtt(device)
    q: "queue.Queue" = queue.Queue(maxsize=max(64, 8 * max_batch))
    _EOF = object()

    def reader():
        try:
            for line in stdin:
                # Stamp arrival: the batched loop reports each request's
                # enqueue→reply wall time (what the client observes), not
                # just the group-amortized figure.
                q.put((line.rstrip("\n"), time.perf_counter()))
                if not line.strip():
                    return  # blank line = shutdown; stop consuming stdin
        except Exception as exc:  # noqa: BLE001 - e.g. undecodable stdin bytes
            logger.warning("%s: stdin reader failed (%s); shutting down",
                           name, exc)
        finally:
            # ALWAYS unblock the main loop — a reader that dies without a
            # sentinel would leave the daemon hanging in q.get() forever.
            q.put(_EOF)

    threading.Thread(target=reader, daemon=True, name=f"{name}-reader").start()

    if submit_batch is None:
        if handle_batch is None:
            raise ValueError("need handle_batch or submit_batch")

        def submit_batch(work, _hb=handle_batch):
            results = _hb(work)
            return lambda: results

        # Synchronous handler: all work happens at submit time, so
        # holding groups in flight can't overlap anything — it would only
        # withhold finished responses until the NEXT group computed.
        depth = 0
    if depth is None:
        depth = int(os.environ.get("STX_SERVE_PIPELINE_DEPTH", "0"))
    depth = max(0, depth)

    # In-flight groups, oldest first:
    # (requests, enq_times, stats_ix, t0, finalize).
    inflight: list = []
    n_served = 0

    def finalize_oldest():
        nonlocal n_served
        requests, enq_times, stats_ix, t0, fin = inflight.pop(0)
        n_work = len(requests) - len(stats_ix)
        try:
            work_results = fin()
            if len(work_results) != n_work:
                # Protocol invariant: exactly one response per request. A
                # short/long result list must not silently drop responses
                # (a counting client would block forever on the missing
                # lines) — answer the whole group ERR instead.
                raise RuntimeError(
                    f"handle_batch returned {len(work_results)} results for "
                    f"{n_work} requests"
                )
        except Exception as exc:  # noqa: BLE001 - daemon must not die per-batch
            logger.warning("%s: batch of %d failed (%s)", name, n_work, exc)
            work_results = [exc] * n_work
        it = iter(work_results)
        results = [f"STATS {stats.snapshot()}{_rtt_suffix(device)}"
                   if i in stats_ix else next(it)
                   for i in range(len(requests))]
        group_ok = group_err = 0
        for i, (fields, result) in enumerate(zip(requests, results)):
            if isinstance(result, Exception):
                logger.warning("%s: failed on %s (%s)", name, fields[0], result)
                print(f"ERR {fields[0]}: {_reason(result)}",
                      file=stdout, flush=False)
                group_err += 1
            else:
                print(f"OK {result}", file=stdout, flush=False)
                if i not in stats_ix:
                    n_served += 1
                    group_ok += 1
        stdout.flush()
        # Enqueue→reply, stamped AFTER the flush: what THIS request's
        # client waited — queue time, device wave, AND response
        # serialization/backpressure included. Stamping before the write
        # would understate exactly the tail this metric exists to expose
        # (a blocked client's full pipe can stall the flush for seconds).
        now = time.perf_counter()
        true_ms = [(now - enq_times[i]) * 1e3
                   for i in range(len(requests)) if i not in stats_ix]
        stats.record(group_ok, group_err, now - t0,
                     group_size=len(requests) - len(stats_ix),
                     request_times_ms=true_ms)

    shutting_down = False
    # raise_first_idle=False: the idle wait below polls, so the first
    # signal NEVER raises in this loop — a request dequeued by q.get can
    # never be consumed-then-dropped by a signal landing right after.
    sig = _GracefulSignals(name, logger, raise_first_idle=False)
    with sig:
        try:
            while not shutting_down and not sig.requested:
                if inflight:
                    # A group is in flight: only take on another if it has
                    # already arrived — otherwise finalize NOW, so a lone
                    # request's response never waits on future traffic.
                    try:
                        first = q.get_nowait()
                    except queue.Empty:
                        sig.busy = True
                        try:
                            finalize_oldest()
                        finally:
                            sig.busy = False
                        continue
                else:
                    try:
                        # Idle wait, polled: q.get returns the moment a
                        # line arrives; the timeout only bounds how long a
                        # first-signal shutdown waits to be noticed.
                        first = q.get(timeout=0.5)
                    except queue.Empty:
                        continue  # loop condition re-checks sig.requested
                if first is _EOF or not str(first[0]).strip():
                    break
                sig.busy = True
                try:
                    pending = [first]
                    while len(pending) < max_batch:
                        try:
                            nxt = q.get_nowait()
                        except queue.Empty:
                            break
                        if nxt is _EOF or not str(nxt[0]).strip():
                            shutting_down = True
                            break
                        pending.append(nxt)

                    requests = [split_fields(line) for line, _ in pending]
                    enq_times = [t_enq for _, t_enq in pending]
                    # STATS is loop-owned (the stats live here, engines
                    # after all): answer it in place — without routing it
                    # through handle_batch, and without counting it as a
                    # served request (like the serial loop's commands).
                    # The snapshot reflects the state BEFORE this wave's
                    # finalize, the only causally-coherent answer
                    # mid-group.
                    stats_ix = {i for i, f in enumerate(requests)
                                if len(f) == 1 and f[0] == "STATS"}
                    work = [f for i, f in enumerate(requests)
                            if i not in stats_ix]
                    t0 = time.perf_counter()
                    try:
                        fin = submit_batch(work) if work else (lambda: [])
                    except Exception as exc:  # noqa: BLE001 - submit must not kill the loop
                        def fin(_exc=exc):
                            raise _exc
                    inflight.append((requests, enq_times, stats_ix, t0, fin))
                    while len(inflight) > depth:
                        finalize_oldest()
                finally:
                    sig.busy = False
        except _ShutdownSignal:
            pass
        # Drain: answer every group already submitted (a graceful stop —
        # signal or EOF with pipelined groups still in flight — must not
        # leave clients waiting on responses the device already computed).
        # Only a repeat signal (the operator insisting) abandons it; the
        # first signal defers here like everywhere else in this loop.
        if sig.signals >= 2 and inflight:
            logger.warning(
                "%s: abort on repeated signals; at least %d group(s) "
                "unanswered", name, len(inflight),
            )
            inflight.clear()
        try:
            while inflight:
                finalize_oldest()
        except _ShutdownSignal:
            logger.warning(
                "%s: repeat signal during drain; at least %d group(s) "
                "unanswered", name, len(inflight),
            )
    if sig.requested:
        logger.info("%s: graceful shutdown on signal", name)
    logger.info("%s: shutting down after %d request(s)", name, n_served)
    stats.report("final")
    return n_served
