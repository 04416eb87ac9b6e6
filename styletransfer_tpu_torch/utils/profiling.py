"""Where the time of the fast_st forward, of a training step, or of a
Gatys closure and L-BFGS step goes on the GPU; and the port's spans.

    python -m styletransfer_tpu_torch.utils.profiling [--batch 64] [--size 256]
    python -m styletransfer_tpu_torch.utils.profiling --train [--batch 4]
    python -m styletransfer_tpu_torch.utils.profiling --gatys [--size 256]

Runs ``engines.fast.make_serve_fn`` (with ``--train``, the train step of
``engines.fast.make_train_step``: forward, backward and Adam; with
``--gatys``, one Gatys closure, the loss and pixel gradient of
``engines.gatys.make_loss_fn``, and one outer L-BFGS step of
``engines.gatys._run_lbfgs_torch``, up to 20 closures with the history math,
at batch 1) on seeded parameters and inputs on the card, in f32 and bf16,
under ``torch.profiler``, and prints the device time of each kernel, of each
group of kernels (the port's kernels, cuDNN's convolutions, matrix
products, the optimizer, everything else) and of each program span
(:func:`span`) that launched it, the wall time per call (without the
profiler, and under it) and the share of the profiled calls' wall time in
which the device ran nothing. The last line is one JSON object with the
same numbers. Needs a CUDA GPU; fails without one.

Spans: :func:`span` marks a region of the program (``serve.forward``,
``train.step``, each layer of the transform net as ``tn.<layer>``, the
prefetch queue's ``data.*``). It costs one module-level check while no
recording is active. :func:`record_spans` records every span opened on any
thread while it is open, on the profiler's clock (Unix-epoch nanoseconds),
and :func:`attribute` totals a profiled stretch's device time per span, by
the span open on the launching thread when each operation was launched.

For programs, the module also has the JAX package's helpers
(``styletransfer_tpu/utils/profiling.py``): :func:`trace`, a
``torch.profiler`` recording of a region written as a Chrome / Perfetto
trace (with the spans, one track per thread), and :class:`StepTimer`, a
steady-state throughput meter.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import itertools
import json
import os
import subprocess
import sys
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from styletransfer_tpu_torch import constants
from styletransfer_tpu_torch.utils.logging import get_logger


class Span(NamedTuple):
    """One closed span: ``thread`` is ``threading.get_native_id()`` of the
    thread it ran on, the ends are Unix-epoch nanoseconds (the profiler's
    clock), ``cause`` the ``id`` of the span that caused it (None: none)."""

    id: int
    name: str
    thread: int
    start_ns: int
    end_ns: int
    cause: Optional[int]


class SpanRecording:
    """The spans of one :func:`record_spans` block, in the order they
    closed (``spans``, filled when the block closes). ``thread`` is the
    thread that opened the recording; ``idents`` maps each recording
    thread's ``threading.get_ident()`` to its native id (a profiler names a
    launching thread by either, :class:`SpanIndex`)."""

    def __init__(self) -> None:
        self.spans: List[Span] = []
        self.thread = threading.get_native_id()
        self.idents: Dict[int, int] = {threading.get_ident(): self.thread}
        self.closed = False
        # Raw (id, name, thread, perf_counter_ns start, end, cause): one
        # list.append per span, atomic under the interpreter lock.
        self._raw: List[tuple] = []
        self._stacks: Dict[int, List[int]] = {}
        self._ids = itertools.count()
        # One pair of readings converts perf_counter_ns to the epoch clock.
        self._offset = time.time_ns() - time.perf_counter_ns()

    def native_id(self) -> int:
        """The calling thread's native id (a dict lookup after its first)."""
        ident = threading.get_ident()
        native = self.idents.get(ident)
        if native is None:
            native = self.idents[ident] = threading.get_native_id()
        return native

    def innermost(self, thread: int) -> Optional[int]:
        """The id of the innermost span open on ``thread`` now."""
        stack = self._stacks.get(thread)
        return stack[-1] if stack else None

    def _close(self) -> None:
        self.closed = True
        off = self._offset
        self.spans = [Span(i, name, thread, t0 + off, t1 + off, cause)
                      for i, name, thread, t0, t1, cause in self._raw]


class _OpenSpan:
    """A span being recorded; entered and left on one thread."""

    __slots__ = ("rec", "name", "cause", "id", "thread", "t0")

    def __init__(self, rec: SpanRecording, name: str, cause: Optional[int] = None):
        self.rec, self.name, self.cause = rec, name, cause

    def __enter__(self) -> "_OpenSpan":
        rec = self.rec
        self.thread = thread = rec.native_id()
        stack = rec._stacks.get(thread)
        if stack is None:
            stack = rec._stacks.setdefault(thread, [])
        if self.cause is None and stack:
            self.cause = stack[-1]
        self.id = next(rec._ids)
        stack.append(self.id)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        rec = self.rec
        rec._stacks[self.thread].remove(self.id)
        if not rec.closed:
            rec._raw.append((self.id, self.name, self.thread, self.t0, t1, self.cause))
        return False


class _NoSpan:
    """What :func:`span` returns while nothing records: one shared object."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()
_recording: Optional[SpanRecording] = None
_recording_lock = threading.Lock()


def span(name: str):
    """A context manager marking a region of the program as ``name``. While
    no :func:`record_spans` block is open it is one shared no-op object."""
    rec = _recording
    if rec is None:
        return _NO_SPAN
    return _OpenSpan(rec, name)


@contextlib.contextmanager
def record_spans() -> Iterator[SpanRecording]:
    """Record every span opened on any thread while the block runs; the
    recording holds them once the block has closed. One recording at a
    time."""
    global _recording
    rec = SpanRecording()
    with _recording_lock:
        if _recording is not None:
            raise RuntimeError("a span recording is already open")
        _recording = rec
    try:
        yield rec
    finally:
        with _recording_lock:
            _recording = None
            rec._close()


def recording() -> bool:
    """Whether a :func:`record_spans` block is open."""
    return _recording is not None


def _last_node(out: torch.Tensor):
    """Of the autograd nodes that made ``out`` from leaves alone, the one
    autograd runs last: the first made (one device's ready nodes run
    latest-made first)."""
    seen, todo, last = {}, [out.grad_fn], None
    while todo:
        node = todo.pop()
        # By id, holding each node so that no id is reused while in use.
        if node is None or id(node) in seen or type(node).__name__ == "AccumulateGrad":
            continue
        seen[id(node)] = node
        if last is None or node._sequence_nr() < last._sequence_nr():
            last = node
        todo.extend(fn for fn, _ in node.next_functions)
    return last


def backward_span(name: str, out: torch.Tensor, x: torch.Tensor) -> None:
    """While a recording is open, make the backward of the layer that
    computed ``out`` from ``x`` (and parameters) a span ``name``, on
    autograd's thread: it opens when autograd starts the node that made
    ``out``, and closes when it starts the node that made ``x``, which waits
    for the layer's last node (for a layer whose input takes no gradient,
    when the layer's last node has run). Its cause is the span open, when
    the backward starts, on the thread that ran the forward (which calls the
    backward). Registers nothing while no recording is open."""
    rec = _recording
    if rec is None or out.grad_fn is None:
        return
    caller = rec.native_id()
    opened: List[_OpenSpan] = []

    def open_span(grad_outputs):
        s = _OpenSpan(rec, name, cause=rec.innermost(caller))
        s.__enter__()
        opened.append(s)

    def close_span(*grads):
        if opened:
            opened.pop().__exit__(None, None, None)

    out.grad_fn.register_prehook(open_span)
    if x.grad_fn is not None:
        x.grad_fn.register_prehook(close_span)
    else:
        _last_node(out).register_hook(close_span)


# --- the join of spans and a device trace ---------------------------------------------

class DeviceOp(NamedTuple):
    """One device operation of a trace: ``correlation`` links it to the
    host call that launched it."""

    name: str
    correlation: int
    start_ns: int
    end_ns: int


class Launch(NamedTuple):
    """One host call of the CUDA runtime or driver that launched work."""

    name: str
    correlation: int
    thread: int
    start_ns: int
    end_ns: int


def _is_call(name: str) -> bool:
    """Whether a host event is a CUDA runtime (``cuda*``) or driver (``cu``
    and a capital) call."""
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


def trace_events(prof) -> Tuple[List[DeviceOp], Dict[int, Launch]]:
    """The device operations of a ``torch.profiler`` trace, and the runtime
    calls that launched them by correlation id (Unix-epoch nanoseconds)."""
    ops, calls = [], {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            # A record_function range's device-side copy covers operations
            # counted on their own.
            if not ev.is_user_annotation():
                ops.append(DeviceOp(ev.name(), ev.correlation_id(), ev.start_ns(),
                                    ev.start_ns() + ev.duration_ns()))
        elif _is_call(ev.name()):
            calls[ev.correlation_id()] = Launch(ev.name(), ev.correlation_id(),
                                                ev.device_resource_id(), ev.start_ns(),
                                                ev.start_ns() + ev.duration_ns())
    return ops, calls


_LOW32 = 0xFFFFFFFF


class SpanIndex:
    """The spans of a recording by thread, to find the innermost span open
    on a thread at a moment. A trace names the thread of a runtime call
    (``device_resource_id``) by its native id where the profiler recorded
    the host's activity, else by the low 32 bits of its ``get_ident()``,
    signed."""

    def __init__(self, rec: SpanRecording):
        self.rec = rec
        self._low = {ident & _LOW32: native for ident, native in rec.idents.items()}
        self._threads: Dict[int, Tuple[List[int], List[Span]]] = {}
        by_thread: Dict[int, List[Span]] = defaultdict(list)
        for s in rec.spans:
            by_thread[s.thread].append(s)
        for thread, spans in by_thread.items():
            spans.sort(key=lambda s: (s.start_ns, -s.end_ns))
            self._threads[thread] = ([s.start_ns for s in spans], spans)

    def at(self, thread: int, t_ns: int) -> Optional[Span]:
        """The innermost span open on ``thread`` (as a trace names it) at
        ``t_ns``: of those that contain it, the one that started last."""
        if thread not in self._threads:
            thread = self._low.get(thread & _LOW32, thread)
        starts, spans = self._threads.get(thread, ((), ()))
        for i in range(bisect.bisect_right(starts, t_ns) - 1, -1, -1):
            if spans[i].end_ns >= t_ns:
                return spans[i]
        return None

    def launching(self, launch: Optional[Launch]) -> Optional[Span]:
        """The span a device operation belongs to: the innermost open on the
        launching thread when its launch began, or else the one open then on
        the thread that opened the recording."""
        if launch is None:
            return None
        s = self.at(launch.thread, launch.start_ns)
        return s if s is not None else self.at(self.rec.thread, launch.start_ns)


def attribute(ops: Sequence[DeviceOp], calls: Dict[int, Launch],
              rec: SpanRecording) -> Dict[str, float]:
    """Device seconds per span name: each operation's time goes to the span
    its launch belongs to (:meth:`SpanIndex.launching`), or to None."""
    index = SpanIndex(rec)
    out: Dict[Optional[str], float] = defaultdict(float)
    for op in ops:
        s = index.launching(calls.get(op.correlation))
        out[s.name if s is not None else None] += (op.end_ns - op.start_ns) / 1e9
    return dict(out)


def busy_ns(ops: Sequence[DeviceOp], t0: int, t1: int) -> int:
    """Nanoseconds of ``[t0, t1]`` in which the device ran anything (the
    union of the operations' intervals)."""
    total, end = 0, t0
    for op in sorted(ops, key=lambda o: o.start_ns):
        a, b = max(op.start_ns, end), min(op.end_ns, t1)
        if b > a:
            total += b - a
        end = max(end, min(op.end_ns, t1))
    return total


@contextlib.contextmanager
def trace(logdir: str = "runs/profile", device=None) -> Iterator[None]:
    """Record the enclosed region with ``torch.profiler``: the CPU, and CUDA
    when ``device`` is a GPU (None: when one is available), and the
    program's spans (:func:`record_spans`). Writes a Chrome / Perfetto
    trace (``trace_<pid>_<ms>.json``, open it in ui.perfetto.dev or
    chrome://tracing; each span lies on its thread's track, category
    ``span``) under ``logdir`` (relative to the project root) and logs its
    path."""
    if device is None:
        cuda = torch.cuda.is_available()
    else:
        cuda = torch.device(device).type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out_dir = os.path.join(constants.PROJECT_ROOT_PATH, logdir)
    os.makedirs(out_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        with record_spans() as rec:
            yield
    path = os.path.join(out_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(path)
    _add_spans(path, rec)
    get_logger().info("Profiler trace written to %s", path)


def _add_spans(path: str, rec: SpanRecording) -> None:
    """Write the recording's spans into a Chrome trace file, on its clock
    (microseconds after its ``baseTimeNanoseconds``), each on its thread's
    track of this process."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    events = doc.setdefault("traceEvents", [])
    named = {e.get("tid") for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name" and e.get("pid") == pid}
    names = {s.id: s.name for s in rec.spans}
    for thread in sorted({s.thread for s in rec.spans} - named):
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": thread,
                       "args": {"name": f"thread {thread}"}})
    for s in rec.spans:
        events.append({"ph": "X", "cat": "span", "name": s.name, "pid": pid, "tid": s.thread,
                       "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"cause": names.get(s.cause)}})
    with open(path, "w") as f:
        json.dump(doc, f)


class StepTimer:
    """Steady-state throughput meter that skips warm-up steps (a kernel
    build, cuDNN's algorithm search).

    >>> timer = StepTimer(items_per_step=batch_size, skip=2)
    >>> for batch in loader:
    ...     train_step(...)
    ...     timer.step()
    >>> timer.summary()  # -> "1234.5 items/s over 98 steps"

    ``skip=0`` times every step: the clock starts when the timer is built.
    Time device work only after it has finished (a synchronize, or a host
    read of its result) before each ``step()``.
    """

    def __init__(self, items_per_step: int = 1, skip: int = 2):
        self.items_per_step = items_per_step
        self.skip = skip
        self._count = 0
        self._t0: Optional[float] = time.perf_counter() if skip == 0 else None

    def step(self) -> None:
        self._count += 1
        if self._count == self.skip:
            self._t0 = time.perf_counter()

    @property
    def timed_steps(self) -> int:
        return max(0, self._count - self.skip)

    def rate(self) -> float:
        """Items per second over the timed steps (nan before the first)."""
        if self._t0 is None or self.timed_steps == 0:
            return float("nan")
        return self.timed_steps * self.items_per_step / (time.perf_counter() - self._t0)

    def summary(self) -> str:
        return f"{self.rate():.1f} items/s over {self.timed_steps} steps"

# First match wins. The IN kernel serves both the IN-pad of the serving
# forward and the fused-IN forward of the training forward.
_GROUPS = (
    ("conv3x3_flat kernel", ("conv3x3_flat_",)),
    ("conv3x3_im2col kernel", ("conv3x3_im2col_",)),
    ("conv3x3 kernel", ("conv3x3_", "tile_sums_kernel")),
    ("IN kernel (IN-pad / fused-IN forward)", ("::in_kernel<",)),
    ("fused-IN backward kernel", ("::inb_kernel<",)),
    ("conv_direct kernel", ("::direct_kernel<",)),
    ("upconv_phase kernel", ("upconv_phase_",)),
    ("conv9x9 kernel", ("conv9x9_",)),
    ("cuDNN convolutions", ("conv", "cudnn", "implicit", "winograd", "fft", "fprop", "dgrad",
                            "wgrad", "pointwise_mult_and_sum")),
    ("matrix-vector products and solves (L-BFGS history)", ("gemv", "trsm")),
    ("matrix products (Gram)", ("gemm", "cutlass")),
    ("optimizer (Adam)", ("multi_tensor", "adam")),
)


def _group(kernel_name: str) -> str:
    name = kernel_name.lower()
    for group, keys in _GROUPS:
        if any(k in name for k in keys):
            return group
    return "other (copies, pads, elementwise)"


WARMUP = 2


def _wall_ms(run, iters: int) -> float:
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _profile(run, batch: int, iters: int) -> Dict:
    """Profile ``iters`` calls of ``run`` after a warm-up; device times in ms
    per call. ``wall_ms`` (and ``img_per_s``) come from ``iters`` calls
    without the profiler, which adds host time of its own to every launch;
    ``profiled_wall_ms``, the busy time and the idle share from the profiled
    stretch of ``iters`` calls alone (:func:`summarize`)."""
    for _ in range(WARMUP):
        run()
    torch.cuda.synchronize()
    wall_ms = _wall_ms(run, iters)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with record_spans() as rec:
            t0 = time.time_ns()
            for _ in range(iters):
                run()
            torch.cuda.synchronize()
            t1 = time.time_ns()
    ops, calls = trace_events(prof)
    return {"wall_ms": wall_ms, "img_per_s": batch / (wall_ms / 1e3),
            **summarize(ops, calls, rec, t0, t1, iters)}


def summarize(ops: Sequence[DeviceOp], calls: Dict[int, Launch], rec: SpanRecording,
              t0: int, t1: int, iters: int) -> Dict:
    """One profiled stretch ``[t0, t1]`` (epoch ns) of ``iters`` calls, per
    call: its wall ms, the device's busy ms (the union of the operations'
    intervals in it) and idle share, device ms by kernel, by group and by
    span (None: launched outside any span)."""
    if not ops:
        raise RuntimeError("the profiler recorded no device time")
    kernels: Dict[str, float] = defaultdict(float)
    launches: Dict[str, int] = defaultdict(int)
    for op in ops:
        kernels[op.name] += (op.end_ns - op.start_ns) / 1e6 / iters
        launches[_group(op.name)] += 1
    groups: Dict[str, float] = defaultdict(float)
    for name, ms in kernels.items():
        groups[_group(name)] += ms
    busy = busy_ns(ops, t0, t1)
    spans = attribute(ops, calls, rec)
    return {
        "profiled_wall_ms": (t1 - t0) / 1e6 / iters, "device_busy_ms": busy / 1e6 / iters,
        "idle_share": 1.0 - busy / (t1 - t0),
        "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "device_ops_per_call": {k: v / iters for k, v in sorted(launches.items())},
        "top_kernels_ms": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:12]),
        "span_ms": {str(k): v * 1e3 / iters
                    for k, v in sorted(spans.items(), key=lambda kv: -kv[1])},
    }


def profile_forward(precision: str, batch: int, size: int, iters: int = 5) -> Dict:
    """The serving forward (uint8 in and out)."""
    from styletransfer_tpu_torch.engines import fast
    from styletransfer_tpu_torch.models import transformer

    dev = torch.device("cuda")
    params = transformer.init_params(seed=0, device=dev)
    x = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, size=(batch, size, size, 3), dtype=np.uint8)
    ).to(dev)
    serve = fast.make_serve_fn(precision)
    out = _profile(lambda: serve(params, x), batch, iters)
    return {"precision": precision, "batch": batch, "size": size, **out}


def profile_train_step(precision: str, batch: int, size: int, iters: int = 5) -> Dict:
    """One training step (forward, backward, Adam) on seeded parameters,
    seeded VGG and a seeded batch. ``wall_ms`` times the step as it runs,
    from its CUDA graph; the profiled stretch records spans, so it times
    the eager step, whose launches the spans name."""
    from styletransfer_tpu_torch.engines import fast
    from styletransfer_tpu_torch.models import transformer, vgg

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    params = transformer.init_params(seed=0, device=dev)
    vgg_params = vgg.init_params(seed=0, device=dev)
    style = torch.from_numpy(rng.standard_normal((1, size, size, 3)).astype(np.float32)).to(dev)
    grams = vgg.style_gram_targets(vgg_params, style)
    x = torch.from_numpy(rng.standard_normal((batch, size, size, 3)).astype(np.float32)).to(dev)
    step = fast.make_train_step(vgg_params, grams,
                                compute_dtype=torch.bfloat16 if precision == "bf16" else None)
    opt = fast.make_optimizer(params)
    out = _profile(lambda: step(params, opt, x), batch, iters)
    return {"precision": precision, "batch": batch, "size": size, "train_step": True, **out}


def profile_gatys(precision: str, size: int) -> Dict:
    """One Gatys closure (loss and pixel gradient) and one outer L-BFGS step
    (H = 100, compact) at batch 1, on seeded VGG parameters and images."""
    from styletransfer_tpu_torch.engines import gatys
    from styletransfer_tpu_torch.models import vgg

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    vgg_params = vgg.init_params(seed=0, device=dev)
    content, style = (torch.from_numpy(rng.standard_normal((1, size, size, 3)).astype(np.float32))
                      .to(dev) for _ in range(2))
    grams = vgg.style_gram_targets(vgg_params, style)
    cd = torch.bfloat16 if precision == "bf16" else None
    loss_fn = gatys.make_loss_fn(vgg_params, content, grams, compute_dtype=cd)

    def closure():
        x = content.detach().requires_grad_()
        return torch.autograd.grad(loss_fn(x).sum(), x)

    def outer_step():
        return gatys._run_lbfgs_torch(vgg_params, content, grams, 1, 100_000.0, 1.0,
                                      compute_dtype=cd, history_size=100,
                                      history_math="compact")

    out = {"precision": precision, "batch": 1, "size": size, "gatys": True}
    out["closure"] = _profile(closure, 1, iters=10)
    gatys.closure_evals = 0
    iters = 2
    out["outer_step"] = _profile(outer_step, 1, iters=iters)
    # _profile calls it WARMUP times, then iters times twice.
    out["outer_step"]["closures_per_call"] = gatys.closure_evals / (WARMUP + 2 * iters)
    return out


def _print_profile(label: str, r: Dict, card: str) -> None:
    print(f"{label} on {card}: {r['wall_ms']:.3f} ms/call ({r['img_per_s']:.1f} img/s; "
          f"{r['profiled_wall_ms']:.3f} under the profiler), device busy "
          f"{r['device_busy_ms']:.3f} ms of it, idle share {r['idle_share']:.4f}")
    for name, ms in r["groups_ms"].items():
        print(f"  {name:50s} {ms:9.3f} ms  {ms / r['device_busy_ms']:6.1%}  "
              f"{r['device_ops_per_call'][name]:.0f} kernels")
    for name, ms in r["top_kernels_ms"].items():
        print(f"    {ms:9.3f} ms  {name[:110]}")
    print("  device ms by the span that launched it:")
    for name, ms in r["span_ms"].items():
        print(f"    {ms:9.3f} ms  {name}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=None,
                    help="batch size (default 64 for the forward, 4 for --train)")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--train", action="store_true", help="profile a training step")
    ap.add_argument("--gatys", action="store_true",
                    help="profile a Gatys closure and an outer L-BFGS step")
    args = ap.parse_args(argv)
    batch = args.batch or (4 if args.train else 64)
    what = "train step" if args.train else "forward"
    if not torch.cuda.is_available():
        print("profiling: needs a CUDA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    results = []
    for precision in ("f32", "bf16"):
        if args.gatys:
            r = profile_gatys(precision, args.size)
            _print_profile(f"{precision} gatys closure at {r['size']} px", r["closure"], card)
            _print_profile(f"{precision} gatys outer L-BFGS step at {r['size']} px "
                           f"({r['outer_step']['closures_per_call']:.1f} closures)",
                           r["outer_step"], card)
        else:
            run = profile_train_step if args.train else profile_forward
            r = run(precision, batch, args.size)
            _print_profile(f"{precision} batch {r['batch']} {what} at {r['size']} px", r, card)
        results.append(r)
    print(json.dumps({"card": card, "profiles": results}))
    return 0


if __name__ == "__main__":
    # Run as a script this file is ``__main__``, a second copy of the module:
    # the spans of the engines record into the imported one.
    from styletransfer_tpu_torch.utils import profiling

    sys.exit(profiling.main())
