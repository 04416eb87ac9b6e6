"""The join of the program's spans with a traced stretch's device trace.

The program (``styletransfer_tpu_torch/utils/profiling.py``) records its
spans in memory under ``record_spans()``, on the profiler's clock
(Unix-epoch nanoseconds): each with its name, the native id of its thread,
its ends and the span that caused it. This module is the benchmark's own
reading of them, written from that record's form, so that a change to the
program's join does not move the yardstick:

- each device operation belongs to the innermost span open on the thread
  that launched it when its launch call began (the runtime call that shares
  its correlation id); where that thread had no span open, to the span open
  then on the thread that opened the recording;
- an idle interval of the card is the host's where the operation that ended
  it had not yet returned from its launch call when the interval began;
- an idle gap takes as a prefix the innermost span open at its middle on
  the recording thread.

The bounds of the layers that the spans delimit (``library_convs_bound_s``,
``tn_conv_backward_bound_s``) are the nominal arithmetic of
``counts.TRANSFORMNET_CONVS``. A program without spans (no
``record_spans``) records nothing: :func:`recording` then yields None.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

from h100bench import counts, peaks

# The six convs the serving forward leaves to the library (cuDNN).
LIBRARY_CONVS = ("tn.conv1", "tn.conv2", "tn.conv3", "tn.up1_conv", "tn.up2_conv", "tn.conv_out")
BWD = ".bwd"
HOST_GAP = "host between ops"


class Op(NamedTuple):
    """A device operation (kernel, copy, set) of a trace."""

    name: str
    correlation: int
    start_ns: int
    end_ns: int


class Call(NamedTuple):
    """A host call of the CUDA runtime or driver (a launch, a copy)."""

    name: str
    correlation: int
    thread: int
    start_ns: int
    end_ns: int


@contextlib.contextmanager
def recording() -> Iterator[Optional[object]]:
    """The program's ``record_spans()``, or None where it has none."""
    from styletransfer_tpu_torch.utils import profiling

    record = getattr(profiling, "record_spans", None)
    if record is None:
        yield None
        return
    with record() as rec:
        yield rec


def is_call(name: str) -> bool:
    """Whether a host event is a CUDA runtime (``cuda*``) or driver
    (``cu`` and a capital) call."""
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


def events(prof) -> Tuple[List[Op], Dict[int, Call]]:
    """A ``torch.profiler`` trace's device operations, and its runtime and
    driver calls by correlation id."""
    import torch

    ops, calls = [], {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if not ev.is_user_annotation():  # a range's device copy
                ops.append(Op(ev.name(), ev.correlation_id(), ev.start_ns(),
                              ev.start_ns() + ev.duration_ns()))
        elif is_call(ev.name()):
            calls[ev.correlation_id()] = Call(ev.name(), ev.correlation_id(),
                                              ev.device_resource_id(), ev.start_ns(),
                                              ev.start_ns() + ev.duration_ns())
    return ops, calls


LOW32 = 0xFFFFFFFF


class Spans:
    """A recording's spans by thread. ``idents`` maps a thread's
    ``threading.get_ident()`` to its native id: a trace names the thread of
    a runtime call (``device_resource_id``) by its native id where the host's
    activity was recorded, else by the low 32 bits of its ident, signed."""

    def __init__(self, spans: Sequence, thread: int, idents: Optional[Dict[int, int]] = None):
        self.thread = thread
        self.low = {ident & LOW32: native for ident, native in (idents or {}).items()}
        self.all = list(spans)
        self._by: Dict[int, Tuple[List[int], list]] = {}
        grouped: Dict[int, list] = defaultdict(list)
        for s in self.all:
            grouped[s.thread].append(s)
        for t, ss in grouped.items():
            ss.sort(key=lambda s: (s.start_ns, -s.end_ns))
            self._by[t] = ([s.start_ns for s in ss], ss)

    @classmethod
    def of(cls, rec) -> "Spans":
        return cls(rec.spans, rec.thread, getattr(rec, "idents", {}))

    def at(self, thread: int, t_ns: int):
        """The innermost span open on ``thread`` (as a trace names it) at
        ``t_ns``, or None."""
        if thread not in self._by:
            thread = self.low.get(thread & LOW32, thread)
        starts, ss = self._by.get(thread, ((), ()))
        for i in range(bisect.bisect_right(starts, t_ns) - 1, -1, -1):
            if ss[i].end_ns >= t_ns:
                return ss[i]
        return None

    def of_launch(self, call: Optional[Call]):
        """The span a device operation launched by ``call`` belongs to."""
        if call is None:
            return None
        s = self.at(call.thread, call.start_ns)
        return s if s is not None else self.at(self.thread, call.start_ns)

    def named(self, name: str) -> list:
        return [s for s in self.all if s.name == name]


def by_span(ops: Sequence[Op], calls: Dict[int, Call], spans: Spans) -> Dict[Optional[str], float]:
    """Device seconds by the name of the span each operation belongs to
    (None: no span)."""
    out: Dict[Optional[str], float] = defaultdict(float)
    for op in ops:
        s = spans.of_launch(calls.get(op.correlation))
        out[s.name if s is not None else None] += (op.end_ns - op.start_ns) / 1e9
    return dict(out)


def busy(ops: Sequence[Op], t0: int, t1: int) -> List[Tuple[int, int]]:
    """The union of the operations' intervals inside ``[t0, t1]``."""
    merged: List[Tuple[int, int]] = []
    for op in sorted(ops, key=lambda o: o.start_ns):
        a, b = max(op.start_ns, t0), min(op.end_ns, t1)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def idle(ops: Sequence[Op], t0: int, t1: int) -> List[Tuple[int, int, Optional[Op]]]:
    """Each idle interval of ``[t0, t1]`` with the operation that ended it
    (None for one that runs to ``t1``)."""
    starts = {}
    for op in ops:
        if op.start_ns not in starts or op.end_ns > starts[op.start_ns].end_ns:
            starts[op.start_ns] = op
    out, edge = [], t0
    for a, b in busy(ops, t0, t1):
        if a > edge:
            out.append((edge, a, starts.get(a)))
        edge = b
    if t1 > edge:
        out.append((edge, t1, None))
    return out


def host_bound_s(ops: Sequence[Op], calls: Dict[int, Call], t0: int, t1: int) -> float:
    """Seconds of ``[t0, t1]`` in which the card was idle waiting for the
    host: the operation that ended the interval had not yet returned from
    its launch call when the interval began."""
    total = 0
    for a, b, op in idle(ops, t0, t1):
        call = calls.get(op.correlation) if op is not None else None
        if call is not None and call.end_ns > a:
            total += b - a
    return total / 1e9


def gaps(ops: Sequence[Op], calls: Dict[int, Call], spans: Spans, t0: int, t1: int,
         top: int = 10) -> List[Tuple[str, float, Optional[str]]]:
    """The ``top`` longest idle gaps: each named by the host call that
    covered its middle (else "host between ops"), after the innermost span
    open then on the recording thread and a colon; its seconds; and the
    span open then on the covering call's own thread (None: none)."""
    covering = sorted(calls.values(), key=lambda c: c.start_ns)
    starts = [c.start_ns for c in covering]
    out = []
    for a, b, _ in sorted(idle(ops, t0, t1), key=lambda g: g[0] - g[1])[:top]:
        mid = (a + b) // 2
        hit = [c for c in covering[:bisect.bisect_right(starts, mid)] if c.end_ns >= mid]
        call = min(hit, key=lambda c: c.end_ns - c.start_ns) if hit else None
        name = call.name if call is not None else HOST_GAP
        s = spans.at(spans.thread, mid)
        own = spans.at(call.thread, mid) if call is not None else None
        out.append((f"{s.name}:{name}" if s is not None else name, (b - a) / 1e9,
                    own.name if own is not None else None))
    return out


STRIDE_2 = ("conv2", "conv3")


def _conv_bytes(name: str, side: int, div: int, k: int, cin: int, cout: int,
                batch: int) -> float:
    """The input, the weights and the output of one conv, once each (f32)."""
    h = side // div
    h_in = 2 * h if name in STRIDE_2 else h
    return (batch * h_in * h_in * cin + k * k * cin * cout + batch * h * h * cout) * counts.F32


def library_convs_bound_s(batch: int, side: int) -> float:
    """Least time of the six library convs of one serving forward (f32):
    517.0 GFLOP at batch 64 and 256 px, bound by the operations (7.72 ms)."""
    flops = nbytes = 0.0
    for name, div, k, cin, cout in counts.TRANSFORMNET_CONVS:
        if "tn." + name in LIBRARY_CONVS:
            flops += batch * counts._conv_flops(side, div, k, cin, cout)
            nbytes += _conv_bytes(name, side, div, k, cin, cout, batch)
    return peaks.bound_s(flops, nbytes)[0]


def tn_conv_backward_bound_s(batch: int, side: int) -> float:
    """Least time of the transform net's conv backward in one training step
    (f32): the weight gradients of the 16 convs and the input gradients of
    15 (conv1's input takes none), each the operations of its forward:
    4 x (2 x 20.16 - 1.019) = 157.2 GFLOP at batch 4 and 256 px (2.35 ms)."""
    flops = nbytes = 0.0
    for i, (name, div, k, cin, cout) in enumerate(counts.TRANSFORMNET_CONVS):
        grads = 1 if i == 0 else 2
        flops += grads * batch * counts._conv_flops(side, div, k, cin, cout)
        nbytes += grads * _conv_bytes(name, side, div, k, cin, cout, batch)
    return peaks.bound_s(flops, nbytes)[0]
