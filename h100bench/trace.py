"""The traced stretch of a run: ``torch.profiler`` over CPU and CUDA, and
its reduction to what the per-layer metrics read.

Device time is the union of the card's kernel, copy and set intervals
inside the stretch, which a span of the harness's own (``h100bench.window``)
bounds; the stretch's length is the host's clock around it. Each kernel's
time is grouped by name (``groups.py``). The breakdown names the device
operations that took most time and the longest idle gaps, each gap by the
innermost host activity that covered its middle.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from h100bench import groups

WINDOW_SPAN = "h100bench.window"
TOP = 10


class Trace:
    """What one traced stretch recorded."""

    def __init__(self) -> None:
        self.window_s = 0.0
        self.busy_s = 0.0
        self.kernel_s: Dict[str, float] = defaultdict(float)
        self.kernel_n: Dict[str, int] = defaultdict(int)
        self.device_ops: List[Tuple[str, float]] = []
        self.idle_gaps: List[Tuple[str, float]] = []
        self.parse_s = 0.0
        self.prof = None

    def group_s(self, name: str) -> float:
        return sum(s for k, s in self.kernel_s.items() if groups.group(k) == name)

    def read(self) -> None:
        """Reduce the recorded trace (once)."""
        if self.prof is not None:
            t0 = time.monotonic()
            _reduce(self.prof, self)
            self.prof = None
            self.parse_s = time.monotonic() - t0

    @property
    def kernels(self) -> int:
        return sum(self.kernel_n.values())

    @property
    def kernel_busy_s(self) -> float:
        return sum(self.kernel_s.values())


@contextlib.contextmanager
def traced(device: torch.device, out: Trace, host: bool = True,
           defer: bool = False) -> Iterator[None]:
    """Profile the enclosed stretch (which must end in a synchronize) and
    fill ``out``. ``host=False`` records the card's activity alone, for a
    stretch whose host threads the profiler's own work would slow; its idle
    gaps are then named "host between ops". ``defer=True`` leaves the
    reading of the trace to ``out.read()``, for when the work it would hold
    up is still running."""
    acts = [torch.profiler.ProfilerActivity.CPU] if host or device.type != "cuda" else []
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            t0 = time.monotonic()
            yield
            out.window_s = time.monotonic() - t0
    out.prof = prof
    if not defer:
        out.read()


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def _reduce(prof, out: Trace) -> None:
    window: Optional[Tuple[float, float]] = None
    device: List[Tuple[float, float]] = []
    host: List[Tuple[float, float, str]] = []
    for ev in prof.events():
        start, end = ev.time_range.start, ev.time_range.end  # microseconds
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            # A record_function range's device-side copy covers kernels
            # counted on their own.
            if getattr(ev, "is_user_annotation", False):
                continue
            out.kernel_s[ev.name] += (end - start) / 1e6
            out.kernel_n[ev.name] += 1
            device.append((start, end))
        elif ev.name == WINDOW_SPAN:
            window = (start, end)
        else:
            host.append((start, end, ev.name))
    if window is None:  # the host's activity was not recorded
        window = (min((a for a, _ in device), default=0.0), max((b for _, b in device),
                                                                default=0.0))
    w0, w1 = window
    busy = [(max(a, w0), min(b, w1)) for a, b in _union(device) if b > w0 and a < w1]
    out.busy_s = sum(b - a for a, b in busy) / 1e6
    out.device_ops = sorted(out.kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:TOP]
    for length, start in gaps:
        mid = start + length / 2
        covering = [(b - a, name) for a, b, name in host if a <= mid <= b]
        out.idle_gaps.append((min(covering)[1] if covering else "host between ops",
                             length / 1e6))
