"""The join of the program's spans with a device trace (``spans.py``) on
synthetic event lists, the bounds of the layers it reads, and
``spanrun.py`` on the CPU at a tiny size. On the card (the ``cuda``
marker), a span around a synchronize ends just after the kernel it waited
for, on the trace's clock.

    python -m pytest h100bench -q                       # here
    python -m pytest h100bench -q -m cuda --noconftest  # on the GPU machine
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import pytest

from h100bench import spanrun, spans
from h100bench.spans import Call, Op


class S(NamedTuple):
    """A span as the program records it."""

    id: int
    name: str
    thread: int
    start_ns: int
    end_ns: int
    cause: Optional[int] = None


def _launch(corr, thread, start, end):
    return Call("cudaLaunchKernel", corr, thread, start, end)


def test_the_layer_bounds_match_the_hand_worked_numbers():
    # Serving: conv1 81*3*32 MACs a pixel at 65,536 pixels, conv2 9*32*64 at
    # 16,384, conv3 9*64*128 at 4,096, up1_conv 9*128*64 at 16,384, up2_conv
    # 9*64*32 and conv_out 81*32*3 at 65,536: 4.039 G MACs an image, 517.0
    # GFLOP at batch 64, over 67 TFLOP/s. Training: every conv's weight
    # gradient and every input gradient but conv1's, each its forward's
    # operations: 4 x (2 x 20.158 - 1.019) = 157.2 GFLOP.
    assert spans.library_convs_bound_s(64, 256) * 67e12 / 1e9 == pytest.approx(517.0, abs=0.05)
    assert spans.library_convs_bound_s(64, 256) * 1e3 == pytest.approx(7.7165, abs=1e-4)
    assert spans.tn_conv_backward_bound_s(4, 256) * 67e12 / 1e9 == pytest.approx(157.2, abs=0.05)
    assert spans.tn_conv_backward_bound_s(4, 256) * 1e3 == pytest.approx(2.3461, abs=1e-4)


def test_an_operation_belongs_to_the_innermost_span_of_its_launching_thread():
    index = spans.Spans([S(0, "train.step", 1, 0, 1000), S(1, "train.forward", 1, 10, 400, 0),
                         S(2, "tn.conv1", 1, 20, 60, 1), S(3, "tn.conv1.bwd", 2, 500, 600, 0)],
                        thread=1)
    ops = [Op("fprop", 1, 2000, 2100), Op("in_kernel", 2, 2100, 2150),
           Op("dgrad", 3, 2150, 2400)]
    calls = {1: _launch(1, 1, 30, 35), 2: _launch(2, 1, 70, 75), 3: _launch(3, 2, 550, 560)}
    assert spans.by_span(ops, calls, index) == pytest.approx(
        {"tn.conv1": 100e-9, "train.forward": 50e-9, "tn.conv1.bwd": 250e-9})


def test_a_foreign_thread_with_no_span_takes_the_recording_threads_span():
    # The card's profiler names a thread by its native id where it recorded
    # the host's activity, else by the low 32 bits of its ident, signed.
    index = spans.Spans([S(0, "train.backward", 1, 0, 100), S(1, "data.copy", 3, 0, 10)],
                        thread=1, idents={0x7F9BE8155300: 3})
    ops = [Op("fft", 1, 200, 230), Op("memcpy", 2, 230, 240), Op("late", 3, 240, 241)]
    calls = {1: _launch(1, 2, 50, 52),                             # a thread with no span
             2: Call("cudaMemcpyAsync", 2, -401255680, 5, 6),      # thread 3, by its ident
             3: _launch(3, 2, 150, 151)}                           # after every span
    assert spans.by_span(ops, calls, index) == pytest.approx(
        {"train.backward": 30e-9, "data.copy": 10e-9, None: 1e-9})


@pytest.mark.parametrize("launch, host_bound", [
    ((120, 130), 50),   # late: the launch began after the card went idle
    ((90, 115), 50),    # still in its launch call when the card went idle
    ((40, 60), 0),      # early: launched before, the card waited on something else
])
def test_an_idle_interval_is_the_hosts_while_the_next_operation_was_being_launched(
        launch, host_bound):
    ops = [Op("a", 1, 50, 100), Op("b", 2, 150, 200)]
    calls = {1: _launch(1, 1, 0, 10), 2: _launch(2, 1, *launch)}
    assert spans.host_bound_s(ops, calls, 50, 200) == pytest.approx(host_bound * 1e-9)


def test_the_stretchs_edges_count_as_idle_by_the_same_rule():
    ops = [Op("a", 1, 20, 100)]
    calls = {1: _launch(1, 1, 5, 12)}
    # Before the first operation: launched after the stretch began. After
    # the last: nothing ended it, so it is not the host's by this rule.
    assert [(a, b) for a, b, _ in spans.idle(ops, 0, 150)] == [(0, 20), (100, 150)]
    assert spans.host_bound_s(ops, calls, 0, 150) == pytest.approx(20e-9)
    assert spans.host_bound_s(ops, {}, 0, 150) == 0.0


def test_a_gap_takes_the_recording_threads_span_as_a_prefix():
    index = spans.Spans([S(0, "train.backward", 1, 100, 300), S(1, "data.wait", 1, 400, 500),
                         S(2, "data.copy", 2, 180, 220)], thread=1)
    ops = [Op("a", 1, 0, 150), Op("b", 2, 250, 420), Op("c", 3, 480, 490)]
    calls = {9: Call("cudaMemcpyAsync", 9, 2, 190, 210)}
    assert spans.gaps(ops, calls, index, 0, 600) == [
        ("host between ops", 110e-9, None),
        ("train.backward:cudaMemcpyAsync", 100e-9, "data.copy"),
        ("data.wait:host between ops", 60e-9, None)]


def test_a_program_without_spans_records_nothing(monkeypatch):
    from styletransfer_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "record_spans")
    with spans.recording() as rec:
        assert rec is None


@pytest.mark.parametrize("cell, mix", [
    ("transformnet.offline-b64", {"batch": 2, "pool": 2, "sample": 2, "traced_calls": 2}),
    ("transformnet.train-b4", {"batch": 2, "crops": 24, "traced_steps": 2,
                               "stretch_from": [1, 3]}),
])
def test_spanrun_plants_its_stretches_and_leaves_the_run_correct(cell, mix):
    from h100bench import trace as trace_lib
    from h100bench.traffic import offline, train

    before = (trace_lib.traced, offline._loop, train._loop)
    line, report = spanrun.spanned(cell, 2**31 + 23, 1.0, "cpu", time.monotonic(), mix,
                                   {"image_side": 32})
    assert line["correct"] is True and report["spans_rate_over_untraced"] > 0
    if cell == "transformnet.train-b4":
        assert report["issue_ms.train"] > 0 and report["loader_wait_ms.train"] >= 0
    assert (trace_lib.traced, offline._loop, train._loop) == before


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the trace's device clock")


@pytest.mark.cuda
def test_spans_and_the_device_trace_share_one_clock(card):
    """A launch call lies inside the span around it, and a span around a
    synchronize ends after the kernel it waited for, by under 50 µs in the
    best of nine tries: a synchronize wakes its thread up to a millisecond
    late on a shared host, so one try bounds the host's wake-up, not the
    clocks."""
    import torch

    from styletransfer_tpu_torch.utils import profiling

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    late = []
    for _ in range(9):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            with profiling.record_spans() as rec:
                with profiling.span("launch"):
                    torch.cuda._sleep(5_000_000)  # a few ms of spinning
                with profiling.span("sync"):
                    torch.cuda.synchronize()
        ops, calls = spans.events(prof)
        (spin,) = [op for op in ops if "spin" in op.name.lower() or "sleep" in op.name.lower()]
        launch, sync = sorted(rec.spans, key=lambda s: s.start_ns)
        call = calls[spin.correlation]
        assert launch.start_ns <= call.start_ns <= call.end_ns <= launch.end_ns
        assert spans.Spans.of(rec).of_launch(call).name == "launch"
        assert sync.end_ns >= spin.end_ns
        late.append(sync.end_ns - spin.end_ns)
    assert min(late) <= 50_000, late
