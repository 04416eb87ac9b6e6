"""The port's spans (``utils/profiling.py``): the recorder, its clock, the
transform net's layer spans forward and backward, the training step's and
the prefetch queue's spans, the join with a device trace, and outputs that
do not change while spans are recorded."""

from __future__ import annotations

import contextlib
import json
import os
import threading

import numpy as np
import pytest
import torch

from styletransfer_tpu_torch.engines import fast
from styletransfer_tpu_torch.models import transformer, vgg
from styletransfer_tpu_torch.parallel import prefetch
from styletransfer_tpu_torch.utils import profiling
from styletransfer_tpu_torch.utils.profiling import DeviceOp, Launch, Span, SpanRecording

CONVS = (["conv1", "conv2", "conv3"]
         + [f"res{i}.conv{j}" for i in range(1, 6) for j in (1, 2)]
         + ["up1_conv", "up2_conv", "conv_out"])
FORWARD = (["conv1", "in1", "conv2", "in2", "conv3", "in3"]
           + [f"res{i}.{layer}" for i in range(1, 6)
              for layer in ("conv1", "in1", "conv2", "in2")]
           + ["up1_conv", "up1_in", "up2_conv", "up2_in", "conv_out"])
TN_FORWARD = ["tn." + n for n in FORWARD]
TN_BACKWARD = ["tn." + n + ".bwd" for n in reversed(CONVS)]


def _params():
    return transformer.init_params(seed=0, device="cpu")


def _batch(n=2, side=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, side, side, 3), generator=g) * 255.0


def _names(rec, prefix=""):
    return [s.name for s in sorted(rec.spans, key=lambda s: s.start_ns)
            if s.name.startswith(prefix)]


# --- the recorder -------------------------------------------------------------------

def test_span_while_nothing_records_is_one_shared_no_op():
    a, b = profiling.span("a"), profiling.span("b")
    assert a is b is profiling._NO_SPAN
    with a as inside:
        assert inside is None
    with profiling.record_spans() as rec:
        pass
    assert rec.spans == [] and rec.closed
    assert profiling.span("c") is profiling._NO_SPAN


def test_spans_nest_and_name_their_causes_on_one_thread():
    with profiling.record_spans() as rec:
        with profiling.span("outer"):
            with profiling.span("inner"):
                with profiling.span("leaf"):
                    pass
            with profiling.span("sibling"):
                pass
    by = {s.name: s for s in rec.spans}
    assert [s.name for s in rec.spans] == ["leaf", "inner", "sibling", "outer"]
    assert by["outer"].cause is None
    assert by["inner"].cause == by["sibling"].cause == by["outer"].id
    assert by["leaf"].cause == by["inner"].id
    me = threading.get_native_id()
    assert {s.thread for s in rec.spans} == {me} and rec.thread == me
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
        if s.cause is not None:
            parent = next(p for p in rec.spans if p.id == s.cause)
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns


def test_a_second_thread_records_its_own_spans_with_no_cause_across_threads():
    seen = {}

    def work():
        seen["native"] = threading.get_native_id()
        seen["ident"] = threading.get_ident()
        with profiling.span("worker"):
            with profiling.span("worker.inner"):
                pass

    with profiling.record_spans() as rec:
        with profiling.span("main"):
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=10)
    assert not t.is_alive()
    by = {s.name: s for s in rec.spans}
    assert by["worker"].thread == seen["native"] != by["main"].thread
    assert by["worker"].cause is None and by["worker.inner"].cause == by["worker"].id
    assert rec.idents[seen["ident"]] == seen["native"]


def test_one_recording_at_a_time_and_spans_after_it_are_dropped():
    with profiling.record_spans() as rec:
        with pytest.raises(RuntimeError):
            with profiling.record_spans():
                pass
        open_span = profiling.span("outlives")
        open_span.__enter__()
    open_span.__exit__(None, None, None)
    assert rec.spans == []
    assert profiling._recording is None


def test_many_threads_append_every_span():
    per, threads = 200, 8

    def work():
        for _ in range(per):
            with profiling.span("t"):
                pass

    with profiling.record_spans() as rec:
        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    assert len(rec.spans) == per * threads
    assert len({s.id for s in rec.spans}) == per * threads


def test_spans_lie_on_the_profilers_clock():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.record_spans() as rec:
            with profiling.span("around"):
                with torch.profiler.record_function("region"):
                    x = torch.ones(64, 64)
                    (x @ x).sum()
    (region,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "region"]
    (around,) = rec.spans
    start, end = region.start_ns(), region.start_ns() + region.duration_ns()
    assert abs(around.start_ns - start) < 1_000_000 and abs(around.end_ns - end) < 1_000_000
    assert around.start_ns <= start + 1_000_000 and end <= around.end_ns + 1_000_000


# --- the transform net ---------------------------------------------------------------

@pytest.mark.parametrize("pad_mode", ["reflect", "zeros"])
def test_apply_marks_its_31_layers_in_forward_order(pad_mode):
    params = _params()
    with profiling.record_spans() as rec:
        with profiling.span("serve"):
            transformer.apply(params, _batch(), pad_mode=pad_mode)
    assert _names(rec, "tn.") == TN_FORWARD
    serve = next(s for s in rec.spans if s.name == "serve")
    assert all(s.cause == serve.id for s in rec.spans if s.name.startswith("tn."))


def test_apply_stacked_backward_marks_the_16_convs_caused_by_the_backwards_span():
    params = _params()
    with profiling.record_spans() as rec:
        with profiling.span("forward"):
            out = transformer.apply_stacked(params, _batch())
        with profiling.span("backward"):
            out.square().mean().backward()
    assert _names(rec, "tn.") == TN_FORWARD + TN_BACKWARD
    backward = next(s for s in rec.spans if s.name == "backward")
    for s in rec.spans:
        if s.name.endswith(".bwd"):
            assert s.cause == backward.id
            assert backward.start_ns <= s.start_ns <= s.end_ns <= backward.end_ns


def test_each_conv_backward_span_holds_its_layers_convolution_backward():
    params = _params()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with profiling.record_spans() as rec:
            out = transformer.apply_stacked(params, _batch())
            out.square().mean().backward()
    # conv_out's backward is its Conv9x9Function's node (ops/cuda/conv9x9.py),
    # the other 15 convs' cuDNN's convolution backward.
    nodes = [e for e in prof.profiler.kineto_results.events()
             if ("ConvolutionBackward" in e.name() or "Conv9x9FunctionBackward" in e.name())
             and "evaluate_function" in e.name()]
    assert len(nodes) == 16
    assert sum("Conv9x9FunctionBackward" in e.name() for e in nodes) == 1
    bwd = sorted((s for s in rec.spans if s.name.endswith(".bwd")), key=lambda s: s.start_ns)
    slack = 200_000  # the two clocks' readings, a fraction of a conv's backward
    for node, s in zip(sorted(nodes, key=lambda e: e.start_ns()), bwd):
        assert s.start_ns - slack <= node.start_ns()
        assert node.start_ns() + node.duration_ns() <= s.end_ns + slack
        assert not any(o is not s and o.start_ns < node.start_ns() < o.end_ns for o in bwd)


def test_a_forward_while_nothing_records_registers_no_backward_span():
    params = _params()
    out = transformer.apply_stacked(params, _batch())
    with profiling.record_spans() as rec:
        out.square().mean().backward()
    assert rec.spans == []


def test_sanet_marks_its_35_layers_under_the_forward_and_an_attention_span_a_block():
    from styletransfer_tpu_torch.engines import sanet as sanet_engine
    from styletransfer_tpu_torch.models import sanet

    params = sanet.init_params(seed=0, device="cpu")
    content = _batch(1, 64, seed=2).to(torch.uint8)
    style = _batch(1, 64, seed=3).to(torch.uint8)
    with profiling.record_spans() as rec:
        sanet_engine.make_serve_fn()(params, content, style)
    names = _names(rec, "sanet.")
    assert len(names) == 1 + 17 + 8 + 1 + 9 and names[0] == "sanet.forward"
    assert [n for n in names if n.endswith(".attn")] == ["sanet.r4_1.attn", "sanet.r5_1.attn"]
    assert "sanet.enc.pool4" in names and "sanet.enc.conv5_1" in names
    forward = next(s for s in rec.spans if s.name == "sanet.forward")
    assert all(s.cause == forward.id for s in rec.spans if s.name != "sanet.forward")
    assert not any(n.startswith("adain.") for n in _names(rec))


def _train_setup(side=32):
    params = _params()
    vgg_params = vgg.init_params(seed=0, device="cpu")
    grams = vgg.style_gram_targets(vgg_params, _batch(1, side, seed=1) / 255.0)
    step = fast.make_train_step(vgg_params, grams)
    return params, fast.make_optimizer(params), step


def test_train_step_marks_the_step_and_its_four_parts():
    params, opt, step = _train_setup()
    with profiling.record_spans() as rec:
        step(params, opt, _batch())
    by = {s.name: s for s in rec.spans}
    (step_span,) = [s for s in rec.spans if s.name == "train.step"]
    parts = ["train.forward", "train.loss", "train.backward", "train.optimizer"]
    assert [n for n in _names(rec, "train.") if n != "train.step"] == parts
    assert all(by[p].cause == step_span.id for p in parts)
    assert all(by[n].cause == by["train.forward"].id for n in TN_FORWARD)
    assert all(by[n].cause == by["train.backward"].id for n in TN_BACKWARD)
    assert _names(rec, "tn.") == TN_FORWARD + TN_BACKWARD


def test_prefetch_marks_load_and_copy_on_the_producer_and_wait_on_the_consumer():
    batches = [np.full((2, 4, 4, 3), i, np.uint8) for i in range(3)]
    with profiling.record_spans() as rec:
        got = list(prefetch.prefetch_to_device(iter(batches), torch.device("cpu")))
    assert [int(b[0, 0, 0, 0]) for b in got] == [0, 1, 2]
    threads = {}
    for s in rec.spans:
        threads.setdefault(s.name, set()).add(s.thread)
    count = {n: sum(s.name == n for s in rec.spans) for n in threads}
    # One more load and wait than batches: the end of the iterator.
    assert count == {"data.load": 4, "data.copy": 3, "data.wait": 4}
    assert threads["data.wait"] == {threading.get_native_id()}
    assert threads["data.load"] == threads["data.copy"] != threads["data.wait"]


def test_outputs_are_bit_identical_with_and_without_a_recording():
    x = _batch()
    params = _params()
    plain = transformer.apply(params, x)
    with profiling.record_spans():
        spanned = transformer.apply(params, x)
    assert torch.equal(plain, spanned)

    results = []
    for record in (False, True):
        params, opt, step = _train_setup()
        with profiling.record_spans() if record else contextlib.nullcontext():
            metrics = step(params, opt, x)
        results.append((float(metrics["total"]),
                        [p.detach().clone() for p in params.parameters()]))
    (l0, p0), (l1, p1) = results
    assert l0 == l1 and all(torch.equal(a, b) for a, b in zip(p0, p1))


# --- the join -----------------------------------------------------------------------

def _rec(spans, thread=1, idents=None):
    rec = SpanRecording()
    rec.spans, rec.thread, rec.idents = list(spans), thread, dict(idents or {})
    return rec


def test_attribute_takes_the_launching_threads_innermost_span_else_the_recordings():
    # Without the host's activity a trace names a thread by the low 32 bits
    # of its get_ident(), signed (as the card's profiler does).
    rec = _rec([Span(0, "step", 1, 0, 100, None), Span(1, "fwd", 1, 10, 40, 0),
                Span(2, "bwd.conv", 2, 50, 70, 0), Span(3, "copy", 3, 50, 60, None)],
               thread=1, idents={0x7F9BE8155300: 2, 0x7F987A9FF6C0: 3})
    ops = [DeviceOp("k_fwd", 11, 200, 210), DeviceOp("k_bwd", 12, 210, 230),
           DeviceOp("k_other", 13, 230, 260), DeviceOp("k_none", 14, 260, 262),
           DeviceOp("k_unlaunched", 15, 262, 263), DeviceOp("memcpy", 16, 263, 270)]
    calls = {11: Launch("cudaLaunchKernel", 11, 1, 20, 22),
             12: Launch("cudaLaunchKernel", 12, -401255680, 55, 57),  # thread 2's ident
             13: Launch("cudaLaunchKernel", 13, 2, 80, 81),      # thread 2, no span open
             14: Launch("cudaLaunchKernel", 14, 1, 150, 151),    # after every span
             16: Launch("cudaMemcpyAsync", 16, 2057303744, 52, 53)}  # thread 3's ident
    got = profiling.attribute(ops, calls, rec)
    assert got == pytest.approx({"fwd": 10e-9, "bwd.conv": 20e-9, "step": 30e-9,
                                 "copy": 7e-9, None: 3e-9})


def test_busy_is_the_union_of_device_intervals_inside_the_stretch():
    ops = [DeviceOp("a", 1, 0, 10), DeviceOp("b", 2, 5, 20), DeviceOp("c", 3, 30, 40),
           DeviceOp("d", 4, 35, 38), DeviceOp("e", 5, 90, 120)]
    assert profiling.busy_ns(ops, 0, 100) == 20 + 10 + 10
    assert profiling.busy_ns(ops, 8, 36) == 12 + 6


def test_summarize_takes_busy_and_idle_from_the_profiled_stretch_per_call():
    rec = _rec([Span(0, "tn.conv1", 1, 0, 50, None)])
    ops = [DeviceOp("sm80_xmma_fprop_implicit_gemm", 1, 100, 400),
           DeviceOp("conv3x3_f32_kernel", 2, 400, 600)]
    calls = {1: Launch("cudaLaunchKernel", 1, 1, 10, 12),
             2: Launch("cudaLaunchKernel", 2, 1, 60, 62)}
    r = profiling.summarize(ops, calls, rec, 0, 1000, iters=2)
    assert r["profiled_wall_ms"] == pytest.approx(1000 / 1e6 / 2)
    assert r["device_busy_ms"] == pytest.approx(500 / 1e6 / 2)
    assert r["idle_share"] == pytest.approx(0.5)
    assert r["span_ms"] == pytest.approx({"tn.conv1": 300 / 1e6 / 2, "None": 200 / 1e6 / 2})
    assert r["groups_ms"]["cuDNN convolutions"] == pytest.approx(300 / 1e6 / 2)


def test_trace_writes_the_spans_on_their_threads_tracks(tmp_path):
    with profiling.trace(str(tmp_path / "profile"), device="cpu"):
        with profiling.span("region.span"):
            with torch.profiler.record_function("region.op"):
                x = torch.ones((16, 16))
                (x @ x).sum()
    (name,) = os.listdir(tmp_path / "profile")
    events = json.loads((tmp_path / "profile" / name).read_text())["traceEvents"]
    (sp,) = [e for e in events if e.get("cat") == "span"]
    (op,) = [e for e in events if e.get("name") == "region.op" and e.get("ph") == "X"]
    assert sp["name"] == "region.span" and sp["ph"] == "X"
    assert sp["pid"] == os.getpid() and sp["tid"] == threading.get_native_id() == op["tid"]
    assert abs(sp["ts"] - op["ts"]) < 1000 and sp["ts"] <= op["ts"] + 1000
    assert sp["ts"] + sp["dur"] >= op["ts"] + op["dur"] - 1000
