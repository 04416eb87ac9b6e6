"""A traced run of a cell with the program's spans joined to its trace.

    python -m h100bench.spanrun --workload <cell> --seed <n> --seconds <s>

Runs the cell as ``--trace 1`` does (``harness.execute``) with two
additions, planted for the length of the run:

- the profiled stretch runs under the program's ``record_spans()``, and its
  device operations are joined with the spans (``spans.py``) before the
  trace is reduced;
- after the window's untraced loop, the same loop runs again for
  ``SPANS_SHARE`` of the window under ``record_spans()`` alone: its rate
  against the untraced loop's is what the spans cost, and its host spans
  give the step's issue time and the prefetch queue's wait; a training
  loop then runs ``UNQUEUED_SHARE`` of the window with no step in flight
  (each waits for the one before), so that a step's host time is its own
  issue work, not waiting for a full launch queue.

Prints the harness's result line, then one JSON line of what the joins
read: the five span metrics (``library_convs_roofline.serve``,
``tn_conv_backward_roofline.train``, ``issue_ms.train``,
``loader_wait_ms.train``, ``host_bound_idle.train``), the share of kernel
time the spans hold, the kernels whose name and span disagree, and the idle
gaps named by span.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from typing import Any, Dict, Iterator, List

from h100bench import groups, harness, spans
from h100bench import trace as trace_lib

SPANS_SHARE = 0.2
UNQUEUED_SHARE = 0.05
HOST_SPANS = ("train.step", "train.forward", "train.loss", "train.backward", "train.optimizer",
              "data.wait", "data.load", "data.copy")


def _traced(original, got: Dict[str, Any]):
    @contextlib.contextmanager
    def traced(device, out, host=True, defer=False) -> Iterator[None]:
        with spans.recording() as rec:
            with original(device, out, host, defer=True):
                t0 = time.time_ns()
                yield
                t1 = time.time_ns()
        got["profiled"] = (*spans.events(out.prof), rec, t0, t1)
        if not defer:
            out.read()

    return traced


class _Done:
    """A training loop's stretch that keeps nothing."""

    done = True

    @staticmethod
    def step(n, step, params, opt, batch) -> None:
        step(params, opt, batch)


def _offline_loop(original, got, seconds):
    def loop(serve, params, pool, secs, inflight, keep, torch):
        n, took = original(serve, params, pool, secs, inflight, keep, torch)
        got["untraced"] = (n, took)
        with spans.recording() as rec:
            got["spans"] = (*original(serve, params, pool, seconds * SPANS_SHARE, inflight,
                                      lambda *_: None, torch), rec)
        return n, took

    return loop


def _train_loop(original, got, seconds):
    def loop(step, params, opt, feed, secs, inflight, stretch, torch, cuda):
        result = original(step, params, opt, feed, secs, inflight, stretch, torch, cuda)
        if secs > 0:  # the window's loop, not set-up's
            got["untraced"] = result[:2]
            with spans.recording() as rec:
                n, took, _, _ = original(step, params, opt, feed, seconds * SPANS_SHARE,
                                         inflight, _Done(), torch, cuda)
            got["spans"] = (n, took, rec)
            with spans.recording() as rec:
                n, took, _, _ = original(step, params, opt, feed, seconds * UNQUEUED_SHARE, 0,
                                         _Done(), torch, cuda)
            got["unqueued"] = (n, took, rec)
        return result

    return loop


def _host_ms(stretch: "spans.Spans", steps: int) -> Dict[str, float]:
    """Host milliseconds a step in each of ``HOST_SPANS``."""
    return {name: sum(s.end_ns - s.start_ns for s in stretch.named(name)) / steps / 1e6
            for name in HOST_SPANS}


def _report(kind: str, mix: Dict[str, Any], config: Dict[str, Any],
            got: Dict[str, Any]) -> Dict[str, Any]:
    ops, calls, rec, t0, t1 = got["profiled"]
    n_untraced, s_untraced = got["untraced"][:2]
    n_spans, s_spans, srec = got["spans"]
    out: Dict[str, Any] = {"kind": kind, "device_ops": len(ops)}
    if rec is None or srec is None:
        out["spans"] = "the program records no spans"
        return out
    out["spans_rate_over_untraced"] = (n_spans / s_spans) / (n_untraced / s_untraced)
    if kind == "train":
        stretch = spans.Spans.of(srec)
        step_ns = [s.end_ns - s.start_ns for s in stretch.named("train.step")]
        wait_ns = [s.end_ns - s.start_ns for s in stretch.named("data.wait")]
        out["issue_ms.train"] = sum(step_ns) / len(step_ns) / 1e6 if step_ns else None
        out["loader_wait_ms.train"] = sum(wait_ns) / n_spans / 1e6 if n_spans else None
        out["spans_stretch_steps"] = n_spans
        out["untraced_step_ms"] = 1e3 * s_untraced / n_untraced
        out["host_ms_per_step"] = _host_ms(stretch, n_spans)
        n_unq, s_unq, urec = got["unqueued"]
        out["unqueued_steps"], out["unqueued_step_ms"] = n_unq, 1e3 * s_unq / n_unq
        out["unqueued_host_ms_per_step"] = _host_ms(spans.Spans.of(urec), n_unq)
    if not ops:
        return out
    index = spans.Spans.of(rec)
    by = spans.by_span(ops, calls, index)
    out["covered_share"] = 1.0 - by.get(None, 0.0) / sum(by.values())
    out["device_s_by_span"] = {str(k): v for k, v in sorted(by.items(), key=lambda kv: -kv[1])}
    out["launched"] = sum(op.correlation in calls for op in ops) / len(ops)
    out["window_s"] = (t1 - t0) / 1e9
    out["busy_s"] = sum(b - a for a, b in spans.busy(ops, t0, t1)) / 1e9
    out["idle_gaps"] = spans.gaps(ops, calls, index, t0, t1)
    disagree: List[List[Any]] = []
    for op in ops:
        s = index.of_launch(calls.get(op.correlation))
        name = s.name if s is not None else ""
        grp = groups.group(op.name)
        if kind == "offline":
            bad = ((grp == "cudnn_conv" and name not in spans.LIBRARY_CONVS)
                   or (grp == "conv3x3_valid" and not name.startswith("tn.res")))
        else:
            low = op.name.lower()
            bad = ("dgrad" in low or "wgrad" in low) and not name.endswith(spans.BWD)
        if bad:
            disagree.append([op.name[:80], name])
    out["disagreeing_kernels"] = len(disagree)
    out["disagreeing_examples"] = disagree[:10]
    side = config["image_side"]
    if kind == "offline":
        conv_s = sum(by.get(n, 0.0) for n in spans.LIBRARY_CONVS)
        bound = spans.library_convs_bound_s(mix["batch"], side) * mix["traced_calls"]
        out["library_convs_roofline.serve"] = 100.0 * bound / conv_s if conv_s else None
    else:
        bwd_s = sum(v for k, v in by.items() if k and k.endswith(spans.BWD))
        bound = spans.tn_conv_backward_bound_s(mix["batch"], side) * mix["traced_steps"]
        out["tn_conv_backward_roofline.train"] = 100.0 * bound / bwd_s if bwd_s else None
        out["host_bound_idle.train"] = 100.0 * spans.host_bound_s(ops, calls, t0, t1) / (
            (t1 - t0) / 1e9)
    return out


def spanned(cell_name: str, seed: int, seconds: float, device, t_start: float,
            traffic_overrides=None, config_overrides=None):
    """``harness.execute`` of a traced run with the spans planted; returns
    its result line and what the joins read."""
    cell = harness.load_json("cells", cell_name)
    kind = harness.kind_module(cell["kind"])
    mix = {**cell["mix"], **(traffic_overrides or {})}
    config = {**harness.load_json("configs", cell["config"]), **(config_overrides or {})}
    got: Dict[str, Any] = {}
    plant = {"offline": _offline_loop, "train": _train_loop}[cell["kind"]]
    original_traced, original_loop = trace_lib.traced, kind._loop
    trace_lib.traced = _traced(original_traced, got)
    kind._loop = plant(original_loop, got, seconds)
    try:
        line = harness.execute(cell_name, seed, seconds, True, device, t_start,
                               traffic_overrides, config_overrides)
    finally:
        trace_lib.traced, kind._loop = original_traced, original_loop
    return line, _report(cell["kind"], mix, config, got)


def main(argv=None) -> int:
    t_start = time.monotonic()
    ap = argparse.ArgumentParser(prog="python -m h100bench.spanrun", description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("spanrun: needs a CUDA device", file=sys.stderr)
        return 2
    print(f"spanrun: {args.workload} seed {args.seed} on {harness.card_line()}",
          file=sys.stderr, flush=True)
    line, report = spanned(args.workload, args.seed, args.seconds, "cuda", t_start)
    print(json.dumps(line), flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
