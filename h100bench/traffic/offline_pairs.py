"""Offline pairs: a closed loop of AdaIN's serving forward
(``engines/adain.py::make_serve_fn``: a content batch and a style batch,
uint8 in, uint8 out) over seeded batches already on the device.

Mix parameters: ``batch`` (pairs a call), ``pool`` (content batches and
style batches made at set-up, as many of each), ``inflight`` (calls queued
ahead of the one the host waits for), ``sample`` (calls whose outputs a
seeded reservoir keeps for the check), ``traced_calls``, ``block`` (pairs
the reference computes at once). Every pair has a style of its own: call n
takes content batch ``n % pool`` and style batch ``perm[(n % pool + n //
pool + shift) % pool]``, ``perm`` and ``shift`` drawn from the seed, so that
no pairing of batches repeats within ``pool ** 2`` calls.

The window ends at a synchronize; ``stylize_img_per_s`` is every content
image of every call over the whole window. In a traced run the first
``UNTRACED_SHARE`` of the window is timed without the profiler (for
``mfu.adain``), then ``traced_calls`` calls run under it and under the
program's span recording, joined by ``spans.py``: the per-layer metrics read
the device seconds of each span, and the layers' milliseconds a call go to
standard error.

``correct`` compares the sampled calls with the plain reference
(``reference/adain.py``, f32, TF32 off) in blocks of ``block`` pairs:
``excess_levels``, the largest gap of an output level to the unrounded
reference less the half level of rounding, and ``mean_levels``, the mean gap
to the rounded reference. The share of the reference's levels that clamp at
0 or 255 goes to standard error.
"""

from __future__ import annotations

import json
import random
import sys
import time
from collections import deque

from h100bench import counts_adain, harness, inputs, inputs_adain, spans
from h100bench import trace as trace_lib
from h100bench.reference import adain as ref
# The program's AdaIN: a checkout without it fails here, before any set-up.
from styletransfer_tpu_torch.engines import adain as engine
from styletransfer_tpu_torch.models import adain as model

UNITS = {"stylize_img_per_s": "img/s"}
UNTRACED_SHARE = 0.6


def pairing(seed: int, pool: int):
    """The style batch of call n: ``style_of(n)``."""
    rng = random.Random(seed)
    perm = rng.sample(range(pool), pool)
    shift = rng.randrange(pool)
    return lambda n: perm[(n % pool + n // pool + shift) % pool]


def _loop(serve, params, contents, styles, style_of, first, seconds, inflight, keep, torch):
    """Calls from call number ``first`` until ``seconds`` have passed, at
    most ``inflight`` queued ahead; returns (calls, seconds to the final
    synchronize)."""
    done = deque()
    n = 0
    t0 = time.monotonic()
    while time.monotonic() - t0 < seconds:
        if len(done) > inflight:
            done.popleft().synchronize()
        i = first + n
        out = serve(params, contents[i % len(contents)], styles[style_of(i)])
        keep(i, out)
        ev = torch.cuda.Event() if out.is_cuda else None
        if ev is not None:
            ev.record()
            done.append(ev)
        n += 1
    if contents[0].is_cuda:
        torch.cuda.synchronize()
    return n, time.monotonic() - t0


def run(run: harness.Run) -> harness.Outcome:
    import torch
    from styletransfer_tpu_torch.ops.cuda import conv3x3, upconv_phase

    t, cfg, dev = run.traffic, run.config, run.device
    side, style_side = cfg["image_side"], cfg["style_side"]
    vgg, dec = inputs_adain.weights(run.seed, dev, cfg)
    params = model.import_torch_state_dict(vgg, dec, device=dev)
    g_content = inputs.generator(dev, run.seed, inputs.IMAGES)
    g_style = inputs.generator(dev, run.seed, inputs.STYLE)
    contents = [inputs.images(t["batch"], side, g_content, dev) for _ in range(t["pool"])]
    styles = [inputs.images(t["batch"], style_side, g_style, dev) for _ in range(t["pool"])]
    style_of = pairing(run.seed, t["pool"])
    serve = engine.make_serve_fn(precision=cfg["precision"])
    alpha = cfg["alpha"]

    def call(p, content, style):
        return serve(p, content, style, alpha)

    for i in range(2):
        call(params, contents[i % t["pool"]], styles[style_of(i)])
    if dev.type == "cuda":
        torch.cuda.synchronize()

    rng = random.Random(run.seed)
    kept = []
    seen = [0]

    def keep(n, out):
        """A seeded reservoir of (content index, style index, output)."""
        seen[0] += 1
        item = (n % t["pool"], style_of(n), out)
        if len(kept) < t["sample"]:
            kept.append(item)
        else:
            j = rng.randrange(seen[0])
            if j < t["sample"]:
                kept[j] = item

    layer = {}
    run.window_starts()
    if not run.trace:
        calls, secs = _loop(call, params, contents, styles, style_of, 0, run.seconds,
                            t["inflight"], keep, torch)
        e2e = {"stylize_img_per_s": calls * t["batch"] / secs}
    else:
        calls, secs = _loop(call, params, contents, styles, style_of, 0,
                            run.seconds * UNTRACED_SHARE, t["inflight"], keep, torch)
        layer["model_flops_per_s"] = (calls * t["batch"]
                                      * counts_adain.pair_flops(side, style_side) / secs)
        tr = trace_lib.Trace()
        u0, c0 = upconv_phase.launches, conv3x3.launches
        with spans.recording() as rec:
            with trace_lib.traced(dev, tr, defer=True):
                for i in range(calls, calls + t["traced_calls"]):
                    keep(i, call(params, contents[i % t["pool"]], styles[style_of(i)]))
                if dev.type == "cuda":
                    torch.cuda.synchronize()
        if rec is not None and tr.prof is not None:
            ops, launches = spans.events(tr.prof)
            by = spans.by_span(ops, launches, spans.Spans.of(rec))
            layer["span_s"] = {k: v for k, v in by.items() if k is not None}
            print("offline_pairs: device ms a call by span " + json.dumps(
                {str(k): round(1e3 * v / t["traced_calls"], 4)
                 for k, v in sorted(by.items(), key=lambda kv: -kv[1])}),
                file=sys.stderr, flush=True)
        tr.read()
        calls += t["traced_calls"]
        layer.update(trace=tr, forwards=t["traced_calls"],
                     upconv_phase_calls=upconv_phase.launches - u0,
                     conv3x3_valid_calls=conv3x3.launches - c0,
                     batch=t["batch"], side=side, style_side=style_side)
        e2e = {}
    samples = list(kept)
    del params, serve, kept

    def verify():
        b = t["block"]
        worst, gaps, clamped, levels = 0.0, [], 0, 0
        with ref.precision(tf32=False):
            for ci, si, out in samples:
                for i in range(0, t["batch"], b):
                    c = contents[ci][i:i + b].permute(0, 3, 1, 2).float() / 255.0
                    s = styles[si][i:i + b].permute(0, 3, 1, 2).float() / 255.0
                    r = ref.stylize(vgg, dec, c, s, alpha)
                    lv = (torch.clamp(r, 0.0, 1.0) * 255.0).permute(0, 2, 3, 1)
                    o = out[i:i + b].float()
                    worst = max(worst, float((o - lv).abs().max()))
                    gaps.append((o - torch.round(lv)).abs().mean())
                    clamped += int(((r <= 0.0) | (r >= 1.0)).sum())
                    levels += r.numel()
        print(f"offline_pairs: {clamped / levels:.6f} of the reference's levels clamp",
              file=sys.stderr, flush=True)
        return {"excess_levels": worst - 0.5, "mean_levels": float(torch.stack(gaps).mean())}

    return harness.Outcome(attempted=calls * t["batch"], failed=0, end_to_end=e2e,
                           verify=verify, layer=layer)
