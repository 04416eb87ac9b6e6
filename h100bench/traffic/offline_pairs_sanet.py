"""Offline SANet pairs: a closed loop of SANet's serving forward
(``engines/sanet.py::make_serve_fn``: a content batch and a style batch,
uint8 in, uint8 out) over seeded batches already on the device, as
``offline_pairs.py`` drives AdaIN's (its pairing and loop).

Mix parameters: ``batch`` (pairs a call), ``pool`` (content batches and
style batches made at set-up, as many of each), ``inflight`` (calls queued
ahead of the one the host waits for), ``sample`` (calls whose outputs a
seeded reservoir keeps for the check), ``traced_calls``, ``block`` (pairs
the reference computes at once: its [Nq, Nk] score matrix is 1.07 GB a pair
at relu4_1 and 1024 px). Every pair has a style of its own, by
``offline_pairs.pairing``.

The window ends at a synchronize; ``stylize_img_per_s`` is every content
image of every call over the whole window. In a traced run the first
``UNTRACED_SHARE`` of the window is timed without the profiler (for
``mfu.sanet``), then ``traced_calls`` calls run under it and under the
program's span recording, joined by ``spans.py``: the per-layer metrics read
the device seconds of each span, and the layers' milliseconds a call go to
standard error.

``correct`` compares the sampled calls with the plain reference
(``reference/sanet.py``, f32, TF32 off) in blocks of ``block`` pairs:
``excess_levels``, the largest gap of an output level to the unrounded
reference less the half level of rounding, and ``mean_levels``, the mean gap
to the rounded reference. Both scale with how much a seed's weights and
images amplify rounding (``mean_levels`` of sound runs spreads fivefold over
seeds), which hides a fault a few times the rounding. ``f64_gap_ratio``
takes that scale out: the summed gap of the program's levels to the rounded
f64 reference over the f32 reference's own, each plus one, on the first
``F64_PAIRS`` pairs of each sampled call; f32 rounding reads about 1, less
precise arithmetic more. The share of the reference's levels that clamp at 0
or 255 goes to standard error.
"""

from __future__ import annotations

import json
import random
import sys

from h100bench import counts_sanet, harness, inputs, inputs_sanet, spans
from h100bench import trace as trace_lib
from h100bench.reference import sanet as ref
from h100bench.traffic.offline_pairs import UNTRACED_SHARE, _loop, pairing
# The program's SANet: a checkout without it fails here, before any set-up.
from styletransfer_tpu_torch.engines import sanet as engine
from styletransfer_tpu_torch.models import sanet as model

UNITS = {"stylize_img_per_s": "img/s"}
# Pairs of each sampled call that the reference also computes in f64.
F64_PAIRS = 1


def run(run: harness.Run) -> harness.Outcome:
    import torch
    from styletransfer_tpu_torch.ops.cuda import attention, conv3x3, upconv_phase

    t, cfg, dev = run.traffic, run.config, run.device
    side, style_side = cfg["image_side"], cfg["style_side"]
    vgg, dec, tr = inputs_sanet.weights(run.seed, dev, cfg)
    params = model.import_torch_state_dict(vgg, dec, tr, device=dev)
    g_content = inputs.generator(dev, run.seed, inputs.IMAGES)
    g_style = inputs.generator(dev, run.seed, inputs.STYLE)
    contents = [inputs.images(t["batch"], side, g_content, dev) for _ in range(t["pool"])]
    styles = [inputs.images(t["batch"], style_side, g_style, dev) for _ in range(t["pool"])]
    style_of = pairing(run.seed, t["pool"])
    serve = engine.make_serve_fn(precision=cfg["precision"])

    for i in range(2):
        serve(params, contents[i % t["pool"]], styles[style_of(i)])
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
        calls, secs = _loop(serve, params, contents, styles, style_of, 0, run.seconds,
                            t["inflight"], keep, torch)
        e2e = {"stylize_img_per_s": calls * t["batch"] / secs}
    else:
        calls, secs = _loop(serve, params, contents, styles, style_of, 0,
                            run.seconds * UNTRACED_SHARE, t["inflight"], keep, torch)
        layer["model_flops_per_s"] = (calls * t["batch"]
                                      * counts_sanet.pair_flops(side, style_side) / secs)
        tr_ = trace_lib.Trace()
        a0, c0, u0 = attention.launches, conv3x3.launches, upconv_phase.launches
        with spans.recording() as rec:
            with trace_lib.traced(dev, tr_, defer=True):
                for i in range(calls, calls + t["traced_calls"]):
                    keep(i, serve(params, contents[i % t["pool"]], styles[style_of(i)]))
                if dev.type == "cuda":
                    torch.cuda.synchronize()
        if rec is not None and tr_.prof is not None:
            ops, launches = spans.events(tr_.prof)
            by = spans.by_span(ops, launches, spans.Spans.of(rec))
            layer["span_s"] = {k: v for k, v in by.items() if k is not None}
            print("offline_pairs_sanet: device ms a call by span " + json.dumps(
                {str(k): round(1e3 * v / t["traced_calls"], 4)
                 for k, v in sorted(by.items(), key=lambda kv: -kv[1])}),
                file=sys.stderr, flush=True)
        tr_.read()
        calls += t["traced_calls"]
        layer.update(trace=tr_, forwards=t["traced_calls"],
                     attention_calls=attention.launches - a0,
                     conv3x3_valid_calls=conv3x3.launches - c0,
                     upconv_phase_calls=upconv_phase.launches - u0,
                     batch=t["batch"], side=side, style_side=style_side)
        e2e = {}
    samples = list(kept)
    del params, serve, kept

    def verify():
        b = t["block"]
        worst, gaps, clamped, levels = 0.0, [], 0, 0
        program_gap, reference_gap = 0, 0
        weights64 = [{k: v.double() for k, v in sd.items()} for sd in (vgg, dec, tr)]
        with ref.precision(tf32=False):
            for ci, si, out in samples:
                for i in range(0, t["batch"], b):
                    c = contents[ci][i:i + b].permute(0, 3, 1, 2).float() / 255.0
                    s = styles[si][i:i + b].permute(0, 3, 1, 2).float() / 255.0
                    r = ref.stylize(vgg, dec, tr, c, s)
                    lv = (torch.clamp(r, 0.0, 1.0) * 255.0).permute(0, 2, 3, 1)
                    o = out[i:i + b].float()
                    worst = max(worst, float((o - lv).abs().max()))
                    gaps.append((o - torch.round(lv)).abs().mean())
                    clamped += int(((r <= 0.0) | (r >= 1.0)).sum())
                    levels += r.numel()
                    if i < F64_PAIRS:
                        r64 = ref.stylize(*weights64, c.double(), s.double())
                        lv64 = torch.round(torch.clamp(r64, 0.0, 1.0) * 255.0).permute(0, 2, 3, 1)
                        program_gap += int((o.double() - lv64).abs().sum())
                        reference_gap += int((torch.round(lv).double() - lv64).abs().sum())
                        del r64, lv64
                    del r, lv, o
        print(f"offline_pairs_sanet: {clamped / levels:.6f} of the reference's levels clamp; "
              f"level gaps to the f64 reference: the program's {program_gap}, the f32 "
              f"reference's {reference_gap}", file=sys.stderr, flush=True)
        return {"excess_levels": worst - 0.5, "mean_levels": float(torch.stack(gaps).mean()),
                "f64_gap_ratio": (program_gap + 1) / (reference_gap + 1)}

    return harness.Outcome(attempted=calls * t["batch"], failed=0, end_to_end=e2e,
                           verify=verify, layer=layer)
