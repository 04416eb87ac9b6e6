"""Offline batches: a closed loop of the serving forward
(``engines/fast.py::make_serve_fn``, uint8 in and out) over a pool of
seeded batches already on the device, cycled.

Mix parameters: ``batch``, ``pool`` (batches made at set-up), ``inflight``
(calls queued ahead of the one the host waits for), ``sample`` (batches
whose outputs a seeded reservoir keeps for the check), ``traced_calls``.

The window ends at a synchronize; ``stylize_img_per_s`` is every image of
every call over the whole window. In a traced run the first
``untraced_share`` of the window is timed without the profiler (for
``mfu.serve``), then ``traced_calls`` calls run under it.
"""

from __future__ import annotations

import random
import time
from collections import deque

from h100bench import counts, harness, inputs, program
from h100bench import trace as trace_lib
from h100bench.reference import nets

UNITS = {"stylize_img_per_s": "img/s"}
UNTRACED_SHARE = 0.6


def _loop(serve, params, pool, seconds, inflight, keep, torch):
    """Calls until ``seconds`` have passed, at most ``inflight`` queued
    ahead; returns (calls, seconds to the final synchronize)."""
    done = deque()
    n = 0
    t0 = time.monotonic()
    while time.monotonic() - t0 < seconds:
        if len(done) > inflight:
            done.popleft().synchronize()
        out = serve(params, pool[n % len(pool)])
        keep(n, out)
        ev = torch.cuda.Event() if out.is_cuda else None
        if ev is not None:
            ev.record()
            done.append(ev)
        n += 1
    if pool[0].is_cuda:
        torch.cuda.synchronize()
    return n, time.monotonic() - t0


def run(run: harness.Run) -> harness.Outcome:
    import torch
    from styletransfer_tpu_torch.engines import fast
    from styletransfer_tpu_torch.ops.cuda import conv3x3, instance_norm

    t, dev, side = run.traffic, run.device, run.config["image_side"]
    w = inputs.transformnet_weights(run.seed, dev)
    params = program.transformnet(w)
    g = inputs.generator(dev, run.seed, inputs.IMAGES)
    pool = [inputs.images(t["batch"], side, g, dev) for _ in range(t["pool"])]
    serve = fast.make_serve_fn(precision=run.config["precision"], pad_mode="reflect")
    for batch in pool[:2]:
        serve(params, batch)
    if dev.type == "cuda":
        torch.cuda.synchronize()

    rng = random.Random(run.seed)
    kept = []
    seen = [0]

    def keep(n, out):
        """A seeded reservoir of (pool index, output) over the window's calls."""
        seen[0] += 1
        if len(kept) < t["sample"]:
            kept.append((n % len(pool), out))
        else:
            j = rng.randrange(seen[0])
            if j < t["sample"]:
                kept[j] = (n % len(pool), out)

    layer = {}
    run.window_starts()
    if not run.trace:
        calls, secs = _loop(serve, params, pool, run.seconds, t["inflight"], keep, torch)
        e2e = {"stylize_img_per_s": calls * t["batch"] / secs}
    else:
        calls, secs = _loop(serve, params, pool, run.seconds * UNTRACED_SHARE,
                            t["inflight"], keep, torch)
        layer["model_flops_per_s"] = (calls * t["batch"]
                                      * counts.transformnet_forward_flops(side) / secs)
        tr = trace_lib.Trace()
        c0, i0 = conv3x3.launches, instance_norm.launches
        with trace_lib.traced(dev, tr):
            n_traced = 0
            for _ in range(t["traced_calls"]):
                keep(calls + n_traced, serve(params, pool[(calls + n_traced) % len(pool)]))
                n_traced += 1
            if dev.type == "cuda":
                torch.cuda.synchronize()
        calls += n_traced
        layer.update(trace=tr, conv3x3_valid_calls=conv3x3.launches - c0,
                     in_pad_forwards=(instance_norm.launches - i0) / 15,
                     batch=t["batch"], side=side)
        e2e = {}
    samples = [(pool[i], out) for i, out in kept]
    del params, serve, pool, kept

    def verify():
        with nets.precision(tf32=False):
            # A sound forward's output lies within half a level of the
            # unrounded reference, up to the f32 rounding of both: the excess
            # over that half level is the forward's error.
            gaps, worst = [], 0.0
            for batch_u8, out in samples:
                ref = nets.transformnet_levels(w, batch_u8)
                worst = max(worst, float((out.float() - ref).abs().max()))
                gaps.append((out.float() - torch.round(ref)).abs().mean())
            return {"excess_levels": worst - 0.5, "mean_levels": float(torch.stack(gaps).mean())}

    return harness.Outcome(attempted=calls * t["batch"], failed=0, end_to_end=e2e, verify=verify, layer=layer)
