"""Gatys: a closed loop of whole images through
``engines/gatys.py::train_gatys`` (``optimizer="lbfgs"``: torch's L-BFGS
contract, a history of ``history_size`` pairs in the ``compact`` form),
each image a new seeded content image with a seeded style image of its own,
whose Gram targets it pays for.

Mix parameters: ``history_size``, ``sample`` (images a seeded reservoir
keeps for the check), ``warm_steps`` (the steps of the set-up image).
``steps`` (per image) and the side come from the configuration.

The window runs whole images until ``--seconds`` have passed.
``gatys_evals_per_s`` is the closure evaluations of those images (the
program's ``engines.gatys.closure_evals`` counter) over their time. A traced
run times its images without the profiler for ``mfu.gatys`` for the first
``untraced_share`` of the window, then profiles one more whole image.
"""

from __future__ import annotations

import random
import sys
import time

import torch

from h100bench import counts, harness, inputs, program
from h100bench import trace as trace_lib
from h100bench.reference import nets

UNITS = {"gatys_evals_per_s": "evals/s"}
UNTRACED_SHARE = 0.6


def run(run: harness.Run) -> harness.Outcome:
    from styletransfer_tpu_torch.engines import gatys
    from styletransfer_tpu_torch.ops.cuda import conv3x3_flat

    t, cfg, dev = run.traffic, run.config, run.device
    cuda = dev.type == "cuda"
    side, steps = cfg["image_side"], cfg["steps"]
    v = inputs.vgg_weights(run.seed, dev)
    vgg_params = program.vgg(v)

    def pair(i):
        """Image i's content and style (uint8)."""
        c = inputs.images(1, side, inputs.generator(dev, run.seed, inputs.IMAGES, i), dev)
        s = inputs.images(1, side, inputs.generator(dev, run.seed, inputs.STYLE, i), dev)
        return c, s

    def image(i, n_steps=steps):
        c_u8, s_u8 = pair(i)
        pixels, history = gatys.train_gatys(
            vgg_params, nets.normalize_u8(s_u8), nets.normalize_u8(c_u8), steps=n_steps,
            style_weight=cfg["style_weight"], content_weight=cfg["content_weight"],
            optimizer="lbfgs", log_every=None, precision=cfg["precision"],
            history_size=t["history_size"], history_math="compact")
        return pixels, history

    image(0, t["warm_steps"])
    rng = random.Random(run.seed)
    kept, per_image = [], []

    def loop(first, seconds, least=1):
        """Whole images from index ``first``, at least ``least``, until
        ``seconds`` have passed; a seeded reservoir keeps ``sample`` of
        them. Returns (images, evaluations, seconds)."""
        n, evals, t0 = first, 0, time.monotonic()
        while n - first < least or time.monotonic() - t0 < seconds:
            e0, t1 = gatys.closure_evals, time.monotonic()
            pixels, history = image(n)
            evals += gatys.closure_evals - e0
            per_image.append((gatys.closure_evals - e0, time.monotonic() - t1))
            if len(kept) < t["sample"]:
                kept.append((n, pixels, history))
            else:
                j = rng.randrange(n)  # n images of the window so far, index 1 on
                if j < t["sample"]:
                    kept[j] = (n, pixels, history)
            n += 1
        return n - first, evals, time.monotonic() - t0

    layer = {"side": side}
    run.window_starts()
    if not run.trace:
        images, evals, secs = loop(1, run.seconds)
        e2e = {"gatys_evals_per_s": evals / secs}
    else:
        images, evals, secs = loop(1, run.seconds * UNTRACED_SHARE)
        layer["model_flops_per_s"] = evals * counts.gatys_eval_flops(side) / secs
        tr = trace_lib.Trace()
        f0, e0 = conv3x3_flat.flat_launches, gatys.closure_evals
        with trace_lib.traced(dev, tr):
            extra, _, _ = loop(1 + images, 0.0)
        layer.update(trace=tr, traced_evals=gatys.closure_evals - e0, traced_images=extra,
                     flat_calls=conv3x3_flat.flat_launches - f0)
        images += extra
        e2e = {}
    print("h100bench: evaluations and seconds of each image: "
          + " ".join(f"{e}/{sec:.3f}" for e, sec in per_image), file=sys.stderr, flush=True)
    samples = list(kept)
    del vgg_params, kept

    def verify():
        """The first loss (the forward and the targets at the content
        image), and the end: the reference objective at the program's
        pixels against the reference's own L-BFGS run. Past its first
        iterations the trajectory swings, with f32 as with less, so the
        losses between and the pixels are reported, not compared."""
        worst = {"loss0_gap": 0.0, "final_gap": 0.0}
        seen = {"loss_gap": 0.0, "pixel_gap": 0.0}
        with nets.precision(tf32=False):
            for i, pixels, history in samples:
                c_u8, s_u8 = pair(i)
                content = nets.normalize_u8(c_u8)
                objective = nets.gatys_objective(v, content, nets.normalize_u8(s_u8),
                                                 cfg["style_weight"], cfg["content_weight"])
                ref_losses, ref_pixels = nets.gatys_lbfgs(objective, content, steps,
                                                          t["history_size"])
                gaps = [abs(float(a) - b) / abs(b) for a, b in zip(history, ref_losses)]
                with torch.no_grad():
                    end, ref_end = float(objective(pixels)), float(objective(ref_pixels))
                worst["loss0_gap"] = max(worst["loss0_gap"], gaps[0])
                worst["final_gap"] = max(worst["final_gap"], abs(end - ref_end) / ref_end)
                seen["loss_gap"] = max(seen["loss_gap"], max(gaps))
                seen["pixel_gap"] = max(seen["pixel_gap"], float((pixels - ref_pixels).abs().max())
                                        / float((ref_pixels - content).abs().max()))
        print(f"h100bench: not compared: widest loss gap over the steps "
              f"{seen['loss_gap']!r}, widest pixel gap over the reference's movement "
              f"{seen['pixel_gap']!r}", file=sys.stderr, flush=True)
        return worst

    return harness.Outcome(attempted=images, failed=0, end_to_end=e2e,
                           verify=verify, layer=layer)
