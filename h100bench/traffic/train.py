"""Training: ``engines/fast.py::make_train_step`` (the transform net's
forward, the VGG19 perceptual loss, the backward and Adam) fed by
``data/packed.py::get_packed_loader`` through ``parallel/prefetch.py``, as
``fast_st train --packed`` feeds it.

Set-up writes a packed file of seeded crops under the run's scratch folder
(the program's file format: raw uint8 rows and a JSON header), builds one
training step with its model and Adam state, and drives it through its
first ``checked_steps`` steps by the window's own loop, call and feed; the
window then continues from that same state. Both the loop of set-up and
the window's keep a stretch of their steps on the device, with no host
read: set-up its first steps, the window ``stretch_steps`` steps from one
drawn from the seed in ``stretch_from`` (moved on to the next pass over the
file where it would span two). Once the window has closed the reference
follows set-up's steps from the seed's weights, and the window's stretch
from the program's state before it.

Mix parameters: ``batch``, ``crops``, ``checked_steps``, ``inflight`` (steps
queued ahead of the one the host waits for), ``stretch_from`` (the first
and one past the last window step a stretch may start at),
``stretch_steps``, ``traced_steps``.

``train_img_per_s`` is every image of every step of the window over the
window, which ends at a synchronize. A traced run times the first
``UNTRACED_SHARE`` of its window without the profiler, then profiles
``traced_steps`` steps, recording the card's activity alone.
"""

from __future__ import annotations

import json
import os
import random
import statistics
import sys
import time
from collections import deque

from h100bench import counts, harness, inputs, program
from h100bench import trace as trace_lib
from h100bench.reference import nets

UNITS = {"train_img_per_s": "img/s"}
UNTRACED_SHARE = 0.6
ADAM_BETA1 = 0.9
# A leaf whose reference gradient norm is under this share of the median
# leaf's moves under Adam by round-off alone (the conv biases before an
# instance norm): its change is not compared.
STILL_LEAF = 1e-3
# The window's step rate is printed for each of this many equal slices.
SLICES = 5


def _forever(loader):
    while True:
        yield from loader


def _write_packed(path: str, crops_u8) -> None:
    n, side = crops_u8.shape[0], crops_u8.shape[1]
    crops_u8.cpu().numpy().tofile(path)
    with open(path + ".json", "w") as f:
        json.dump({"num_images": n, "size": side, "channels": 3, "dtype": "uint8"}, f)


def _snapshot(params, opt):
    """The parameters, and Adam's moments and step count (zeros and None
    before its first step), cloned on the device."""
    import torch

    named = list(params.named_parameters())
    state = {name: opt.state.get(p, {}) for name, p in named}
    w = {name: p.detach().clone() for name, p in named}
    m = {name: state[name]["exp_avg"].clone() if state[name] else torch.zeros_like(p)
         for name, p in named}
    v = {name: state[name]["exp_avg_sq"].clone() if state[name] else torch.zeros_like(p)
         for name, p in named}
    t = {name: state[name]["step"].clone() if state[name] else None for name, _ in named}
    return w, m, v, t


class _Stretch:
    """What steps ``first`` .. ``first + count - 1`` of a loop fed and
    produced, kept on the device with no host read: the parameters and
    Adam's state before the first, each batch and loss, Adam's first moment
    after the first step, and the parameters after the last."""

    def __init__(self, first: int, count: int):
        self.first, self.count = first, count
        self.batches, self.losses = [], []
        self.before = self.first_moment = self.after = None

    @property
    def done(self) -> bool:
        return self.after is not None

    def step(self, n, step, params, opt, batch) -> None:
        """Step ``n`` of the loop, keeping what falls inside the stretch."""
        k = n - self.first
        if not 0 <= k < self.count:
            step(params, opt, batch)
            return
        if k == 0:
            self.before = _snapshot(params, opt)
        metrics = step(params, opt, batch)
        self.batches.append(batch.clone())
        self.losses.append(metrics["total"].clone())
        if k == 0:
            self.first_moment = {name: opt.state[p]["exp_avg"].clone()
                                 for name, p in params.named_parameters()}
        if k == self.count - 1:
            self.after = {name: p.detach().clone() for name, p in params.named_parameters()}


def _loop(step, params, opt, feed, seconds, inflight, stretch, torch, cuda):
    """Steps until ``seconds`` have passed and ``stretch`` holds all it
    keeps; returns (steps, seconds to the final synchronize, seconds waited
    in ``next(feed)``, the host's clock at the start of each step)."""
    done = deque()
    n, wait, starts = 0, 0.0, []
    t0 = time.monotonic()
    while time.monotonic() - t0 < seconds or not stretch.done:
        starts.append(time.monotonic())
        if len(done) > inflight:
            done.popleft().synchronize()
        tw = time.perf_counter()
        batch = next(feed)
        wait += time.perf_counter() - tw
        stretch.step(n, step, params, opt, batch)
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            done.append(ev)
        n += 1
    if cuda:
        torch.cuda.synchronize()
    return n, time.monotonic() - t0, wait, starts


def _slice_rates(starts, secs, batch):
    """Images per second in each of ``SLICES`` equal slices of the window,
    by the steps that started in it."""
    started = [0] * SLICES
    for t in starts:
        started[min(SLICES - 1, int((t - starts[0]) / secs * SLICES))] += 1
    return [round(n * batch * SLICES / secs, 2) for n in started]


def _stretch_start(seed, t, epoch_steps):
    """The window step at which its stretch starts, drawn from the seed,
    moved on so that its batches lie in one pass over the file."""
    first = random.Random(seed).randrange(*t["stretch_from"])
    into = (t["checked_steps"] + first) % epoch_steps
    if into + t["stretch_steps"] > epoch_steps:
        first += epoch_steps - into
    return first


def _gaps(program_after, ref_after, start, ref_grad):
    """Each moving leaf's gap of the norms of its change from ``start``, over
    the reference's norm of it or the median leaf's, whichever is larger."""
    gr = {k: float(g.norm()) for k, g in ref_grad.items()}
    g_med = statistics.median(gr.values())
    moving = [k for k in gr if gr[k] >= STILL_LEAF * g_med]
    dr = {k: float((ref_after[k] - start[k]).norm()) for k in moving}
    dp = {k: float((program_after[k] - start[k]).norm()) for k in moving}
    d_med = statistics.median(dr.values())
    return {k: abs(dp[k] - dr[k]) / max(dr[k], d_med) for k in moving}, len(gr) - len(moving)


def run(run: harness.Run) -> harness.Outcome:
    import torch
    from styletransfer_tpu_torch.data import packed
    from styletransfer_tpu_torch.engines import fast
    from styletransfer_tpu_torch.models import vgg as port_vgg
    from styletransfer_tpu_torch.parallel import prefetch

    t, cfg, dev = run.traffic, run.config, run.device
    cuda = dev.type == "cuda"
    side = cfg["image_side"]
    w0 = inputs.transformnet_weights(run.seed, dev)
    v = inputs.vgg_weights(run.seed, dev)
    style = nets.normalize_u8(inputs.images(1, side, inputs.generator(dev, run.seed,
                                                                      inputs.STYLE), dev))
    crops = inputs.images(t["crops"], side, inputs.generator(dev, run.seed, inputs.IMAGES), dev)
    path = os.path.join(run.workdir, "crops.u8")
    _write_packed(path, crops)

    params = program.transformnet(w0)
    vgg_params = program.vgg(v)
    grams = port_vgg.style_gram_targets(vgg_params, style)
    step = fast.make_train_step(vgg_params, grams, cfg["style_weight"], cfg["content_weight"])
    opt = fast.make_optimizer(params)
    _, loader = packed.get_packed_loader(path, batch_size=t["batch"], seed=run.seed)
    feed = prefetch.prefetch_to_device(_forever(loader), dev)

    setup = _Stretch(0, t["checked_steps"])
    _loop(step, params, opt, feed, 0.0, t["inflight"], setup, torch, cuda)
    stretch = _Stretch(_stretch_start(run.seed, t, len(loader)), t["stretch_steps"])

    layer = {}
    run.window_starts()
    try:
        if not run.trace:
            steps, secs, _, starts = _loop(step, params, opt, feed, run.seconds, t["inflight"],
                                           stretch, torch, cuda)
            e2e = {"train_img_per_s": steps * t["batch"] / secs}
        else:
            steps, secs, wait, starts = _loop(step, params, opt, feed,
                                              run.seconds * UNTRACED_SHARE, t["inflight"],
                                              stretch, torch, cuda)
            layer.update(model_flops_per_s=steps * t["batch"] * counts.train_image_flops(side)
                         / secs, untraced_steps=steps, data_wait_s=wait)
            tr = trace_lib.Trace()
            with trace_lib.traced(dev, tr, host=False):
                for _ in range(t["traced_steps"]):
                    step(params, opt, next(feed))
                if cuda:
                    torch.cuda.synchronize()
            steps += t["traced_steps"]
            layer["trace"] = tr
            e2e = {}
    finally:
        feed.close()
    print(f"h100bench: images/s in each fifth of the window's untraced loop "
          f"{_slice_rates(starts, secs, t['batch'])}", file=sys.stderr, flush=True)
    del params, vgg_params, opt, step, feed, loader, grams

    def verify():
        # Each fed row must be a row of the packed file, and no row may come
        # twice in one stretch; the reference takes the file's rows.
        index = {row.tobytes(): i for i, row in enumerate(crops.cpu().numpy())}

        def rows(batches):
            keys = [[row.tobytes() for row in b.cpu().numpy()] for b in batches]
            flat = [k for b in keys for k in b]
            bad = sum(k not in index for k in flat) + len(flat) - len(set(flat))
            return bad, [crops[[index.get(k, 0) for k in b]] for b in keys]

        bad0, rows0 = rows(setup.batches)
        bad1, rows1 = rows(stretch.batches)
        start_w, start_m, start_v, start_t = stretch.before
        steps_before = {int(x) for x in start_t.values()}
        if len(steps_before) != 1:
            raise RuntimeError(f"Adam's leaves stand at different steps: {steps_before}")
        sw, cw = cfg["style_weight"], cfg["content_weight"]
        with nets.precision(tf32=False):
            ref_losses, ref_grad, ref_after = nets.train_steps(w0, v, style, rows0, sw, cw)
            ref_s_losses, ref_s_grad, ref_s_after = nets.train_steps(
                start_w, v, style, rows1, sw, cw,
                state=(start_m, start_v, steps_before.pop()))
        losses = [float(x) for x in setup.losses]
        loss_gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
        s_losses = [float(x) for x in stretch.losses]
        s_loss_gaps = [abs(a - b) / abs(b) for a, b in zip(s_losses, ref_s_losses)]
        gr = {k: float(g.norm()) for k, g in ref_grad.items()}
        gp = {k: float((setup.first_moment[k] / (1 - ADAM_BETA1)).norm()) for k in gr}
        g_med = statistics.median(gr.values())
        grad_gaps = {k: abs(gp[k] - gr[k]) / max(gr[k], g_med) for k in gr}
        change_gaps, still = _gaps(setup.after, ref_after, w0, ref_grad)
        s_change_gaps, s_still = _gaps(stretch.after, ref_s_after, start_w, ref_s_grad)
        # Past the first step from the seed the losses, and the worst leaf's
        # change, swing with the sign that Adam's first update (lr times the
        # sign of each gradient element) gives the few elements whose
        # gradient is within rounding of zero: one element of a 32-wide IN
        # bias moves its leaf's norm by a per cent. So set-up's first loss
        # and median leaf's change are compared; the others are reported.
        worst_g = max(grad_gaps, key=grad_gaps.get)
        worst_c = max(change_gaps, key=change_gaps.get)
        worst_s = max(s_change_gaps, key=s_change_gaps.get)
        print(f"h100bench: set-up loss gaps by step {loss_gaps}; worst gradient leaf {worst_g} "
              f"{grad_gaps[worst_g]:.3g}, median {statistics.median(grad_gaps.values()):.3g}; "
              f"worst change leaf {worst_c} {change_gaps[worst_c]:.3g}; {still} still leaves",
              file=sys.stderr, flush=True)
        print(f"h100bench: window stretch from step {stretch.first}: loss gaps by step "
              f"{s_loss_gaps}; worst change leaf {worst_s} {s_change_gaps[worst_s]:.3g}; "
              f"{s_still} still leaves", file=sys.stderr, flush=True)
        return {"unmatched_rows": bad0 + bad1, "first_loss_gap": loss_gaps[0],
                "grad_gap": grad_gaps[worst_g],
                "change_gap": statistics.median(change_gaps.values()),
                "stretch_loss_gap": max(s_loss_gaps),
                "stretch_change_gap": statistics.median(s_change_gaps.values())}

    return harness.Outcome(attempted=steps, failed=0, end_to_end=e2e,
                           verify=verify, layer=layer)
