#!/usr/bin/env python3
"""What fixing the conv plans' tiles without the batch costs, on one CUDA GPU.

    python3 scripts/torch_plan_costs.py

``valid_plan`` (conv3x3_valid) scores its bf16 tile at a batch of
``conv3x3.PLAN_BATCH`` and ``flat_plan`` (conv3x3_flat) sizes its tile and
split for a batch of ``conv3x3_flat.PLAN_BATCH``, whatever the batch, so
that an image's sums never depend on the batch it rides in. Before, both
planned for the call's own batch. The old plan of a call at batch B is the
same function with its PLAN_BATCH set to B, so both run here, from this
tree, in turns (old, new, new, old; ms: device times of calls queued behind
a spin kernel for a conv, events around calls as the host issues them for a
forward or a closure), at the shapes ``chip_smoke.py`` times; conv3x3_flat
also with its tile and split chosen for one image (the alternative that
was measured and not kept), between the turns:

- conv3x3_valid bf16 at the 256 px residual shape, batch 1, 4 and 64, and
  at 300 px, batch 1 and 64;
- conv3x3_flat at the zero-padded forward's residual shape, batch 1, 4 and
  64, f32 and bf16;
- the serving forward at batch 64 (reflect, f32 and bf16; and zeros);
- a Gatys closure (loss and pixel gradient) at 256 px on 1 and 4 lanes,
  f32 and bf16: the ten VGG convs on conv3x3_flat and conv3x3_im2col;
- a training step's VGG convs: conv3_1 and its input gradient at batch 4.

Seeded inputs and parameters; nothing is read from disk.
"""

from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_plan_costs: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from styletransfer_tpu_torch.data import coco
    from styletransfer_tpu_torch.engines import gatys
    from styletransfer_tpu_torch.models import transformer, vgg
    from styletransfer_tpu_torch.ops import layers
    from styletransfer_tpu_torch.ops.cuda import conv3x3, conv3x3_flat
    from styletransfer_tpu_torch.utils import images

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    layers.disable_tf32()
    new_batch = {conv3x3: conv3x3.PLAN_BATCH, conv3x3_flat: conv3x3_flat.PLAN_BATCH}

    def plan_at(batch):
        """Both plans as they were for a call at ``batch`` (None: as now)."""
        for module, fn in ((conv3x3, conv3x3.valid_plan), (conv3x3_flat, conv3x3_flat.flat_plan)):
            module.PLAN_BATCH = new_batch[module] if batch is None else batch
            fn.cache_clear()

    def device_ms(fn, iters=10):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        cycles = 20_000_000
        for _ in range(6):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(cycles)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            queued = not start.query()
            torch.cuda.synchronize()
            if queued:
                return start.elapsed_time(end) / iters
            cycles *= 2
        raise RuntimeError("the host could not queue the timed calls ahead of the card")

    def issued_ms(fn, iters=10):
        """Events around calls as the host issues them: a forward or a
        closure copies small tensors from the host, which waits for the
        card, so it cannot be queued behind a spin kernel."""
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def turns(label, batch, fn, describe, timer=device_ms, also=None):
        """old, new, new, old (and ``also``, a PLAN_BATCH of conv3x3_flat to
        try beside them, between); prints each plan and the means."""
        times, plans = {}, {}
        order = ["old", "new"] + (["also"] if also else []) + ["new", "old"]
        for which in order:
            plan_at(batch if which == "old" else None)
            if which == "also":
                conv3x3_flat.PLAN_BATCH = also
                conv3x3_flat.flat_plan.cache_clear()
            plans[which] = describe()
            times.setdefault(which, []).append(timer(fn))
        plan_at(None)
        mean = {k: sum(v) / len(v) for k, v in times.items()}
        same = " (the same plan)" if plans["old"] == plans["new"] else ""
        extra = (f", flat planned for batch {also}: {mean['also']:.4f} ms [{plans['also']}] "
                 f"({mean['also'] / mean['old']:.3f} of old)" if also else "")
        print(f"{label}: old {mean['old']:.4f} ms [{plans['old']}], new {mean['new']:.4f} ms "
              f"[{plans['new']}]{same}; new/old {mean['new'] / mean['old']:.3f}{extra}; "
              f"runs {times}", flush=True)

    g = torch.Generator(device="cuda").manual_seed(0)
    for W, batches in ((64, (1, 4, 64)), (75, (1, 64))):
        for B in batches:
            x = torch.randn(B, W + 2, W + 2, 128, device="cuda", generator=g).bfloat16()
            w = (torch.randn(3, 3, 128, 128, device="cuda", generator=g) / 34).bfloat16()
            b = torch.randn(128, device="cuda", generator=g)
            turns(f"conv3x3_valid bf16 x[{B},{W + 2},{W + 2},128]", B,
                  lambda: conv3x3.conv3x3_valid(x, w, b),
                  lambda: str(conv3x3.valid_plan(B, W, W, 128, 128, torch.bfloat16)))
    for dtype in (torch.float32, torch.bfloat16):
        for B in (1, 4, 64):
            x = torch.randn(B, 66, 66, 128, device="cuda", generator=g).to(dtype)
            w = (torch.randn(3, 3, 128, 128, device="cuda", generator=g) / 34).to(dtype)
            b = torch.randn(128, device="cuda", generator=g)
            turns(f"conv3x3_flat {str(dtype)[6:]} x[{B},66,66,128]", B,
                  lambda: conv3x3_flat.conv3x3_flat(x, w, b),
                  lambda: str(conv3x3_flat.flat_plan(B, 64, 64, 128, 128, dtype)), also=1)

    for dtype in (torch.float32, torch.bfloat16):
        for C, O in ((128, 256), (256, 128)):  # conv3_1 and conv3_1.dx at 256 px
            x = torch.randn(4, 66, 66, C, device="cuda", generator=g).to(dtype)
            w = (torch.randn(3, 3, C, O, device="cuda", generator=g) / 34).to(dtype)
            b = torch.randn(O, device="cuda", generator=g)
            turns(f"conv3x3_flat {str(dtype)[6:]} x[4,66,66,{C}] -> {O}", 4,
                  lambda: conv3x3_flat.conv3x3_flat(x, w, b),
                  lambda: str(conv3x3_flat.flat_plan(4, 64, 64, C, O, dtype)), also=1)

    params = transformer.init_params(seed=0, device="cuda")
    u8 = torch.from_numpy((coco.synthetic_image(1, 256) * 255).round().astype("uint8"))
    batch = images.maybe_normalize_on_device(
        u8[None].expand(64, -1, -1, -1).contiguous().cuda())
    for pad_mode in ("reflect", "zeros"):
        for cd, dn in ((None, "f32"), (torch.bfloat16, "bf16")):
            turns(f"serving forward {pad_mode} {dn} batch 64, 256 px", 64,
                  lambda: transformer.apply(params, batch, cd, pad_mode=pad_mode),
                  lambda: (str(conv3x3.valid_plan(64, 64, 64, 128, 128, cd or torch.float32))
                           if pad_mode == "reflect" else
                           str(conv3x3_flat.flat_plan(64, 64, 64, 128, 128,
                                                      cd or torch.float32))),
                  timer=issued_ms, also=1 if pad_mode == "zeros" else None)

    vgg_params = vgg.init_params(seed=0, device="cuda")
    style = images.maybe_normalize_on_device(torch.from_numpy(
        (coco.synthetic_image(2, 256) * 255).round().astype("uint8"))[None].cuda())
    for lanes in (1, 4):
        content = images.maybe_normalize_on_device(torch.from_numpy(
            (coco.synthetic_image(3, 256) * 255).round().astype("uint8"))[None].expand(
                lanes, -1, -1, -1).contiguous().cuda())
        for cd, dn in ((None, "f32"), (torch.bfloat16, "bf16")):
            grams = vgg.style_gram_targets(vgg_params, style, compute_dtype=cd)
            loss_fn = gatys.make_loss_fn(vgg_params, content, grams, compute_dtype=cd)
            pixels = content.clone().requires_grad_()

            def closure():
                loss = loss_fn(pixels).sum()
                return torch.autograd.grad(loss, pixels)[0]

            turns(f"Gatys closure {dn}, {lanes} lane(s), 256 px", lanes, closure,
                  lambda: str(conv3x3_flat.flat_plan(lanes, 64, 64, 128, 256,
                                                     cd or torch.float32)),
                  timer=issued_ms, also=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
