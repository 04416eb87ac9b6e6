#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --convs       # phases 1-2 and conv3x3_valid only
    python3 chip_smoke.py --stat-free   # phases 1-2 and the stat-free convs only
    python3 chip_smoke.py --norms       # phases 1-2 and the instance norms only

Run from the root of a checkout on a machine with a CUDA GPU and ``nvcc``.
It imports nothing of JAX. Phases:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``styletransfer_tpu_torch/csrc`` (``sm_90a``,
   one ``nvcc`` per source, in parallel);
3. hold each kernel against its plain PyTorch version on the card and time
   the kernel, the plain version and, where one exists, the one PyTorch call
   that computes the same function: the serving kernels at the serving
   path's shapes (batch 64): conv3x3_valid through its wrapper at the
   residual shape of each serving run, with its plan, rate and a
   bit-identical repeat (256 px: f32 FMA and bf16 wgmma routes; 300 px:
   bf16 wgmma with partial tiles; 1040 px at batch 4 and a 4032 x 3024
   photo at batch 1: bf16 wgmma on rows cut into segments; the mma.sync
   route forced at 1040 px), the bf16 routes side by side at 256 px, batch
   1, 4 and 64, at 300 px (the mma.sync route forced there, also held
   against the plain version), and at the 1040 px and photo shapes (each of
   SEGMENT_CANDIDATES, held against the plain version), and IN-pad at each
   of the fifteen call shapes of each
   serving run's forward (256 px; in bf16 also 300 px and 1040 px at batch
   4), with its plan, occupancy, share of the bound and a bit-identical
   repeat; the training kernels (the
   fused instance norm's forward and backward) at each call shape of the
   training forward (batch 4, 256 px), the backward with its plan, one
   launch per call, a bit-identical repeat and ``need_dx=False``, beside
   autograd of ``F.instance_norm``, and the stat-free conv kernels
   (conv3x3_flat, conv3x3_im2col) at each of the ten conv shapes of a 256 px
   Gatys closure (the tower's five forward convs and their five input
   gradients), in f32 and bf16, with conv3x3_flat's plan (route, tile and
   split) and conv3x3_im2col's plan (route and grid) for each shape and a
   bit-identical repeat of each call, and conv3x3_im2col at conv1_1 of 4
   images (a train step's and a Gatys directory's call);
4. drive the serving path, fast_st inference: a seeded checkpoint written
   with ``ckpt.save``, 64 seeded 256x256 PNGs, ``engines.fast.process_dir``
   from the checkpoint load to the saved PNGs, in f32 and bf16. The launch
   counters must show 10 conv3x3 and 15 IN-pad launches per forward, the
   conv3x3 ones all on the f32_fma or bf16_wgmma route, and the first two
   outputs must match the port's own CPU run; then the same images at 300 px
   in bf16, whose 75-wide residual convs take the bf16_wgmma route too, and
   four of them at 1040 px in bf16, whose 260-wide residual convs take the
   bf16_wgmma route on segments of rows (one image against the same forward
   on the convs' and instance norms' plain versions);
5. drive the training path, fast_st training: ``engines.fast.static_train``
   for a few steps at batch 4 on the synthetic corpus, seeded VGG and
   transform-net parameters, in f32 and bf16. The counters must show 15
   fused-IN forward and 15 backward launches per step (and 15 forward
   launches per eval or preview forward) and the VGG tower's conv kernels
   (per step 2 conv3x3_im2col and 12 conv3x3_flat: the output's forward and
   input gradient, the content target's forward), every logged loss must be
   finite, and the epoch checkpoint must load and serve through
   ``process_dir``;
6. one f32 training step on two images, card against the port's CPU run
   (loss components and every parameter's gradient);
7. time steady-state training steps at batch 4 and 16, f32 and bf16;
8. drive the Gatys path: the port's ``gatys_st`` command at 256 px (L-BFGS,
   H = 100, compact) for a few steps in f32 and bf16, then at its defaults
   (300 steps, f32), then on a directory of 4 images (4 lanes). Every
   closure evaluation must launch 1 conv3x3_im2col and 9 conv3x3_flat, the
   targets 1 + 4 (style) and 1 + 3 (content) per run, no cuDNN conv may run,
   the losses must be finite and fall and the PNGs must be written; then one
   f32 closure on a 64 px image, card against the port's CPU run;
9. print one JSON line with each kernel's error, launches and times, and as
   the last line ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero and prints no ``ok`` line; so does a machine
without a GPU, or a directory without the package. Scratch files go to
``build/smoke/`` in the checkout.
"""

from __future__ import annotations

import json
import logging
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "smoke")
BATCH = 64
SIZE = 256
# A serving size whose residual stage (75 wide) fills a wgmma tile only in
# part (3 rows, 225 of 256 positions).
WIDE_SIZE = 300
# A serving size whose residual rows (260 wide) are wider than a TMA box
# (256): the wgmma kernel cuts them into segments. Driven at batch 4.
WIDEST_SIZE = 1040
WIDEST_BATCH = 4
# (H, W) of a 12 MP phone photo served at its own size: residual rows 1,008
# wide. conv3x3_valid is checked and timed at its residual shape, batch 1.
PHOTO_SIZE = (3024, 4032)
# Segments per row timed side by side on the wgmma kernel (bm 256) at the
# residual widths over 256: 260 (1040 px) and 1,008 (the photo).
SEGMENT_CANDIDATES = {260: (2, 4, 5, 10, 12, 20, 52), 1008: (4, 8, 16, 36)}

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 without tensor
# cores (TF32 is off), and HBM3 bandwidth.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12

# (rtol, atol) of each kernel against its plain version on the card. f32:
# the same arithmetic summed in another order. bf16: both round the same f32
# value to bf16, so an order difference can flip the last of its 8 bits
# (2**-7 relative).
TOL = {
    ("conv3x3_valid", "float32"): (1e-4, 1e-4),
    ("conv3x3_valid", "bfloat16"): (2 ** -7, 1e-3),
    ("instance_norm_pad", "float32"): (1e-5, 1e-5),
    ("instance_norm_pad", "bfloat16"): (2 ** -7, 1e-3),
    ("fused_instance_norm_fwd", "float32"): (1e-5, 1e-5),
    ("fused_instance_norm_fwd", "bfloat16"): (2 ** -7, 1e-3),
    ("fused_instance_norm_bwd", "float32"): (1e-5, 1e-5),
    ("fused_instance_norm_bwd", "bfloat16"): (2 ** -7, 1e-3),
    ("conv3x3_flat", "float32"): (1e-4, 1e-4),
    ("conv3x3_flat", "bfloat16"): (2 ** -7, 1e-3),
    ("conv3x3_im2col", "float32"): (1e-4, 1e-4),
    ("conv3x3_im2col", "bfloat16"): (2 ** -7, 1e-3),
}
# The statistics (mean, inv) of the forward: f32 means and variances over up
# to 65,536 pixels, summed in another order.
STATS_TOL = (1e-5, 1e-6)
# The conv's f32 sums over 4096 pixels, and the backward's dscale / dbias
# (sums over up to 4 x 65,536 pixels): another summation order.
SUMS_TOL = (1e-4, 1e-2)
# The backward's dscale and dbias: the largest difference from the plain
# version, over the largest plain value (sums of up to 262,144 f32 terms in
# another order).
GRAD_SUMS_RTOL = 1e-5
# Main path against the port's CPU run, in 1/255 steps of the uint8 output.
# f32: one step (rounding of values that land near a half step). bf16 (card
# bf16 against CPU bf16): 8-bit mantissas rounded at other places through
# some twenty layers drift a few steps; the mean must stay under one.
MAIN_TOL = {"f32": (1, 0.05), "bf16": (16, 1.0)}  # (max steps, mean steps)

SOURCES = {
    "conv3x3_valid": ("styletransfer_tpu_torch/csrc/conv3x3.cu",
                      "styletransfer_tpu/ops/pallas/conv3x3.py:192"),
    # conv3x3_valid in bf16 at 300 px (75-wide rows, partial wgmma tiles),
    # 1040 px and the photo's size (rows cut into segments), and on its
    # mma.sync route, which only a caller that asks for it takes
    # (ops/cuda/conv3x3.py::valid_plan).
    "conv3x3_valid_wide": ("styletransfer_tpu_torch/csrc/conv3x3_wgmma.cu",
                           "styletransfer_tpu/ops/pallas/conv3x3.py:192"),
    "conv3x3_valid_widest": ("styletransfer_tpu_torch/csrc/conv3x3_wgmma.cu",
                             "styletransfer_tpu/ops/pallas/conv3x3.py:192"),
    "conv3x3_valid_mma": ("styletransfer_tpu_torch/csrc/conv3x3.cu",
                          "styletransfer_tpu/ops/pallas/conv3x3.py:192"),
    "instance_norm_pad": ("styletransfer_tpu_torch/csrc/instance_norm.cu",
                          "styletransfer_tpu/ops/pallas/instance_norm.py:229"),
    # The training forward runs the IN kernel at pad 0 with the residual
    # added in f32; the backward is its own kernel.
    "fused_instance_norm_fwd": ("styletransfer_tpu_torch/csrc/instance_norm.cu",
                                "styletransfer_tpu/ops/pallas/instance_norm.py:113"),
    "fused_instance_norm_bwd": ("styletransfer_tpu_torch/csrc/instance_norm_bwd.cu",
                                "styletransfer_tpu/ops/pallas/instance_norm.py:160"),
    "conv3x3_flat": ("styletransfer_tpu_torch/csrc/conv3x3_flat.cu",
                     "styletransfer_tpu/ops/pallas/conv3x3.py:133"),
    "conv3x3_im2col": ("styletransfer_tpu_torch/csrc/conv3x3_im2col.cu",
                       "styletransfer_tpu/ops/pallas/conv3x3.py:86"),
}
# conv3x3_valid's kernel on each route of valid_plan.
ROUTE_SOURCES = {"f32_fma": "styletransfer_tpu_torch/csrc/conv3x3.cu",
                 "bf16_mma": "styletransfer_tpu_torch/csrc/conv3x3.cu",
                 "bf16_wgmma": "styletransfer_tpu_torch/csrc/conv3x3_wgmma.cu"}
# Which path launches each kernel: its JSON launch count is that path's.
SERVING_KERNELS = ("conv3x3_valid", "instance_norm_pad")
TRAINING_KERNELS = ("fused_instance_norm_fwd", "fused_instance_norm_bwd")
GATYS_KERNELS = ("conv3x3_flat", "conv3x3_im2col")

# The training path: batch 4 (the reference's and the CLI's default), a few
# steps of one epoch on the synthetic corpus. Cadence (loss, preview, eval):
# the loss every step, a preview every third step, the eval at step 0.
TRAIN_BATCH = 4
TRAIN_STEPS = 6
TRAIN_CADENCE = (1, 3, 6)
NORMS_PER_FORWARD = 15
# Card against the port's CPU run, one f32 step on two images: the loss
# components (relative), and each parameter's gradient (relative L2). cuDNN
# and the CPU sum convolutions in other orders, and a ReLU whose input lies
# within that rounding of 0 can switch, which moves its channel's gradient.
PARITY_LOSS_RTOL = 1e-5
PARITY_GRAD_REL_L2 = 1e-3
# Steady-state training steps timed at these batch sizes.
STEP_BATCHES = (4, 16)
# The VGG tower's conv launches of the training path: per train step (the
# output's forward, up to conv3_1, and its input gradient; the content
# target's forward, up to conv2_2), per eval forward (the output up to
# conv3_1, then output and content up to conv2_2), and once per run for the
# style Grams (up to conv3_1).
VGG_PER_STEP = {"conv3x3_im2col": 2, "conv3x3_flat": 12}
VGG_PER_EVAL = {"conv3x3_im2col": 3, "conv3x3_flat": 10}
VGG_STYLE_TARGETS = {"conv3x3_im2col": 1, "conv3x3_flat": 4}

# The Gatys path: 256 px (the CLI's default size), L-BFGS with the CLI's
# H = 100 and compact history; a few outer steps in f32 and bf16, the CLI's
# default (300 steps, f32) once, and a directory of GATYS_LANES images.
GATYS_SIZE = 256
GATYS_STEPS = 3
GATYS_LANE_STEPS = 2
GATYS_LANES = 4
# Launches per closure evaluation (forward: conv1_1 on im2col, four convs on
# flat; input gradient: five on flat) and per run for the targets (the style
# Grams up to conv3_1 and the content target up to conv2_2, once each).
GATYS_PER_CLOSURE = {"conv3x3_im2col": 1, "conv3x3_flat": 9}
GATYS_TARGETS = {"conv3x3_im2col": 2, "conv3x3_flat": 7}
# Card against the port's CPU run: one f32 closure on one 64 px image. The
# loss (relative) and the pixel gradient (relative L2): the sums run in
# another order, and a ReLU whose input lies within rounding of 0 may switch.
GATYS_PARITY_SIZE = 64
# conv3x3_im2col is also checked and timed at conv1_1 of this many 256 px
# images: a train step's batch and a 4-image Gatys directory.
IM2COL_BATCH = 4
GATYS_PARITY_LOSS_RTOL = 1e-5
GATYS_PARITY_GRAD_REL_L2 = 1e-3


class CheckFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    print(("PASS " if cond else "FAIL ") + msg, flush=True)
    if not cond:
        raise CheckFailed(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call as the card runs the calls back to back:
    CUDA events around ``iters`` calls queued behind a spin kernel
    (``torch.cuda._sleep``). At the training path's small shapes the host
    takes longer to launch a call than the card to run it, so events around
    calls issued as the host goes (``time_ms``) time the host. The spin is
    lengthened until the host has queued every call before the card reaches
    the first."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 20_000_000  # about 10 ms at the H100's clock
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_ahead = not start.query()
        torch.cuda.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / iters
        cycles *= 2
    raise CheckFailed("the host could not queue the timed calls ahead of the card")


def bound(flops: float, nbytes: float, dtype: str):
    """Least time on the card in ms, and what bounds it."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def allclose(torch, a, b, rtol, atol) -> bool:
    return bool(torch.all((a.float() - b.float()).abs() <= atol + rtol * b.float().abs()))


def counters():
    """Each kernel's launch counter: (module, attribute)."""
    from styletransfer_tpu_torch.ops.cuda import (
        conv3x3, conv3x3_flat, fused_instance_norm, instance_norm)

    return {"conv3x3_valid": (conv3x3, "launches"),
            "conv3x3_valid.f32_fma": (conv3x3, "fma_launches"),
            "conv3x3_valid.bf16_mma": (conv3x3, "mma_launches"),
            "conv3x3_valid.bf16_wgmma": (conv3x3, "wgmma_launches"),
            "instance_norm_pad": (instance_norm, "launches"),
            "fused_instance_norm_fwd": (fused_instance_norm, "fwd_launches"),
            "fused_instance_norm_bwd": (fused_instance_norm, "bwd_launches"),
            "conv3x3_flat": (conv3x3_flat, "flat_launches"),
            "conv3x3_im2col": (conv3x3_flat, "im2col_launches")}


def reset_counts() -> None:
    for module, attr in counters().values():
        setattr(module, attr, 0)


def read_counts() -> dict:
    return {name: getattr(module, attr) for name, (module, attr) in counters().items()}


def conv_phase(torch, F, conv3x3, dtype):
    """conv3x3_valid through its wrapper against the plain version at the
    residual convs' shape of each serving run, with the plan, the route's
    launch count, the rate and a bit-identical repeat: 256 px (64 wide,
    batch 64) on the route its plan names (f32: FMA, bf16: wgmma) and, in
    bf16, on the wgmma route: 300 px (75 wide, batch 64: partial tiles of
    whole rows), 1040 px (260 wide, batch 4: segments of rows) and a 4032 x
    3024 photo (1,008 wide, batch 1); then the mma.sync route forced at 1040
    px. In bf16 the routes are also timed side by side, beside F.conv2d
    (device times, calls queued behind a spin kernel): wgmma and mma.sync at
    64 wide, batch 1, 4 and 64, and at 75 wide, batch 64, with the forced
    mma.sync route held against the plain version there too; at 260 and
    1,008 wide each of SEGMENT_CANDIDATES on wgmma, each held against the
    plain version, and mma.sync."""
    dn = str(dtype).split(".")[1]
    C = O = 128
    bnd = 1.0 / (9 * C) ** 0.5
    rtol, atol = TOL[("conv3x3_valid", dn)]
    route_counts = dict(f32_fma="fma_launches", bf16_mma="mma_launches",
                        bf16_wgmma="wgmma_launches")

    def inputs(batch, H, W):
        g = torch.Generator(device="cuda").manual_seed(1)
        x = torch.randn(batch, H + 2, W + 2, C, device="cuda", generator=g).to(dtype)
        w = ((torch.rand(3, 3, C, O, device="cuda", generator=g) * 2 - 1) * bnd).to(dtype)
        b = (torch.rand(O, device="cuda", generator=g) * 2 - 1) * bnd
        return x, w, b

    def library(x, w, b):
        # The one PyTorch call that computes the same function (without the
        # sums): cuDNN on the channels-last view, TF32 off.
        xc = x.permute(0, 3, 1, 2)
        wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        bc = b.to(dtype)
        return lambda: F.conv2d(xc, wc, bc)

    def held(tag, call, x, w, b, plain=None):
        """The call and its repeat against the plain version."""
        out, s, ss = call()
        again = call()
        torch.cuda.synchronize()
        pout, ps, pss = plain or conv3x3.conv3x3_valid_plain(x, w, b)
        err = max_err(out, pout)
        check(allclose(torch, out, pout, rtol, atol),
              f"{tag}: max_abs_err {err:.3g} (rtol {rtol:.3g}, atol {atol:.3g})")
        check(allclose(torch, s, ps, *SUMS_TOL) and allclose(torch, ss, pss, *SUMS_TOL),
              f"{tag} sums/sumsqs: max_abs_err {max_err(s, ps):.3g} / "
              f"{max_err(ss, pss):.3g} (rtol {SUMS_TOL[0]}, atol {SUMS_TOL[1]})")
        check(all(torch.equal(u, v) for u, v in zip((out, s, ss), again)),
              f"{tag}: the repeat is bit-identical (output and sums)")
        return err, (pout, ps, pss)

    # (JSON name, batch, H, W, serving size, route forced or None)
    runs = [("conv3x3_valid", BATCH, SIZE // 4, SIZE // 4, f"{SIZE} px", None)]
    if dtype == torch.bfloat16:
        H, W = PHOTO_SIZE[0] // 4, PHOTO_SIZE[1] // 4
        runs += [("conv3x3_valid_wide", BATCH, WIDE_SIZE // 4, WIDE_SIZE // 4,
                  f"{WIDE_SIZE} px", None),
                 ("conv3x3_valid_widest", WIDEST_BATCH, WIDEST_SIZE // 4, WIDEST_SIZE // 4,
                  f"{WIDEST_SIZE} px", None),
                 ("conv3x3_valid_photo", 1, H, W, f"{PHOTO_SIZE[1]} x {PHOTO_SIZE[0]} px", None),
                 ("conv3x3_valid_mma", WIDEST_BATCH, WIDEST_SIZE // 4, WIDEST_SIZE // 4,
                  f"{WIDEST_SIZE} px", "bf16_mma")]
    entries = []
    for name, batch, H, W, size, forced in runs:
        x, w, b = inputs(batch, H, W)
        plan = conv3x3.valid_plan(batch, H, W, C, O, dtype, route=forced)
        tag = (f"{name} {dn} {size} [{batch},{H + 2},{W + 2},{C}] ("
               f"{'forced ' if forced else ''}{plan})")
        counted = getattr(conv3x3, route_counts[plan.route])

        def call():
            return conv3x3.launch(x, w, b, False, plan) if forced else \
                conv3x3.conv3x3_valid(x, w, b)

        err, plain = held(tag, call, x, w, b)
        pout = plain[0]
        check(getattr(conv3x3, route_counts[plan.route]) == counted + 2,
              f"{tag}: both calls launched the {plan.route} kernel")
        ms = time_ms(torch, call)
        plain_ms = time_ms(torch, lambda: conv3x3.conv3x3_valid_plain(x, w, b))
        library_ms = time_ms(torch, library(x, w, b))
        flops = 2.0 * batch * H * W * 9 * C * O
        nbytes = (x.numel() + w.numel() + pout.numel()) * x.element_size() + (O + 2 * batch * O) * 4
        bound_ms, bound_by = bound(flops, nbytes, dn)
        print(f"{tag}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
              f"{library_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}; {flops / 1e9:.1f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB) achieved {flops / ms / 1e9:.1f} TFLOP/s, "
              f"{bound_ms / ms:.3f} of the bound", flush=True)
        if name not in SOURCES:  # checked and timed here; no serving run at that size
            continue
        entries.append({"name": f"{name}.{dn}", "route": "cuda", "plan": str(plan),
                        "source": ROUTE_SOURCES[plan.route], "replaces": SOURCES[name][1],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                        "shape": f"x[{batch},{H + 2},{W + 2},{C}] w[3,3,{C},{O}] ({size})"})
        if forced:
            entries[-1]["forced"] = f"route={forced!r}: no serving path takes it"
    if dtype == torch.bfloat16:
        sides = [(SIZE // 4, SIZE // 4, batch) for batch in (1, 4, BATCH)]
        sides += [(WIDE_SIZE // 4, WIDE_SIZE // 4, BATCH),
                  (WIDEST_SIZE // 4, WIDEST_SIZE // 4, WIDEST_BATCH),
                  (PHOTO_SIZE[0] // 4, PHOTO_SIZE[1] // 4, 1)]
        for H, W, batch in sides:
            x, w, b = inputs(batch, H, W)
            flops = 2.0 * batch * H * W * 9 * C * O
            plans = [conv3x3.valid_plan(batch, H, W, C, O, dtype)]
            plain = None
            if W in SEGMENT_CANDIDATES:
                plain = conv3x3.conv3x3_valid_plain(x, w, b)
                plans = [conv3x3.wgmma_plan(batch, H, W, O, 256, 3, -(-W // k))
                         for k in SEGMENT_CANDIDATES[W]]
            plans.append(conv3x3.valid_plan(batch, H, W, C, O, dtype, route="bf16_mma"))
            times = []
            for plan in plans:
                if plain is not None or (W == WIDE_SIZE // 4 and plan.route == "bf16_mma"):
                    held(f"conv3x3_valid {dn} [{batch},{H + 2},{W + 2},{C}] on {plan}",
                         lambda: conv3x3.launch(x, w, b, False, plan), x, w, b, plain)
                t = device_ms(torch, lambda: conv3x3.launch(x, w, b, False, plan))
                times.append(f"{plan}: {t:.4f} ms ({flops / t / 1e9:.1f} TFLOP/s)")
            lib = device_ms(torch, library(x, w, b))
            print(f"conv3x3_valid {dn} routes side by side, [{batch},{H + 2},{W + 2},{C}] (the "
                  f"plan: {conv3x3.valid_plan(batch, H, W, C, O, dtype)}): {'; '.join(times)}; "
                  f"F.conv2d {lib:.4f} ms ({flops / lib / 1e9:.1f} TFLOP/s)", flush=True)
    return entries


# The fifteen instance norms of one serving forward at S px: (name, S // H,
# C, pad, residual pad or None, relu, mode, stats from the conv, calls per
# forward).
_IN_CALLS = [
    ("in1", 1, 32, 1, None, True, "reflect", False, 1),
    ("in2", 2, 64, 1, None, True, "reflect", False, 1),
    ("in3", 4, 128, 1, None, True, "reflect", False, 1),
    ("res.in1", 4, 128, 1, None, True, "reflect", True, 5),
    ("res.in2", 4, 128, 1, 1, False, "reflect", False, 4),
    ("res5.in2", 4, 128, 1, 1, False, "edge", False, 1),
    ("up1_in", 2, 64, 1, None, True, "edge", False, 1),
    ("up2_in", 1, 32, 4, None, True, "reflect", False, 1),
]


def check_routes(instance_norm, entries) -> None:
    """The IN-pad calls of both dtypes reached every route of in_plan."""
    reached = {r for e in entries for r in e.pop("routes", [])}
    check(reached == set(instance_norm.ROUTES),
          f"instance_norm_pad: the forward's calls reach every route of in_plan "
          f"({sorted(reached)})")


def in_phase(torch, instance_norm, dtype):
    """IN-pad kernel vs its plain version at every call shape of each
    serving run's forward (256 px at batch 64; in bf16 also 300 px at batch
    64 and 1040 px at batch 4), with the plan, how many of its clusters the
    card runs at once, the share of the bound and a bit-identical repeat
    (the two dtypes' calls together reach every route of ``in_plan``:
    ``check_routes``). ``ms`` is the call timed as the host issues it
    (``time_ms``), ``device_ms`` the calls queued behind a spin kernel
    (``device_ms``): the smaller calls take the host longer to launch than
    the card to run. The JSON entry times the largest call of the 256 px
    forward (in1) and carries that forward's fifteen calls' totals."""
    name = "instance_norm_pad"
    dn = str(dtype).split(".")[1]
    rtol, atol = TOL[(name, dn)]
    g = torch.Generator(device="cuda").manual_seed(2)
    entry = None
    worst = 0.0
    routes = set()
    runs = [(SIZE, BATCH)]
    if dtype == torch.bfloat16:
        runs += [(WIDE_SIZE, BATCH), (WIDEST_SIZE, WIDEST_BATCH)]
    for size, batch in runs:
        timed = size == SIZE  # the plain version and eager times at 256 px only
        total = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
        for call, div, C, pad, rp, relu, mode, with_stats, count in _IN_CALLS:
            H = size // div
            x = (torch.randn(batch, H, H, C, device="cuda", generator=g) * 2 + 0.5).to(dtype)
            scale = torch.rand(C, device="cuda", generator=g) + 0.5
            bias = torch.randn(C, device="cuda", generator=g)
            res = None
            if rp is not None:
                res = torch.randn(batch, H + 2 * rp, H + 2 * rp, C, device="cuda",
                                  generator=g).to(dtype)
            stats = None
            if with_stats:
                xf = x.float()
                stats = (xf.sum(dim=(1, 2)), (xf * xf).sum(dim=(1, 2)))
            args = (x, scale, bias, res, rp or 0, relu, pad, mode, stats)
            plan = instance_norm.in_plan(batch, H, H, C, dtype, with_stats)
            routes.add(plan.route)
            clusters = instance_norm.max_active_clusters(x, plan)
            out = instance_norm.instance_norm_pad(*args)
            again = instance_norm.instance_norm_pad(*args)
            torch.cuda.synchronize()
            pout = instance_norm.instance_norm_pad_plain(*args)
            err = max_err(out, pout)
            worst = max(worst, err)
            tag = f"{name} {dn} {size} px {call} [{batch},{H},{H},{C}] pad {pad} {mode} ({plan})"
            check(allclose(torch, out, pout, rtol, atol),
                  f"{tag}: max_abs_err {err:.3g} (rtol {rtol:.3g}, atol {atol:.3g})")
            check(torch.equal(out, again), f"{tag}: the repeat is bit-identical")
            dev = device_ms(torch, lambda: instance_norm.instance_norm_pad(*args), iters=10)
            ms = plain_ms = math.nan
            if timed:
                ms = time_ms(torch, lambda: instance_norm.instance_norm_pad(*args), iters=10)
                plain_ms = device_ms(torch, lambda: instance_norm.instance_norm_pad_plain(*args),
                                     iters=5)
            interior = x.numel() * (2 if res is not None else 1)
            nbytes = (interior + out.numel()) * x.element_size() + 2 * C * 4
            nbytes += 0 if stats is None else 2 * batch * C * 4
            bound_ms, bound_by = bound(8.0 * x.numel(), nbytes, dn)
            eager = f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} " if timed else ""
            print(f"{name} {dn} {size} px {call}: {eager}device_ms {dev:.4f} bound_ms "
                  f"{bound_ms:.4f} ({bound_by}; {nbytes / 1e6:.1f} MB), {bound_ms / dev:.3f} "
                  f"of the bound (device), {nbytes / dev / 1e6:.0f} GB/s; {clusters} clusters "
                  f"at once; x{count} per forward", flush=True)
            total["ms"] += ms * count
            total["device_ms"] += dev * count
            total["plain_ms"] += plain_ms * count
            total["bound_ms"] += bound_ms * count
            if entry is None:
                entry = {"name": f"{name}.{dn}", "route": "cuda", "source": SOURCES[name][0],
                         "replaces": SOURCES[name][1], "ms": ms, "device_ms": dev,
                         "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": None,
                         "shape": f"x[{batch},{H},{H},{C}] pad {pad} (in1, the largest call)"}
        eager = (f"kernel_ms {total['ms']:.4f} ({total['bound_ms'] / total['ms']:.3f} of the "
                 f"bound) plain_ms {total['plain_ms']:.4f} " if timed else "")
        print(f"{name} {dn} {size} px: all 15 calls of one forward: {eager}device_ms "
              f"{total['device_ms']:.4f} ({total['bound_ms'] / total['device_ms']:.3f} of the "
              f"bound) bound_ms {total['bound_ms']:.4f}", flush=True)
        if timed:
            entry["forward_ms"] = total["ms"]
            entry["forward_device_ms"] = total["device_ms"]
            entry["forward_bound_ms"] = total["bound_ms"]
    entry["routes"] = sorted(routes)
    entry["max_abs_err"] = worst
    return entry


# The fifteen instance norms of one training forward at batch 4, 256 px:
# (name, H, C, residual, relu, calls per step).
_FUSED_CALLS = [
    ("in1", 256, 32, False, True, 1),
    ("in2", 128, 64, False, True, 1),
    ("in3", 64, 128, False, True, 1),
    ("res.in1", 64, 128, False, True, 5),
    ("res.in2", 64, 128, True, False, 5),
    ("up1_in", 128, 64, False, True, 1),
    ("up2_in", 256, 32, False, True, 1),
]


def kernels_per_call(torch, fn) -> int:
    """The device kernels one call of ``fn`` runs, as torch.profiler records
    them (-1 where it records no device event)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    return len(kernels) if kernels else -1


def fused_phase(torch, F, fin, dtype):
    """The fused instance norm's forward and backward kernels against their
    plain versions at every call shape of the training forward; the JSON
    entries time the largest call (in1), beside ``F.instance_norm``. Times
    are device times (``device_ms``); ``eager`` is the same call timed as the
    host issues it."""
    from styletransfer_tpu_torch.ops.cuda import instance_norm

    dn = str(dtype).split(".")[1]
    names = ("fused_instance_norm_fwd", "fused_instance_norm_bwd")
    g = torch.Generator(device="cuda").manual_seed(3)
    entries = {}
    worst = {n: 0.0 for n in names}
    total = {n: {"ms": 0.0, "eager_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                 "library_ms": 0.0} for n in names}
    for call, H, C, with_res, relu, count in _FUSED_CALLS:
        shape = (TRAIN_BATCH, H, H, C)
        x = (torch.randn(*shape, device="cuda", generator=g) * 2 + 0.5).to(dtype)
        res = torch.randn(*shape, device="cuda", generator=g).to(dtype) if with_res else None
        scale = torch.rand(C, device="cuda", generator=g) + 0.5
        bias = torch.randn(C, device="cuda", generator=g)
        gy = torch.randn(*shape, device="cuda", generator=g).to(dtype)
        out, mean, inv = fin.forward(x, scale, bias, res, relu)
        launched = fin.bwd_launches
        dx, dscale, dbias = fin.backward(gy, x, res, mean, inv, scale, bias, relu)
        again = fin.backward(gy, x, res, mean, inv, scale, bias, relu)
        sums_only = fin.backward(gy, x, res, mean, inv, scale, bias, relu, need_dx=False)
        torch.cuda.synchronize()
        launched = fin.bwd_launches - launched
        pout, pmean, pinv = fin.forward_plain(x, scale, bias, res, relu)
        pdx, pdscale, pdbias = fin.backward_plain(gy, x, res, mean, inv, scale, bias, relu)
        tag = f"{dn} {call} [{TRAIN_BATCH},{H},{H},{C}]"
        rtol, atol = TOL[(names[0], dn)]
        err = max_err(out, pout)
        check(allclose(torch, out, pout, rtol, atol),
              f"{names[0]} {tag}: out max_abs_err {err:.3g} (rtol {rtol:.3g}, atol {atol:.3g})")
        check(allclose(torch, mean, pmean, *STATS_TOL) and allclose(torch, inv, pinv, *STATS_TOL),
              f"{names[0]} {tag}: mean / inv max_abs_err {max_err(mean, pmean):.3g} / "
              f"{max_err(inv, pinv):.3g} (rtol {STATS_TOL[0]}, atol {STATS_TOL[1]})")
        worst[names[0]] = max(worst[names[0]], err)
        rtol, atol = TOL[(names[1], dn)]
        err = max_err(dx, pdx)
        check(allclose(torch, dx, pdx, rtol, atol),
              f"{names[1]} {tag}: dx max_abs_err {err:.3g} (rtol {rtol:.3g}, atol {atol:.3g})")
        rel = max(max_err(dscale, pdscale) / float(pdscale.abs().max()),
                  max_err(dbias, pdbias) / float(pdbias.abs().max()))
        check(allclose(torch, dscale, pdscale, *SUMS_TOL)
              and allclose(torch, dbias, pdbias, *SUMS_TOL) and rel <= GRAD_SUMS_RTOL,
              f"{names[1]} {tag}: dscale / dbias max_abs_err {max_err(dscale, pdscale):.3g} / "
              f"{max_err(dbias, pdbias):.3g} (rtol {SUMS_TOL[0]}, atol {SUMS_TOL[1]}), "
              f"{rel:.3g} of the largest (limit {GRAD_SUMS_RTOL})")
        check(all(torch.equal(u, v) for u, v in zip((dx, dscale, dbias), again))
              and sums_only[0] is None and torch.equal(sums_only[1], dscale)
              and torch.equal(sums_only[2], dbias) and launched == 3,
              f"{names[1]} {tag} ({fin.bwd_plan(*shape, fin._resident(x.device, dtype))}): "
              f"the repeat is bit-identical, need_dx=False gives the same dscale / dbias, "
              f"one launch per call ({launched} for 3 calls)")
        worst[names[1]] = max(worst[names[1]], err)
        if with_res:
            # Through the autograd Function: the residual's gradient is dx.
            xr, rr = x.clone().requires_grad_(), res.clone().requires_grad_()
            fin.fused_instance_norm(xr, scale, bias, residual=rr, relu=relu).backward(gy)
            check(torch.equal(xr.grad, rr.grad) and allclose(torch, xr.grad, pdx, rtol, atol),
                  f"{names[1]} {tag}: dresidual equals dx")
        def fwd():
            return fin.forward(x, scale, bias, res, relu)

        def bwd():
            return fin.backward(gy, x, res, mean, inv, scale, bias, relu)

        fwd_ms, bwd_ms = device_ms(torch, fwd), device_ms(torch, bwd)
        # The same calls back to back as the host issues them (CUDA events):
        # what a step pays when the host is slower than the card.
        fwd_eager, bwd_eager = time_ms(torch, fwd), time_ms(torch, bwd)
        fwd_plain = device_ms(torch, lambda: fin.forward_plain(x, scale, bias, res, relu),
                              iters=5)
        bwd_plain = device_ms(torch, lambda: fin.backward_plain(gy, x, res, mean, inv, scale,
                                                                bias, relu), iters=5)
        ins = x.numel() * (2 if with_res else 1) * x.element_size()
        chan = 2 * C * 4 + 2 * TRAIN_BATCH * C * 4  # scale, bias; mean, inv
        fwd_bound, fwd_by = bound(8.0 * x.numel(), ins + out.numel() * x.element_size() + chan,
                                  dn)
        bwd_bytes = ins + 2 * gy.numel() * x.element_size() + chan + 2 * C * 4
        bwd_bound, bwd_by = bound(16.0 * x.numel(), bwd_bytes, dn)
        # The one PyTorch call that computes the same function (no residual,
        # no ReLU): F.instance_norm on the NCHW view, and its autograd
        # backward. The port never calls it.
        xc = x.permute(0, 3, 1, 2).detach().requires_grad_()
        w, b = scale.to(dtype).requires_grad_(), bias.to(dtype).requires_grad_()
        lib_fwd = device_ms(torch, lambda: F.instance_norm(xc, weight=w, bias=b, eps=fin.EPS))
        y = F.instance_norm(xc, weight=w, bias=b, eps=fin.EPS)
        gc = gy.permute(0, 3, 1, 2)
        lib_bwd = device_ms(torch, lambda: torch.autograd.grad(y, (xc, w, b), gc,
                                                               retain_graph=True))
        del y
        plan = instance_norm.in_plan(*shape, dtype, False)
        print(f"fused_instance_norm {dn} {call} ({plan}): fwd kernel_ms {fwd_ms:.4f} (eager "
              f"{fwd_eager:.4f}) plain_ms {fwd_plain:.4f} library_ms {lib_fwd:.4f} bound_ms "
              f"{fwd_bound:.4f}; bwd kernel_ms {bwd_ms:.4f} (eager {bwd_eager:.4f}) plain_ms "
              f"{bwd_plain:.4f} library_ms {lib_bwd:.4f} bound_ms {bwd_bound:.4f} ({bwd_by}; "
              f"{bwd_bytes / 1e6:.1f} MB), {bwd_bound / bwd_ms:.3f} of the bound; x{count} per "
              f"step", flush=True)
        for n, ms, eager, plain, bnd, lib in (
                (names[0], fwd_ms, fwd_eager, fwd_plain, fwd_bound, lib_fwd),
                (names[1], bwd_ms, bwd_eager, bwd_plain, bwd_bound, lib_bwd)):
            total[n]["ms"] += ms * count
            total[n]["eager_ms"] += eager * count
            total[n]["plain_ms"] += plain * count
            total[n]["bound_ms"] += bnd * count
            total[n]["library_ms"] += lib * count
        if call != "in1":
            continue
        kernels = kernels_per_call(torch, bwd)
        check(kernels in (1, -1), f"{names[1]} {tag}: {kernels} device kernels per call "
              f"(torch.profiler; -1: it recorded none)")
        for n, ms, eager, plain, bnd, by, lib in (
                (names[0], fwd_ms, fwd_eager, fwd_plain, fwd_bound, fwd_by, lib_fwd),
                (names[1], bwd_ms, bwd_eager, bwd_plain, bwd_bound, bwd_by, lib_bwd)):
            entries[n] = {"name": f"{n}.{dn}", "route": "cuda", "source": SOURCES[n][0],
                          "replaces": SOURCES[n][1], "ms": ms, "eager_ms": eager,
                          "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
                          "library_ms": lib,
                          "shape": f"x[{TRAIN_BATCH},{H},{H},{C}] (in1, the largest call)"}
        entries[names[1]]["kernels_per_call"] = kernels
    for n in names:
        entries[n]["max_abs_err"] = worst[n]
        entries[n]["step_ms"] = total[n]["ms"]
        entries[n]["step_eager_ms"] = total[n]["eager_ms"]
        entries[n]["step_bound_ms"] = total[n]["bound_ms"]
        entries[n]["step_library_ms"] = total[n]["library_ms"]
        print(f"{n} {dn}: all 15 calls of one train step: kernel_ms {total[n]['ms']:.4f} "
              f"(eager {total[n]['eager_ms']:.4f}; {total[n]['bound_ms'] / total[n]['ms']:.3f} "
              f"of the bound) plain_ms {total[n]['plain_ms']:.4f} library_ms "
              f"{total[n]['library_ms']:.4f} bound_ms {total[n]['bound_ms']:.4f}", flush=True)
    return [entries[n] for n in names]


# The ten 3x3 convs of one Gatys closure at 256 px, batch 1: (name, H, C, O).
# The forward runs conv1_1 on conv3x3_im2col and the other four on
# conv3x3_flat; the input gradient (".dx": C and O swapped) runs all five on
# conv3x3_flat.
_GATYS_CONVS = [
    ("conv1_1", 256, 3, 64), ("conv1_2", 256, 64, 64), ("conv2_1", 128, 64, 128),
    ("conv2_2", 128, 128, 128), ("conv3_1", 64, 128, 256),
    ("conv1_1.dx", 256, 64, 3), ("conv1_2.dx", 256, 64, 64), ("conv2_1.dx", 128, 128, 64),
    ("conv2_2.dx", 128, 128, 128), ("conv3_1.dx", 64, 256, 128),
]


def stat_free_phase(torch, F, cf, dtype):
    """conv3x3_flat and conv3x3_im2col against their plain versions on the
    ten conv shapes of a 256 px Gatys closure (conv1_2 also with ReLU), on
    zero-padded inputs, each call repeated and required to give the same
    bits; device times of both kernels, both plain versions and ``F.conv2d``
    (padding 1, on the unpadded interior) at each shape, with conv3x3_flat's
    plan and rate. The JSON entries: conv3x3_flat's nine calls of a closure,
    summed, and conv3x3_im2col's one (conv1_1)."""
    dn = str(dtype).split(".")[1]
    names = ("conv3x3_flat", "conv3x3_im2col")
    fns = {"conv3x3_flat": (cf.conv3x3_flat, cf.conv3x3_flat_plain),
           "conv3x3_im2col": (cf.conv3x3_im2col, cf.conv3x3_im2col_plain)}
    g = torch.Generator(device="cuda").manual_seed(6)
    worst = {n: 0.0 for n in names}
    total = {n: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flops": 0.0, "bytes": 0.0}
             for n in names}
    for call, H, C, O in _GATYS_CONVS:
        interior = torch.randn(1, H, H, C, device="cuda", generator=g).to(dtype)
        x = F.pad(interior, (0, 0, 1, 1, 1, 1)).contiguous()
        w = (torch.randn(3, 3, C, O, device="cuda", generator=g) * (9 * C) ** -0.5).to(dtype)
        b = torch.randn(O, device="cuda", generator=g) * 0.1
        routed = "conv3x3_im2col" if cf.uses_im2col(C) else "conv3x3_flat"
        flops = 2.0 * H * H * 9 * C * O
        nbytes = (x.numel() + w.numel() + H * H * O) * x.element_size() + O * 4
        bound_ms, bound_by = bound(flops, nbytes, dn)
        # The one PyTorch call that computes the same function: cuDNN on the
        # channels-last view of the interior, zero padding 1, TF32 off.
        xc = interior.permute(0, 3, 1, 2)
        wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        bc = b.to(dtype)
        library_ms = device_ms(torch, lambda: F.conv2d(xc, wc, bc, padding=1), iters=10)
        times = {}
        for name in names:
            fn, plain = fns[name]
            rtol, atol = TOL[(name, dn)]
            for relu in ((False, True) if call == "conv1_2" else (False,)):
                out = fn(x, w, b, relu)
                again = fn(x, w, b, relu)
                torch.cuda.synchronize()
                pout = plain(x, w, b, relu)
                err = max_err(out, pout)
                worst[name] = max(worst[name], err)
                check(allclose(torch, out, pout, rtol, atol) and torch.equal(out, again),
                      f"{name} {dn} {call} [1,{H + 2},{H + 2},{C}] -> {O}"
                      f"{' relu' if relu else ''}: max_abs_err {err:.3g} (rtol {rtol:.3g}, "
                      f"atol {atol:.3g}); the repeat is bit-identical")
            times[name] = (device_ms(torch, lambda: fn(x, w, b), iters=10),
                           device_ms(torch, lambda: plain(x, w, b), iters=5))
        ms, plain_ms = times[routed]
        t = total[routed]
        t["ms"] += ms
        t["plain_ms"] += plain_ms
        t["library_ms"] += library_ms
        t["flops"] += flops
        t["bytes"] += nbytes
        flat_ms = times["conv3x3_flat"][0]
        print(f"stat-free conv {dn} {call} [1,{H},{H},{C}] -> {O} ({flops / 1e9:.3f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB): flat {flat_ms:.4f} ms (plain "
              f"{times['conv3x3_flat'][1]:.4f}; {cf.flat_plan(1, H, H, C, O, dtype)}; "
              f"{flops / flat_ms / 1e9:.1f} TFLOP/s), im2col {times['conv3x3_im2col'][0]:.4f} ms "
              f"(plain {times['conv3x3_im2col'][1]:.4f}; {cf.im2col_plan(1, H, H, C, O, dtype)}), "
              f"library {library_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}); the closure runs {routed} "
              f"({flops / ms / 1e9:.1f} TFLOP/s)", flush=True)
    im2col_at_batch(torch, F, cf, dtype, IM2COL_BATCH)
    entries = []
    for name in names:
        t = total[name]
        bound_ms, bound_by = bound(t["flops"], t["bytes"], dn)
        calls = "the 9 calls of one 256 px closure, summed" if name == "conv3x3_flat" else \
            "conv1_1 of one 256 px closure, its one call"
        print(f"{name} {dn}: {calls}: kernel_ms {t['ms']:.4f} plain_ms {t['plain_ms']:.4f} "
              f"library_ms {t['library_ms']:.4f} bound_ms {bound_ms:.4f} ({bound_by})",
              flush=True)
        entries.append({"name": f"{name}.{dn}", "route": "cuda", "source": SOURCES[name][0],
                        "replaces": SOURCES[name][1], "max_abs_err": worst[name],
                        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": t["library_ms"], "shape": calls})
    return entries


def im2col_at_batch(torch, F, cf, dtype, batch):
    """conv3x3_im2col at conv1_1 of a batch of 256 px images (a train step's
    and a Gatys directory's call), held against its plain version with a
    bit-identical repeat, with its plan and device times beside the plain
    version's, ``F.conv2d``'s and the bound."""
    dn = str(dtype).split(".")[1]
    _, H, C, O = _GATYS_CONVS[0]
    g = torch.Generator(device="cuda").manual_seed(7)
    interior = torch.randn(batch, H, H, C, device="cuda", generator=g).to(dtype)
    x = F.pad(interior, (0, 0, 1, 1, 1, 1)).contiguous()
    w = (torch.randn(3, 3, C, O, device="cuda", generator=g) * (9 * C) ** -0.5).to(dtype)
    b = torch.randn(O, device="cuda", generator=g) * 0.1
    rtol, atol = TOL[("conv3x3_im2col", dn)]
    out = cf.conv3x3_im2col(x, w, b)
    again = cf.conv3x3_im2col(x, w, b)
    torch.cuda.synchronize()
    pout = cf.conv3x3_im2col_plain(x, w, b)
    err = max_err(out, pout)
    plan = cf.im2col_plan(batch, H, H, C, O, dtype)
    check(allclose(torch, out, pout, rtol, atol) and torch.equal(out, again),
          f"conv3x3_im2col {dn} conv1_1 [{batch},{H + 2},{H + 2},{C}] -> {O} ({plan}): "
          f"max_abs_err {err:.3g} (rtol {rtol:.3g}, atol {atol:.3g}); the repeat is "
          f"bit-identical")
    ms = device_ms(torch, lambda: cf.conv3x3_im2col(x, w, b), iters=10)
    plain_ms = device_ms(torch, lambda: cf.conv3x3_im2col_plain(x, w, b), iters=5)
    xc = interior.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    library_ms = device_ms(torch, lambda: F.conv2d(xc, wc, b.to(dtype), padding=1), iters=10)
    flops = 2.0 * batch * H * H * 9 * C * O
    nbytes = (x.numel() + w.numel() + batch * H * H * O) * x.element_size() + O * 4
    bound_ms, bound_by = bound(flops, nbytes, dn)
    print(f"conv3x3_im2col {dn} conv1_1 at batch {batch}: kernel_ms {ms:.4f} "
          f"({bound_ms / ms:.3f} of the bound) plain_ms {plain_ms:.4f} library_ms "
          f"{library_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}) max_abs_err {err:.3g}; "
          f"{plan}", flush=True)


def write_inputs(np):
    from PIL import Image

    in_dir = os.path.join(WORK, "images")
    os.makedirs(in_dir, exist_ok=True)
    imgs = np.random.default_rng(0).integers(0, 256, size=(BATCH, SIZE, SIZE, 3),
                                             dtype=np.uint8)
    for i, img in enumerate(imgs):
        Image.fromarray(img).save(os.path.join(in_dir, f"img{i:03d}.png"))
    return in_dir, imgs


def main_path(torch, np, in_dir, imgs):
    """The serving path: fast_st inference through process_dir, from a
    seeded checkpoint. Returns each precision's launch counts and img/s."""
    from PIL import Image

    from styletransfer_tpu_torch import ckpt
    from styletransfer_tpu_torch.engines import fast
    from styletransfer_tpu_torch.models import transformer
    from styletransfer_tpu_torch.ops.cuda import conv3x3, instance_norm
    from styletransfer_tpu_torch.utils import images

    models = os.path.join(WORK, "models")
    params = transformer.init_params(seed=0, device="cuda")
    ckpt.save(params, ckpt.checkpoint_path("fast_st", "smoke", 0, models))
    cpu_params, _ = ckpt.load_latest_transformer("fast_st", "smoke", models, device="cpu")
    launches = {}
    rates = {}
    for precision in ("f32", "bf16"):
        out_dir = os.path.join(WORK, f"out_{precision}")
        reset_counts()
        t0 = time.perf_counter()
        paths = fast.process_dir(in_dir, "smoke", out_dir=out_dir, batch_size=BATCH,
                                 models_path=models, precision=precision, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        launches[precision] = counts
        route = "f32_fma" if precision == "f32" else "bf16_wgmma"
        want = {k: 0 for k in counts}
        want.update({"conv3x3_valid": 10, f"conv3x3_valid.{route}": 10, "instance_norm_pad": 15})
        check(counts == want,
              f"serving path {precision}: one forward launched {counts} (want 10 conv3x3, all "
              f"on the {route} route, 15 IN-pad, no training kernel)")
        check(len(paths) == BATCH, f"serving path {precision}: {len(paths)} PNGs written")
        outs = np.stack([np.asarray(Image.open(p)) for p in sorted(paths)])
        check(outs.shape == (BATCH, SIZE, SIZE, 3) and outs.dtype == np.uint8,
              f"serving path {precision}: outputs {outs.shape} {outs.dtype}")
        # The CPU run of the port on the first two images.
        serve = fast.make_serve_fn(precision)
        ref = serve(cpu_params, torch.from_numpy(imgs[:2])).numpy()
        diff = np.abs(outs[:2].astype(np.int32) - ref.astype(np.int32))
        max_steps, mean_steps = MAIN_TOL[precision]
        check(int(diff.max()) <= max_steps and float(diff.mean()) <= mean_steps,
              f"serving path {precision}: card vs CPU on 2 images: max {int(diff.max())}/255, "
              f"mean {float(diff.mean()):.4f}/255 (limits {max_steps}, {mean_steps})")
        # The float output before the uint8 cast (which would hide a NaN).
        batch = torch.from_numpy(imgs).cuda()
        y = transformer.apply(params, images.maybe_normalize_on_device(batch),
                              compute_dtype=torch.bfloat16 if precision == "bf16" else None)
        check(y.shape == (BATCH, SIZE, SIZE, 3) and bool(torch.isfinite(y).all()),
              f"serving path {precision}: forward output {tuple(y.shape)}, all finite")
        # Steady-state serving rate of the forward at batch 64 on the card.
        out = serve(params, batch)
        same = int((out.cpu().int() - torch.from_numpy(outs).int()).abs().max())
        check(same <= 1, f"serving path {precision}: serve_fn within {same}/255 of the saved PNGs")
        ms = time_ms(torch, lambda: serve(params, batch), iters=10, warmup=2)
        rates[precision] = BATCH / (ms / 1e3)
        print(f"serving path {precision}: process_dir {BATCH} images in {wall:.3f} s "
              f"(incl. checkpoint load, decode, PNG encode); serve_fn batch {BATCH}: "
              f"{ms:.3f} ms = {rates[precision]:.1f} img/s", flush=True)
    # bf16 at WIDE_SIZE px (convert-dir --size 300): the residual stage is 75
    # wide, whose rows fill the wgmma kernel's tiles only in part.
    out_dir = os.path.join(WORK, "out_wide")
    reset_counts()
    t0 = time.perf_counter()
    paths = fast.process_dir(in_dir, "smoke", out_dir=out_dir, batch_size=BATCH,
                             models_path=models, size=WIDE_SIZE, precision="bf16",
                             device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches["wide"] = counts
    want = {k: 0 for k in counts}
    want.update({"conv3x3_valid": 10, "conv3x3_valid.bf16_wgmma": 10, "instance_norm_pad": 15})
    check(counts == want, f"serving path bf16 at {WIDE_SIZE} px: one forward launched {counts} "
          f"(want 10 conv3x3, all on the bf16_wgmma route, 15 IN-pad)")
    outs = np.stack([np.asarray(Image.open(p)) for p in sorted(paths)])
    check(outs.shape == (BATCH, WIDE_SIZE, WIDE_SIZE, 3),
          f"serving path bf16 at {WIDE_SIZE} px: outputs {outs.shape}")
    inputs = np.stack([images.load_image_uint8(os.path.join(in_dir, f), size=WIDE_SIZE)[0]
                       for f in sorted(os.listdir(in_dir))[:2]])
    ref = fast.make_serve_fn("bf16")(cpu_params, torch.from_numpy(inputs)).numpy()
    diff = np.abs(outs[:2].astype(np.int32) - ref.astype(np.int32))
    max_steps, mean_steps = MAIN_TOL["bf16"]
    check(int(diff.max()) <= max_steps and float(diff.mean()) <= mean_steps,
          f"serving path bf16 at {WIDE_SIZE} px: card vs CPU on 2 images: max "
          f"{int(diff.max())}/255, mean {float(diff.mean()):.4f}/255 (limits {max_steps}, "
          f"{mean_steps}); process_dir {BATCH} images in {wall:.3f} s")
    # bf16 at WIDEST_SIZE px on WIDEST_BATCH images: 260-wide residual rows,
    # wider than a TMA box, which the wgmma kernel cuts into segments.
    few_dir = os.path.join(WORK, "images_few")
    os.makedirs(few_dir)
    for f in sorted(os.listdir(in_dir))[:WIDEST_BATCH]:
        shutil.copy(os.path.join(in_dir, f), few_dir)
    reset_counts()
    t0 = time.perf_counter()
    paths = fast.process_dir(few_dir, "smoke", out_dir=os.path.join(WORK, "out_widest"),
                             batch_size=WIDEST_BATCH, models_path=models, size=WIDEST_SIZE,
                             precision="bf16", device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches["widest"] = counts
    want = {k: 0 for k in counts}
    want.update({"conv3x3_valid": 10, "conv3x3_valid.bf16_wgmma": 10, "instance_norm_pad": 15})
    check(counts == want, f"serving path bf16 at {WIDEST_SIZE} px: one forward launched {counts} "
          f"(want 10 conv3x3, all on the bf16_wgmma route, 15 IN-pad)")
    outs = np.stack([np.asarray(Image.open(p)) for p in sorted(paths)])
    check(outs.shape == (WIDEST_BATCH, WIDEST_SIZE, WIDEST_SIZE, 3),
          f"serving path bf16 at {WIDEST_SIZE} px: outputs {outs.shape}")
    # The float output before the uint8 cast is finite, and the served
    # image matches the same forward with the ten residual convs and the
    # fifteen instance norms on their plain versions (a CPU run at this size
    # would take minutes).
    batch = torch.from_numpy(np.stack([
        images.load_image_uint8(os.path.join(few_dir, f), size=WIDEST_SIZE)[0]
        for f in sorted(os.listdir(few_dir))[:1]])).cuda()
    y = transformer.apply(params, images.maybe_normalize_on_device(batch),
                          compute_dtype=torch.bfloat16)
    serve = fast.make_serve_fn("bf16")
    got = serve(params, batch)
    kernels = transformer.conv3x3_valid, transformer.instance_norm_pad
    transformer.conv3x3_valid = conv3x3.conv3x3_valid_plain
    transformer.instance_norm_pad = instance_norm.instance_norm_pad_plain
    try:
        ref = serve(params, batch)
    finally:
        transformer.conv3x3_valid, transformer.instance_norm_pad = kernels
    diff = (got.int() - ref.int()).abs()
    max_steps, mean_steps = MAIN_TOL["bf16"]
    check(bool(torch.isfinite(y).all()) and int(diff.max()) <= max_steps
          and float(diff.float().mean()) <= mean_steps,
          f"serving path bf16 at {WIDEST_SIZE} px: forward output finite; on the kernels against "
          f"the convs' and instance norms' plain versions: max {int(diff.max())}/255, mean "
          f"{float(diff.float().mean()):.4f}/255 (limits {max_steps}, {mean_steps}); process_dir "
          f"{WIDEST_BATCH} images in {wall:.3f} s")
    return launches, rates


class _LossLog(logging.Handler):
    """Collects the losses static_train logs."""

    def __init__(self):
        super().__init__()
        self.train, self.test = [], []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("Batch Loss:"):
            self.train.append(float(msg.split(":")[1]))
        elif msg.startswith("Average test loss:"):
            self.test.append(float(msg.split(":")[1]))


def _style_image(np):
    from styletransfer_tpu_torch.data import coco
    from styletransfer_tpu_torch.utils import images

    return images.normalize(coco.synthetic_image(10_000, SIZE))[None].astype(np.float32)


def train_path(torch, np, in_dir):
    """The training path: static_train for TRAIN_STEPS steps at batch 4, in
    f32 and bf16, from seeded parameters on the synthetic corpus; then its
    epoch checkpoint through the serving path. Returns each precision's
    launch counts of the training run."""
    from PIL import Image

    from styletransfer_tpu_torch import ckpt
    from styletransfer_tpu_torch.data import coco
    from styletransfer_tpu_torch.engines import fast
    from styletransfer_tpu_torch.models import transformer, vgg
    from styletransfer_tpu_torch.utils.logging import get_logger

    style = _style_image(np)
    vgg_params = vgg.init_params(seed=0, device="cuda")
    _, image_every, eval_every = TRAIN_CADENCE
    launches = {}
    for precision in ("f32", "bf16"):
        models = os.path.join(WORK, f"models_train_{precision}")
        test_loader, train_loader = coco.get_coco_loader(
            batch_size=TRAIN_BATCH, test_limit=20, image_dir=os.path.join(WORK, "no_images"))
        previews = len(range(0, TRAIN_STEPS, image_every))
        eval_forwards = len(test_loader) * len(range(0, TRAIN_STEPS, eval_every))
        params = transformer.init_params(seed=0, device="cuda")
        log = _LossLog()
        logger = get_logger()
        logger.addHandler(log)
        reset_counts()
        t0 = time.perf_counter()
        try:
            fast.static_train(
                style, style_name="smoke", epochs=1, batch_size=TRAIN_BATCH,
                vgg_params=vgg_params, params=params, train_loader=train_loader,
                test_loader=test_loader, log_cadence=TRAIN_CADENCE,
                runs_dir=os.path.join(WORK, f"runs_{precision}"), models_path=models,
                max_steps_per_epoch=TRAIN_STEPS, step_checkpoint_every=3,
                precision=precision, device="cuda")
            torch.cuda.synchronize()
        finally:
            logger.removeHandler(log)
        wall = time.perf_counter() - t0
        counts = read_counts()
        launches[precision] = counts
        want = {k: 0 for k in counts}
        want.update({"fused_instance_norm_fwd": NORMS_PER_FORWARD * (TRAIN_STEPS + previews
                                                                     + eval_forwards),
                     "fused_instance_norm_bwd": NORMS_PER_FORWARD * TRAIN_STEPS})
        for k in GATYS_KERNELS:
            want[k] = (VGG_PER_STEP[k] * TRAIN_STEPS + VGG_PER_EVAL[k] * eval_forwards
                       + VGG_STYLE_TARGETS[k])
        check(counts == want,
              f"training path {precision}: {TRAIN_STEPS} steps, {previews} previews and "
              f"{eval_forwards} eval forwards launched {counts} (want {want}: 15 IN forward and "
              f"15 backward per step, 15 forward per preview or eval forward; VGG convs "
              f"{VGG_PER_STEP} per step, {VGG_PER_EVAL} per eval forward, "
              f"{VGG_STYLE_TARGETS} for the style targets)")
        check(len(log.train) == TRAIN_STEPS and all(math.isfinite(v) for v in log.train),
              f"training path {precision}: logged losses {['%.4f' % v for v in log.train]} "
              f"all finite")
        check(len(log.test) == 1 and math.isfinite(log.test[0]),
              f"training path {precision}: eval loss {log.test} finite")
        state = ckpt.load_step_state("fast_st", "smoke", models, extra_keys=("batch_in_epoch",))
        check(state is not None and (state["epoch"], state["iteration"]) == (1, TRAIN_STEPS)
              and int(state["opt_state"]["0"]["count"]) == TRAIN_STEPS,
              f"training path {precision}: step state at epoch 1, iteration {TRAIN_STEPS}, "
              f"Adam count {TRAIN_STEPS}")
        print(f"training path {precision}: static_train {TRAIN_STEPS} steps at batch "
              f"{TRAIN_BATCH} in {wall:.3f} s (incl. VGG targets, eval, previews, "
              f"checkpoints)", flush=True)
        # The epoch checkpoint it wrote, through the serving path.
        trained, epoch = ckpt.load_latest_transformer("fast_st", "smoke", models, device="cuda")
        check(epoch == 0 and all(torch.equal(a, b) for a, b in
                                 zip(trained.parameters(), params.parameters())),
              f"training path {precision}: the epoch checkpoint holds the trained parameters")
        reset_counts()
        paths = fast.process_dir(in_dir, "smoke", out_dir=os.path.join(WORK, f"styl_{precision}"),
                                 batch_size=BATCH, models_path=models, precision=precision,
                                 device="cuda")
        served = read_counts()
        outs = np.stack([np.asarray(Image.open(p)) for p in sorted(paths)])
        check(len(paths) == BATCH and outs.shape == (BATCH, SIZE, SIZE, 3)
              and served["conv3x3_valid"] == 10 and served["instance_norm_pad"] == 15,
              f"training path {precision}: the trained checkpoint stylized {len(paths)} images "
              f"through process_dir ({served['conv3x3_valid']} conv3x3, "
              f"{served['instance_norm_pad']} IN-pad launches)")
    return launches


def parity_phase(torch, np):
    """One f32 training step's loss and gradients on two images: the card
    against the port's CPU run, from the same seeded parameters."""
    from styletransfer_tpu_torch.data import coco
    from styletransfer_tpu_torch.engines import fast
    from styletransfer_tpu_torch.models import transformer, vgg
    from styletransfer_tpu_torch.utils import images

    style = torch.from_numpy(_style_image(np))
    batch = torch.from_numpy(np.stack([images.normalize(coco.synthetic_image(i, SIZE))
                                       for i in range(2)]).astype(np.float32))
    cpu_params = transformer.init_params(seed=1, device="cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        params = (cpu_params if dev == "cpu" else transformer.params_from_jax(
            transformer.params_to_tree(cpu_params), device=dev))
        vgg_params = vgg.init_params(seed=0, device=dev)
        grams = vgg.style_gram_targets(vgg_params, style.to(dev))
        t0 = time.perf_counter()
        total, metrics = fast.loss_fn(params, batch.to(dev), vgg_params, grams, 100_000.0, 1.0)
        total.backward()
        grads = {n: p.grad.detach().cpu() for n, p in params.named_parameters()}
        runs[dev] = ({k: float(v.detach()) for k, v in metrics.items()}, grads)
        print(f"parity: loss and gradients on {dev} in {time.perf_counter() - t0:.3f} s",
              flush=True)
    (mg, gg), (mc, gc) = runs["cuda"], runs["cpu"]
    worst_loss = max(abs(mg[k] - mc[k]) / abs(mc[k]) for k in mc)
    check(worst_loss <= PARITY_LOSS_RTOL,
          f"parity f32: loss components card {mg} vs CPU {mc}: worst relative difference "
          f"{worst_loss:.3g} (limit {PARITY_LOSS_RTOL})")
    scale = max(float(g.norm()) for g in gc.values())
    worst, worst_name = 0.0, ""
    for name, g in gc.items():
        ref = float(g.norm())
        if ref < 1e-6 * scale:
            # A bias that an instance norm cancels: zero up to rounding.
            check(float(gg[name].norm()) < 1e-5 * scale,
                  f"parity f32: {name} gradient is zero up to rounding on both")
            continue
        rel = float((gg[name] - g).norm()) / ref
        if rel > worst:
            worst, worst_name = rel, name
    check(worst <= PARITY_GRAD_REL_L2,
          f"parity f32: every parameter gradient within relative L2 {PARITY_GRAD_REL_L2} of the "
          f"CPU run (worst {worst:.3g}, {worst_name})")
    return worst_loss, worst


def step_rates(torch, np):
    """Steady-state train steps (forward, backward, Adam) on the card: ms per
    step and img/s at STEP_BATCHES, f32 and bf16, with peak memory."""
    from styletransfer_tpu_torch.engines import fast
    from styletransfer_tpu_torch.models import transformer, vgg

    style = torch.from_numpy(_style_image(np)).cuda()
    vgg_params = vgg.init_params(seed=0, device="cuda")
    grams = vgg.style_gram_targets(vgg_params, style)
    g = torch.Generator(device="cuda").manual_seed(5)
    rates = {}
    for precision in ("f32", "bf16"):
        cd = torch.bfloat16 if precision == "bf16" else None
        step = fast.make_train_step(vgg_params, grams, compute_dtype=cd)
        for batch in STEP_BATCHES:
            params = transformer.init_params(seed=0, device="cuda")
            opt = fast.make_optimizer(params)
            x = torch.randn(batch, SIZE, SIZE, 3, device="cuda", generator=g)
            for _ in range(3):
                step(params, opt, x)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            iters = 10
            t0 = time.perf_counter()
            for _ in range(iters):
                m = step(params, opt, x)
            loss = float(m["total"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / iters
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            check(math.isfinite(loss), f"train step {precision} batch {batch}: loss {loss:.4f} "
                  "finite")
            rates[(precision, batch)] = batch / (ms / 1e3)
            print(f"train step {precision} batch {batch} at {SIZE} px: {ms:.3f} ms/step = "
                  f"{rates[(precision, batch)]:.1f} img/s, peak memory {peak:.2f} GiB",
                  flush=True)
    return rates


class _GatysLog(logging.Handler):
    """Collects the losses train_gatys logs (the first step's and the last)."""

    def __init__(self):
        super().__init__()
        self.losses = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("Gatys step") or msg.startswith("Gatys final loss:"):
            self.losses.append(float(msg.rsplit(":", 1)[1]))


def _save_png(np, path, index):
    from PIL import Image

    from styletransfer_tpu_torch.data import coco

    img = coco.synthetic_image(index, GATYS_SIZE)
    Image.fromarray(np.round(img * 255).astype(np.uint8)).save(path)


def gatys_path(torch, np, F):
    """The Gatys path through the port's ``gatys_st`` command: f32 and bf16
    runs of GATYS_STEPS steps, the CLI's defaults once, and a directory of
    GATYS_LANES images. Returns each precision's launch counts."""
    from PIL import Image

    from styletransfer_tpu_torch import constants
    from styletransfer_tpu_torch.clis import cli
    from styletransfer_tpu_torch.engines import gatys
    from styletransfer_tpu_torch.models import vgg
    from styletransfer_tpu_torch.utils import images
    from styletransfer_tpu_torch.utils.logging import get_logger

    root = os.path.join(WORK, "gatys")
    lanes_dir = os.path.join(root, "lanes")
    os.makedirs(lanes_dir)
    content, style = os.path.join(root, "content.png"), os.path.join(root, "style.png")
    _save_png(np, content, 20_000)
    _save_png(np, style, 20_001)
    for i in range(GATYS_LANES):
        _save_png(np, os.path.join(lanes_dir, f"img{i}.png"), 20_100 + i)
    results = os.path.join(root, "results")
    conv_calls = [0]
    library_conv = F.conv2d

    def counting_conv2d(*args, **kwargs):
        conv_calls[0] += 1
        return library_conv(*args, **kwargs)

    def run(label, args):
        """One CLI run; checks its launches, the absence of cuDNN convs and
        its losses. Returns (counts, closure evaluations, wall seconds)."""
        reset_counts()
        gatys.closure_evals = 0
        conv_calls[0] = 0
        log = _GatysLog()
        logger = get_logger()
        logger.addHandler(log)
        t0 = time.perf_counter()
        try:
            cli.main(["gatys_st", *args, "--device", "cuda"], standalone_mode=False)
            torch.cuda.synchronize()
        finally:
            logger.removeHandler(log)
        wall = time.perf_counter() - t0
        counts, evals = read_counts(), gatys.closure_evals
        want = {k: 0 for k in counts}
        for k in GATYS_KERNELS:
            want[k] = GATYS_PER_CLOSURE[k] * evals + GATYS_TARGETS[k]
        check(evals > 0 and counts == want,
              f"gatys path {label}: {evals} closure evaluations launched {counts} (want {want}: "
              f"{GATYS_PER_CLOSURE} per evaluation, {GATYS_TARGETS} for the targets)")
        check(conv_calls[0] == 0,
              f"gatys path {label}: {conv_calls[0]} F.conv2d (cuDNN) calls in the VGG tower")
        check(len(log.losses) >= 2 and all(math.isfinite(v) for v in log.losses)
              and log.losses[-1] < log.losses[0],
              f"gatys path {label}: logged losses {log.losses} finite and falling")
        return counts, evals, wall

    saved_root = constants.PROJECT_ROOT_PATH
    constants.PROJECT_ROOT_PATH = root
    F.conv2d = counting_conv2d
    launches = {}
    try:
        common = ["--size", str(GATYS_SIZE), "--history-size", "100", "--history-math",
                  "compact"]
        for precision in ("f32", "bf16"):
            counts, evals, wall = run(precision, [
                content, style, "-s", str(GATYS_STEPS), "--precision", precision,
                "-n", f"gatys_{precision}.png", *common])
            launches[precision] = counts
            out = np.asarray(Image.open(os.path.join(results, f"gatys_{precision}.png")))
            check(out.shape == (GATYS_SIZE, GATYS_SIZE, 3) and out.dtype == np.uint8,
                  f"gatys path {precision}: PNG {out.shape} {out.dtype} written")
            print(f"gatys path {precision}: gatys_st -s {GATYS_STEPS} at {GATYS_SIZE} px: "
                  f"{evals} closure evaluations in {wall:.3f} s (the whole command: VGG init, "
                  f"image loads, targets, PNG) = {evals / wall:.1f} evals/s", flush=True)
            # Steady state: the optimizer alone, again, on the same inputs.
            vgg_params = vgg.load_params(device="cuda")
            c = torch.from_numpy(images.load_image(content, GATYS_SIZE)).cuda()
            grams = vgg.style_gram_targets(
                vgg_params, torch.from_numpy(images.load_image(style, GATYS_SIZE)).cuda())
            gatys.closure_evals = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, hist = gatys._run_lbfgs_torch(
                vgg_params, c, grams, GATYS_STEPS, 100_000.0, 1.0,
                compute_dtype=torch.bfloat16 if precision == "bf16" else None,
                history_size=100, history_math="compact")
            float(hist[-1])
            dt = time.perf_counter() - t0
            print(f"gatys optimizer {precision}: {gatys.closure_evals} closure evaluations in "
                  f"{dt:.3f} s = {gatys.closure_evals / dt:.1f} evals/s, "
                  f"{dt * 1e3 / GATYS_STEPS:.1f} ms per outer step, "
                  f"{dt * 1e3 / gatys.closure_evals:.3f} ms per evaluation "
                  f"(losses {[round(float(v), 3) for v in hist]})", flush=True)
        # The CLI's defaults: 300 steps at 256 px, L-BFGS H = 100, f32.
        _, evals, wall = run("default", [content, style, "-n", "gatys_default.png"])
        print(f"gatys path default (300 steps, f32, 256 px): {wall:.2f} s for one image, "
              f"{evals} closure evaluations = {evals / wall:.1f} evals/s", flush=True)
        # A directory: GATYS_LANES independent lanes in one optimization.
        _, evals, wall = run("lanes", [lanes_dir, style, "-b", str(GATYS_LANES),
                                       "-s", str(GATYS_LANE_STEPS), *common])
        outs = sorted(f for f in os.listdir(results) if f.startswith("gatys_converted_img"))
        check(len(outs) == GATYS_LANES,
              f"gatys path lanes: {len(outs)} PNGs written for {GATYS_LANES} images")
        print(f"gatys path lanes: {GATYS_LANES} images, -s {GATYS_LANE_STEPS}: {evals} closure "
              f"evaluations of all lanes in {wall:.3f} s = {evals * GATYS_LANES / wall:.1f} "
              f"image-evals/s", flush=True)
    finally:
        F.conv2d = library_conv
        constants.PROJECT_ROOT_PATH = saved_root
    return launches


def gatys_parity(torch, np):
    """One f32 closure (loss and pixel gradient) on one 64 px image: the card
    against the port's CPU run, from the same seeded parameters."""
    from styletransfer_tpu_torch.data import coco
    from styletransfer_tpu_torch.engines import gatys
    from styletransfer_tpu_torch.models import vgg
    from styletransfer_tpu_torch.utils import images

    def img(i):
        return torch.from_numpy(images.normalize(
            coco.synthetic_image(i, GATYS_PARITY_SIZE))[None].astype(np.float32))

    content, style, pixels = img(30_000), img(30_001), img(30_002)
    cpu_params = vgg.init_params(seed=0, device="cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        params = {k: {leaf: v.to(dev) for leaf, v in p.items()} for k, p in cpu_params.items()}
        grams = vgg.style_gram_targets(params, style.to(dev))
        loss_fn = gatys.make_loss_fn(params, content.to(dev), grams)
        x = pixels.to(dev).requires_grad_()
        loss = loss_fn(x)
        loss.sum().backward()
        runs[dev] = (float(loss.detach()[0]), x.grad.cpu())
    (lg, gg), (lc, gc) = runs["cuda"], runs["cpu"]
    rel_loss = abs(lg - lc) / abs(lc)
    rel_grad = float((gg - gc).norm() / gc.norm())
    check(rel_loss <= GATYS_PARITY_LOSS_RTOL and rel_grad <= GATYS_PARITY_GRAD_REL_L2,
          f"gatys parity f32 {GATYS_PARITY_SIZE} px: loss card {lg:.6f} vs CPU {lc:.6f} "
          f"(relative {rel_loss:.3g}, limit {GATYS_PARITY_LOSS_RTOL}), pixel gradient relative "
          f"L2 {rel_grad:.3g} (limit {GATYS_PARITY_GRAD_REL_L2})")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU is available; this test runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import numpy as np
        import torch.nn.functional as F

        from styletransfer_tpu_torch.ops import layers
        from styletransfer_tpu_torch.ops.cuda import (
            _build, conv3x3, conv3x3_flat, fused_instance_norm, instance_norm)
    except ImportError as exc:
        print(f"chip_smoke: run it from a checkout of the repository ({exc})",
              file=sys.stderr)
        return 1

    card = gpu_line()
    print(card, flush=True)
    layers.disable_tf32()
    shutil.rmtree(WORK, ignore_errors=True)
    t_start = time.perf_counter()
    try:
        t0 = time.perf_counter()
        built = _build.build_all()
        print(f"built {built} with {' '.join(_build.NVCC_FLAGS)} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        for src, log in _build.build_logs.items():
            for line in log.splitlines():
                if "Used" in line or "spill" in line:
                    print(f"  {src}: {line.strip()}")
        if sys.argv[1:] == ["--stat-free"]:
            for dtype in (torch.float32, torch.bfloat16):
                stat_free_phase(torch, F, conv3x3_flat, dtype)
            print(card)
            return 0
        if sys.argv[1:] == ["--convs"]:
            for dtype in (torch.float32, torch.bfloat16):
                conv_phase(torch, F, conv3x3, dtype)
            print(card)
            return 0
        if sys.argv[1:] == ["--norms"]:
            norms = []
            for dtype in (torch.float32, torch.bfloat16):
                norms.append(in_phase(torch, instance_norm, dtype))
                fused_phase(torch, F, fused_instance_norm, dtype)
            check_routes(instance_norm, norms)
            print(card)
            return 0
        entries = []
        for dtype in (torch.float32, torch.bfloat16):
            entries += conv_phase(torch, F, conv3x3, dtype)
            entries.append(in_phase(torch, instance_norm, dtype))
            entries += fused_phase(torch, F, fused_instance_norm, dtype)
            entries += stat_free_phase(torch, F, conv3x3_flat, dtype)
        check_routes(instance_norm, entries)
        in_dir, imgs = write_inputs(np)
        serve_launches, rates = main_path(torch, np, in_dir, imgs)
        train_launches = train_path(torch, np, in_dir)
        parity_phase(torch, np)
        step_rate = step_rates(torch, np)
        gatys_launches = gatys_path(torch, np, F)
        gatys_parity(torch, np)
    except CheckFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    for e in entries:
        kernel, dn = e["name"].split(".")
        precision = "f32" if dn == "float32" else "bf16"
        if kernel == "conv3x3_valid_wide":  # the WIDE_SIZE serving run
            e["launches"] = serve_launches["wide"]["conv3x3_valid.bf16_wgmma"]
            continue
        if kernel == "conv3x3_valid_widest":  # the WIDEST_SIZE serving run
            e["launches"] = serve_launches["widest"]["conv3x3_valid.bf16_wgmma"]
            continue
        if kernel == "conv3x3_valid_mma":  # forced only: no serving run takes it
            e["launches"] = sum(c["conv3x3_valid.bf16_mma"] for c in serve_launches.values())
            continue
        if kernel == "conv3x3_valid":  # the route of the 256 px serving run
            kernel = "conv3x3_valid." + ("f32_fma" if precision == "f32" else "bf16_wgmma")
        path = (serve_launches if kernel.startswith(SERVING_KERNELS) else
                gatys_launches if kernel in GATYS_KERNELS else train_launches)
        e["launches"] = path[precision][kernel]
    unused = [e["name"] for e in entries if e["launches"] == 0 and "forced" not in e]
    if unused:
        print(f"chip_smoke: FAILED: {unused} launched no time on their main path",
              file=sys.stderr)
        return 1
    kind = torch.cuda.get_device_name(0)
    print(f"serving path img/s at batch {BATCH}, 256 px: f32 {rates['f32']:.1f}, "
          f"bf16 {rates['bf16']:.1f} on {card}")
    print("training img/s at 256 px: " + ", ".join(
        f"{p} batch {b} {r:.1f}" for (p, b), r in step_rate.items()) + f" on {card}")
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s after the import")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
