#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --convs       # phases 1-2 and conv3x3_valid only
    python3 chip_smoke.py --stat-free   # phases 1-2 and the stat-free convs only
    python3 chip_smoke.py --norms       # phases 1-2 and the instance norms only
    python3 chip_smoke.py --video       # phases 1-2, conv_direct, video / zeros, multi-style

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
   images (a train step's and a Gatys directory's call); and conv_direct
   (not a TPU kernel: the fixed-order conv that takes over the six convs the
   JAX package leaves to XLA, in the video stylizer) at those six convs of a
   256 px forward, at batch 64 and 1, against its plain version, with a
   bit-identical repeat, lanes bit for bit as each image alone, and times
   beside F.conv2d;
4. drive the serving path, fast_st inference: a seeded checkpoint written
   with ``ckpt.save``, 64 seeded 256x256 PNGs, ``engines.fast.process_dir``
   from the checkpoint load to the saved PNGs, in f32 and bf16. The launch
   counters must show 10 conv3x3 and 15 IN-pad launches per forward, the
   conv3x3 ones all on the f32_fma or bf16_wgmma route, and the first two
   outputs must match the port's own CPU run; then the same images at 300 px
   in bf16, whose 75-wide residual convs take the bf16_wgmma route too, and
   four of them at 1040 px in bf16, whose 260-wide residual convs take the
   bf16_wgmma route on segments of rows (one image against the same forward
   on the convs' and instance norms' plain versions); then multi-style
   inference: IN-pad with per-image [N, C] affines at the fifteen call
   shapes (against the plain version; a [C] affine and its row repeated as
   [N, C] give the same bits), ``fast_st convert-image-multi`` by index and
   by blend on a seeded 4-style checkpoint (10 conv3x3_valid and 15 IN-pad
   launches each; against the port's CPU run within the serving limits),
   and a mixed batch of 64 (launches, finite output, img/s);
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
9. the video and zero-padding slice (also alone with ``--video``):
   conv3x3_flat at the zero-padded forward's residual shape ([64, 66, 66,
   128] -> 128, f32 and bf16: against its plain version, a bit-identical
   repeat, its plan, times beside F.conv2d); ``video_st`` training
   (``engines.video.video_train``, one epoch of 4 synthetic 48-frame 256 px
   clips at batch 4 in chunks of 16, f32 and bf16, with step checkpoints:
   per frame step 15 fused-IN forwards and backwards, 2 conv3x3_im2col and
   12 conv3x3_flat, 15 fused-IN forwards per preview; finite losses; the
   step state and the epoch checkpoint; ms per frame step); one f32 scan
   step of 3 frames (the third padded) on 2 clips at 64 px, card against
   the port's CPU run; ``convert-video`` of a 48-frame GIF from that
   checkpoint (48 frames written, 6 conv_direct, 10 conv3x3_valid and 15
   IN-pad per frame and no cuDNN conv, the first frames against the port's
   CPU run) and ``convert-dir`` of clips of 24, 40 and 48 frames at batch 2
   (each clip's frame count; each clip exactly, 0/255 over the whole clip,
   its own convert-video), f32 and bf16, reflect and zero padding (per
   frame 6 conv_direct, 10 conv3x3_flat and 15 fused-IN forwards);
   ``stylize_clip`` of 64 clips of 8 frames, each lane bit for bit the same
   at batch 1, 2, 4 and 64; and the zero-padded
   forward from a reference ``.pth`` through ``process_dir(pad_mode=
   "zeros")`` on the 64 PNGs (per forward 10 conv3x3_flat after 10 zero-pad
   copies and 15 fused-IN forwards, no serving kernel; against the port's
   CPU run; img/s); with ``--video`` also conv_direct's phase and the
   multi-style phase;
10. print one JSON line with each kernel's error, launches and times (and
   each kernel's launches on the video-slice paths), and as the last line
   ``{"ok": true, "device": {...}}``.

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
    ("conv_direct", "float32"): (1e-4, 1e-4),
    ("conv_direct", "bfloat16"): (2 ** -7, 1e-3),
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
    # Not the port of a TPU kernel: the convs that the JAX package leaves to
    # XLA (jax.lax.conv_general_dilated in its layers.conv2d), summed in a
    # fixed order for the video stylizer.
    "conv_direct": ("styletransfer_tpu_torch/csrc/conv_direct.cu",
                    "styletransfer_tpu/ops/layers.py:93"),
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
        conv3x3, conv3x3_flat, conv_direct, fused_instance_norm, instance_norm)

    return {"conv3x3_valid": (conv3x3, "launches"),
            "conv3x3_valid.f32_fma": (conv3x3, "fma_launches"),
            "conv3x3_valid.bf16_mma": (conv3x3, "mma_launches"),
            "conv3x3_valid.bf16_wgmma": (conv3x3, "wgmma_launches"),
            "instance_norm_pad": (instance_norm, "launches"),
            "fused_instance_norm_fwd": (fused_instance_norm, "fwd_launches"),
            "fused_instance_norm_bwd": (fused_instance_norm, "bwd_launches"),
            "conv3x3_flat": (conv3x3_flat, "flat_launches"),
            "conv3x3_im2col": (conv3x3_flat, "im2col_launches"),
            "conv_direct": (conv_direct, "launches")}


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


# The video stylizer's six library convs at 256 px, on conv_direct: (name,
# input [H, W, C] pre-padded, K, stride, O). Timed at the serving batch
# (BATCH) beside F.conv2d, and at batch 1 (convert-video).
DIRECT_CONVS = [("conv1", (SIZE + 8, SIZE + 8, 6), 9, 1, 32),
                ("conv2", (SIZE + 2, SIZE + 2, 32), 3, 2, 64),
                ("conv3", (SIZE // 2 + 2, SIZE // 2 + 2, 64), 3, 2, 128),
                ("up1", (SIZE // 4 + 2, SIZE // 4 + 2, 128), 3, 1, 256),
                ("up2", (SIZE // 2 + 2, SIZE // 2 + 2, 64), 3, 1, 128),
                ("conv_out", (SIZE // 4 + 2, SIZE // 4 + 2, 512), 3, 1, 48)]


def direct_phase(torch, F, cdm, dtype):
    """conv_direct at the six library convs of a 256 px video forward, at
    batch BATCH and 1: against its plain version, a bit-identical repeat,
    lanes 0, 1 and BATCH - 1 bit for bit as each image alone, device times
    of the kernel, the plain version and F.conv2d, and the bound. Returns
    its JSON entry with the six convs' totals at batch BATCH."""
    name = "conv_direct"
    dn = str(dtype).split(".")[1]
    rtol, atol = TOL[(name, dn)]
    g = torch.Generator(device="cuda").manual_seed(13)
    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0,
             "ms1": 0.0, "library_ms1": 0.0}
    worst = 0.0
    for conv, (H, W, C), K, stride, O in DIRECT_CONVS:
        for batch in (BATCH, 1):
            x = torch.randn(batch, H, W, C, device="cuda", generator=g).to(dtype)
            w = (torch.randn(K, K, C, O, device="cuda", generator=g) * (K * K * C) ** -0.5
                 ).to(dtype)
            b = torch.randn(O, device="cuda", generator=g) * 0.1
            out = cdm.conv_direct(x, w, b, stride)
            again = cdm.conv_direct(x, w, b, stride)
            torch.cuda.synchronize()
            Ho, Wo = out.shape[1], out.shape[2]
            plan = cdm.direct_plan(batch, Ho, Wo, O)
            tag = f"{name} {dn} {conv} x[{batch},{H},{W},{C}] w[{K},{K},{C},{O}] /{stride} ({plan})"
            lanes = [j for j in (0, 1, batch - 1) if j < batch]
            alone = all(torch.equal(out[j:j + 1], cdm.conv_direct(x[j:j + 1], w, b, stride))
                        for j in lanes)
            check(torch.equal(out, again) and alone,
                  f"{tag}: the repeat and lanes {lanes} alone are bit-identical")
            xc = x.permute(0, 3, 1, 2)
            wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            ms = device_ms(torch, lambda: cdm.conv_direct(x, w, b, stride), iters=5)
            library_ms = device_ms(torch, lambda: F.conv2d(xc, wc, b.to(dtype), stride=stride),
                                   iters=5)
            flops = 2.0 * batch * Ho * Wo * K * K * C * O
            if batch == 1:
                total["ms1"] += ms
                total["library_ms1"] += library_ms
                print(f"{tag}: kernel_ms {ms:.4f} library_ms {library_ms:.4f}, "
                      f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)
                continue
            pout = cdm.conv_direct_plain(x, w, b, stride)
            err = max_err(out, pout)
            worst = max(worst, err)
            check(allclose(torch, out, pout, rtol, atol),
                  f"{tag}: max_abs_err {err:.3g} (rtol {rtol:.3g}, atol {atol:.3g})")
            # As the host issues it: the plain version's image-by-image
            # library convs may wait for the card.
            plain_ms = time_ms(torch, lambda: cdm.conv_direct_plain(x, w, b, stride), iters=2,
                               warmup=1)
            nbytes = (x.numel() + w.numel() + out.numel()) * x.element_size() + O * 4
            bound_ms, bound_by = bound(flops, nbytes, dn)
            total["ms"] += ms
            total["plain_ms"] += plain_ms
            total["library_ms"] += library_ms
            total["ops_ms"] += flops / PEAK_FLOPS[dn] * 1e3
            total["bytes_ms"] += nbytes / PEAK_BYTES_PER_S * 1e3
            print(f"{tag}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
                  f"{library_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}) achieved "
                  f"{flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.3f} of the bound", flush=True)
    bound_ms = max(total["ops_ms"], total["bytes_ms"])
    print(f"{name} {dn}: the six convs of a forward at batch {BATCH}: kernel_ms "
          f"{total['ms']:.4f} library_ms {total['library_ms']:.4f} bound_ms {bound_ms:.4f}; "
          f"at batch 1: kernel_ms {total['ms1']:.4f} library_ms {total['library_ms1']:.4f}",
          flush=True)
    return {"name": f"{name}.{dn}", "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "max_abs_err": worst, "ms": total["ms"],
            "plain_ms": total["plain_ms"], "bound_ms": bound_ms,
            "bound_by": "operations" if total["ops_ms"] > total["bytes_ms"] else "bytes",
            "library_ms": total["library_ms"], "batch1_ms": total["ms1"],
            "batch1_library_ms": total["library_ms1"],
            "note": "not a TPU kernel: the convs the JAX package leaves to XLA",
            "shape": f"the six library convs of a {SIZE} px video forward at batch {BATCH} "
                     f"(conv1 6->32 9x9, conv2/conv3 stride 2, up1/up2 phase form, conv_out "
                     f"space-to-depth)"}


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


# Multi-style inference (models/multistyle.py): a net of MULTI_STYLES styles
# whose affines are drawn apart from a seed; convert-image-multi by index
# and by blend; a mixed batch of BATCH images timed.
MULTI_STYLES = 4
MULTI_BLEND = "0.5,0.25,0,0.25"


def multistyle_phase(torch, np, instance_norm, in_dir):
    """Multi-style inference: IN-pad with per-image [N, C] affines at the
    fifteen call shapes of a 256 px forward at batch BATCH in f32 and bf16
    (against the plain version; a [C] affine and the same row repeated as
    [N, C] give the same bits); ``fast_st convert-image-multi`` on the card
    by index and by blend, each with 10 conv3x3_valid and 15 IN-pad
    launches, against the port's CPU run within MAIN_TOL; a mixed batch of
    BATCH images: launches, finite output, img/s. Returns the multi-style
    runs' launch counts by precision."""
    from PIL import Image

    from styletransfer_tpu_torch import ckpt, constants
    from styletransfer_tpu_torch.clis import cli
    from styletransfer_tpu_torch.engines import multistyle as engine
    from styletransfer_tpu_torch.models import multistyle
    from styletransfer_tpu_torch.utils import images

    g = torch.Generator(device="cuda").manual_seed(8)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        rtol, atol = TOL[("instance_norm_pad", dn)]
        worst, per_image_ms, shared_ms = 0.0, 0.0, 0.0
        for call, div, C, pad, rp, relu, mode, with_stats, count in _IN_CALLS:
            H = SIZE // div
            x = (torch.randn(BATCH, H, H, C, device="cuda", generator=g) * 2 + 0.5).to(dtype)
            scale = torch.rand(BATCH, C, device="cuda", generator=g) + 0.5
            bias = torch.randn(BATCH, C, device="cuda", generator=g)
            res = None
            if rp is not None:
                res = torch.randn(BATCH, H + 2 * rp, H + 2 * rp, C, device="cuda",
                                  generator=g).to(dtype)
            stats = None
            if with_stats:
                stats = (x.float().sum(dim=(1, 2)), (x.float() ** 2).sum(dim=(1, 2)))
            rest = (res, rp or 0, relu, pad, mode, stats)
            out = instance_norm.instance_norm_pad(x, scale, bias, *rest)
            pout = instance_norm.instance_norm_pad_plain(x, scale, bias, *rest)
            err = max_err(out, pout)
            worst = max(worst, err)
            one = instance_norm.instance_norm_pad(x, scale[3], bias[3], *rest)
            rows = instance_norm.instance_norm_pad(x, scale[3].expand(BATCH, C).contiguous(),
                                                   bias[3].expand(BATCH, C).contiguous(), *rest)
            check(allclose(torch, out, pout, rtol, atol) and torch.equal(one, rows),
                  f"instance_norm_pad {dn} [N, C] affines {call} [{BATCH},{H},{H},{C}]: "
                  f"max_abs_err {err:.3g} (rtol {rtol:.3g}, atol {atol:.3g}); a [C] affine "
                  f"and its row repeated as [N, C] give the same bits")
            per_image_ms += count * device_ms(
                torch, lambda: instance_norm.instance_norm_pad(x, scale, bias, *rest), iters=5)
            shared_ms += count * device_ms(
                torch, lambda: instance_norm.instance_norm_pad(x, scale[3], bias[3], *rest),
                iters=5)
        print(f"instance_norm_pad {dn}: the 15 calls of a forward at batch {BATCH}: device_ms "
              f"{per_image_ms:.4f} with [N, C] affines, {shared_ms:.4f} with [C]", flush=True)

    root = os.path.join(WORK, "multistyle")
    models = os.path.join(root, "data", "models")
    params = multistyle.init_params(seed=5, num_styles=MULTI_STYLES, device="cpu")
    cpu_g = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for p in params.parameters():
            if p.dim() == 2:  # the [S, C] affines: styles drawn apart
                p.add_(torch.randn(p.shape, generator=cpu_g) * 0.3)
    ckpt.save(params, ckpt.checkpoint_path(engine.MODEL_NAME, "smoke", 0, models))
    image = os.path.join(in_dir, "img000.png")
    saved_root = constants.PROJECT_ROOT_PATH
    constants.PROJECT_ROOT_PATH = root
    launches = {}
    try:
        for precision in ("f32", "bf16"):
            route = "f32_fma" if precision == "f32" else "bf16_wgmma"
            for args, tag in ((["--style-index", "2"], "style2"),
                              (["--blend", MULTI_BLEND], "blend")):
                common = ["fast_st", "convert-image-multi", image, "smoke", "--num-styles",
                          str(MULTI_STYLES), "--precision", precision, *args]
                reset_counts()
                cli.main(common + ["-o", f"card_{precision}/", "--device", "cuda"],
                         standalone_mode=False)
                torch.cuda.synchronize()
                counts = read_counts()
                want = {k: 0 for k in counts}
                want.update({"conv3x3_valid": 10, f"conv3x3_valid.{route}": 10,
                             "instance_norm_pad": 15})
                check(counts == want, f"convert-image-multi {precision} {tag}: launched "
                      f"{counts} (want 10 conv3x3 on {route} and 15 IN-pad)")
                launches[(precision, tag)] = counts
                cli.main(common + ["-o", f"cpu_{precision}/", "--device", "cpu"],
                         standalone_mode=False)
                name = f"converted_fast_multi_st_smoke_{tag}.png"
                got = np.asarray(Image.open(os.path.join(root, f"card_{precision}", name)))
                want_png = np.asarray(Image.open(os.path.join(root, f"cpu_{precision}", name)))
                _frames_checked(np, f"convert-image-multi {precision} {tag}: card vs CPU",
                                [got], [want_png], precision)
    finally:
        constants.PROJECT_ROOT_PATH = saved_root
    card = multistyle.params_from_jax(ckpt.load(ckpt.checkpoint_path(
        engine.MODEL_NAME, "smoke", 0, models)), device="cuda")
    imgs = np.stack([np.asarray(Image.open(os.path.join(in_dir, f)))
                     for f in sorted(os.listdir(in_dir))])
    x = images.maybe_normalize_on_device(torch.from_numpy(imgs).cuda())
    idx = torch.arange(BATCH, device="cuda") % MULTI_STYLES
    for precision, cd in (("f32", None), ("bf16", torch.bfloat16)):
        reset_counts()
        y = engine.stylize(card, x, idx, cd)
        counts = read_counts()
        check(counts["conv3x3_valid"] == 10 and counts["instance_norm_pad"] == 15
              and y.shape == x.shape and bool(torch.isfinite(y).all()),
              f"multi-style {precision}: a batch of {BATCH} images of {MULTI_STYLES} mixed "
              f"styles: 10 conv3x3 and 15 IN-pad launches, output {tuple(y.shape)} finite")
        ms = time_ms(torch, lambda: engine.stylize(card, x, idx, cd), iters=10, warmup=2)
        print(f"multi-style {precision}: stylize batch {BATCH}, {MULTI_STYLES} styles mixed: "
              f"{ms:.3f} ms = {BATCH / (ms / 1e3):.1f} img/s", flush=True)
    return launches


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


# The video path (video_st): training on the synthetic corpus (VIDEO_CLIPS
# clips of VIDEO_FRAMES 256 px frames, batch VIDEO_BATCH, chunks of
# VIDEO_CHUNK frames, one epoch), convert-video of a VIDEO_FRAMES-frame GIF,
# convert-dir of clips of DIR_FRAMES frames at batch DIR_BATCH. Per frame
# step: the transform net's stacked forward and backward (15 fused-IN
# forwards and backwards) and the VGG tower of a train step; per stylized
# frame: one serving forward (10 conv3x3_valid, 15 IN-pad).
VIDEO_CLIPS = 4
VIDEO_FRAMES = 48
VIDEO_BATCH = 4
VIDEO_CHUNK = 16
VIDEO_PER_STEP = {"fused_instance_norm_fwd": NORMS_PER_FORWARD,
                  "fused_instance_norm_bwd": NORMS_PER_FORWARD, **VGG_PER_STEP}
DIR_FRAMES = (24, 40, 48)
DIR_BATCH = 2
# Served video frames compared with the port's CPU run: the first frames of
# the clip (the carry runs through them).
VIDEO_CPU_FRAMES = 4
# One f32 scan step on the card against the port's CPU run: 2 clips at 64
# px, 3 frames, the third padded. The metrics (relative) and each parameter
# after the step (relative L2). A bias ahead of an instance norm (every
# conv's but conv_out's, every norm's but up2_in's) is a per-channel shift
# that the next norm cancels: its gradient is rounding noise, which Adam
# turns into steps of about lr of either sign, so those biases are held to
# 2 lr per step instead.
VIDEO_PARITY_SIZE = 64
VIDEO_PARITY_METRIC_RTOL = 1e-5
VIDEO_PARITY_PARAM_REL_L2 = 1e-3
# The zero-padded forward (a reference .pth): per forward 10 conv3x3_flat
# (the residual convs, each after a zero-pad copy) and 15 fused-IN forwards.
ZEROS_PER_FORWARD = {"conv3x3_flat": 10, "fused_instance_norm_fwd": NORMS_PER_FORWARD}
# stylize_clip of LANE_FRAMES frames of max(LANE_BATCHES) clips, and of its
# first lanes at each smaller batch; the lanes of LANE_SINGLES also alone.
LANE_BATCHES = (1, 2, 4, 64)
LANE_FRAMES = 8
LANE_SINGLES = (1, 3, 63)


class _VideoLossLog(logging.Handler):
    """Collects the losses video_train logs."""

    def __init__(self):
        super().__init__()
        self.train = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("Epoch:") and "Batch Loss:" in msg:
            self.train.append(float(msg.rsplit(":", 1)[1]))


def _frames_checked(np, label, got, want, precision):
    """uint8 frames against the port's CPU run, in MAIN_TOL's 1/255 steps."""
    diff = np.abs(np.stack(got).astype(np.int32) - np.stack(want).astype(np.int32))
    max_steps, mean_steps = MAIN_TOL[precision]
    check(int(diff.max()) <= max_steps and float(diff.mean()) <= mean_steps,
          f"{label}: max {int(diff.max())}/255, mean {float(diff.mean()):.4f}/255 over "
          f"{len(got)} frames (limits {max_steps}, {mean_steps})")


def _write_clip(np, path, frames, seed):
    """A GIF of a synthetic image moving 2 px per frame (Pillow)."""
    from PIL import Image

    from styletransfer_tpu_torch.data import coco

    base = np.round(coco.synthetic_image(seed, SIZE) * 255).astype(np.uint8)
    imgs = [Image.fromarray(np.roll(base, 2 * i, axis=1)) for i in range(frames)]
    imgs[0].save(path, save_all=True, append_images=imgs[1:], duration=42, loop=0)


def video_train_path(torch, np):
    """video_st training through engines.video.video_train, f32 and bf16:
    launches per frame step, finite losses, the step state and the epoch
    checkpoint, wall and steady ms per frame step. Returns each precision's
    launch counts and the f32 run's models directory."""
    from styletransfer_tpu_torch import ckpt
    from styletransfer_tpu_torch.data import video as video_data
    from styletransfer_tpu_torch.engines import video
    from styletransfer_tpu_torch.models import transformer, vgg
    from styletransfer_tpu_torch.utils.logging import get_logger

    style = _style_image(np)
    vgg_params = vgg.init_params(seed=0, device="cuda")
    launches, steps = {}, VIDEO_FRAMES * (VIDEO_CLIPS // VIDEO_BATCH)
    previews = len({i // VIDEO_CHUNK for i in range(VIDEO_FRAMES) if i % 50 == 0})
    for precision in ("f32", "bf16"):
        models = os.path.join(WORK, f"models_video_{precision}")
        loader = video_data.VideoDataset(video_dir=os.path.join(WORK, "no_videos"),
                                         batch_size=VIDEO_BATCH, synthetic_count=VIDEO_CLIPS)
        params = transformer.init_video_params(seed=0, device="cuda")
        log = _VideoLossLog()
        get_logger().addHandler(log)
        reset_counts()
        t0 = time.perf_counter()
        try:
            video.video_train(style, style_name="smoke", epochs=1, batch_size=VIDEO_BATCH,
                              vgg_params=vgg_params, params=params, video_loader=loader,
                              chunk_size=VIDEO_CHUNK, max_frames=VIDEO_FRAMES,
                              runs_dir=os.path.join(WORK, "runs_video"), models_path=models,
                              precision=precision,
                              step_checkpoint_every=VIDEO_CHUNK, device="cuda")
            torch.cuda.synchronize()
        finally:
            get_logger().removeHandler(log)
        wall = time.perf_counter() - t0
        counts = read_counts()
        launches[precision] = counts
        want = {k: 0 for k in counts}
        for k, n in VIDEO_PER_STEP.items():
            want[k] = n * steps
        want["fused_instance_norm_fwd"] += NORMS_PER_FORWARD * previews
        for k, n in VGG_STYLE_TARGETS.items():
            want[k] += n
        check(counts == want,
              f"video train {precision}: {steps} frame steps and {previews} preview launched "
              f"{counts} (want {VIDEO_PER_STEP} per frame step, 15 fused-IN forwards per "
              f"preview, {VGG_STYLE_TARGETS} for the style targets)")
        check(len(log.train) == len(range(0, steps, 20))
              and all(math.isfinite(v) for v in log.train),
              f"video train {precision}: logged losses {['%.4f' % v for v in log.train]} "
              f"all finite")
        state = ckpt.load_step_state("video_st", "smoke", models,
                                     extra_keys=("batch_in_epoch", "chunk_in_batch"))
        check(state is not None and (state["epoch"], state["iteration"]) == (1, steps)
              and int(state["opt_state"]["0"]["count"]) == steps,
              f"video train {precision}: step state at epoch 1, iteration {steps}, Adam count "
              f"{steps}")
        trained, epoch = ckpt.load_latest_transformer("video_st", "smoke", models, device="cuda")
        check(epoch == 0 and all(torch.equal(a, b) for a, b in
                                 zip(trained.parameters(), params.parameters())),
              f"video train {precision}: the epoch checkpoint holds the trained parameters")
        # Steady state: one more chunk of frame steps on the card.
        cd = torch.bfloat16 if precision == "bf16" else None
        opt, scan_step = video.make_scan_train_step(
            vgg_params, vgg.style_gram_targets(vgg_params, torch.from_numpy(style).cuda()),
            compute_dtype=cd)
        optimizer = opt(params)
        readers = [video_data.SyntheticFrameReader(s) for s in range(VIDEO_BATCH)]
        frames = torch.from_numpy(np.stack([np.concatenate([r.next_frame() for r in readers])
                                            for _ in range(VIDEO_CHUNK)])).cuda()
        valid = np.ones(VIDEO_CHUNK, bool)
        mask = video.freeze_mask(params, False)
        scan_step(params, optimizer, frames[:2], valid[:2], frames[0], frames[0], mask)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        *_, metrics = scan_step(params, optimizer, frames, valid, frames[0], frames[0], mask)
        float(metrics["total"][-1])
        torch.cuda.synchronize()
        steady = (time.perf_counter() - t1) * 1e3 / VIDEO_CHUNK
        print(f"video train {precision}: video_train {steps} frame steps at batch {VIDEO_BATCH}, "
              f"{SIZE} px in {wall:.3f} s = {wall * 1e3 / steps:.2f} ms per frame step (incl. "
              f"VGG targets, frame synthesis, previews, checkpoints); steady chunk of "
              f"{VIDEO_CHUNK}: {steady:.2f} ms per frame step = "
              f"{VIDEO_BATCH * 1e3 / steady:.1f} frames/s", flush=True)
    return launches, os.path.join(WORK, "models_video_f32")


def video_parity(torch, np):
    """One f32 scan step of 3 frames (the third padded) on 2 clips at 64 px:
    the card against the port's CPU run."""
    from styletransfer_tpu_torch.data import coco
    from styletransfer_tpu_torch.engines import video
    from styletransfer_tpu_torch.models import transformer, vgg
    from styletransfer_tpu_torch.utils import images

    def img(i):
        return images.normalize(coco.synthetic_image(i, VIDEO_PARITY_SIZE)).astype(np.float32)

    style = torch.from_numpy(img(40_000)[None])
    frames = torch.from_numpy(np.stack([np.stack([np.roll(img(40_001 + c), 2 * t, axis=1)
                                                  for c in range(2)]) for t in range(3)]))
    valid = np.array([True, True, False])
    cpu_params = transformer.init_video_params(seed=1, device="cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        params = transformer.params_from_jax(transformer.params_to_tree(cpu_params), device=dev)
        vgg_params = vgg.init_params(seed=0, device=dev)
        opt, step = video.make_scan_train_step(vgg_params,
                                               vgg.style_gram_targets(vgg_params, style.to(dev)))
        x = frames.to(dev)
        *_, metrics = step(params, opt(params), x, valid, x[0], x[0],
                           video.freeze_mask(params, False))
        runs[dev] = ({k: v.cpu().numpy() for k, v in metrics.items()},
                     {n: p.detach().cpu().numpy() for n, p in params.named_parameters()})
    (mg, pg), (mc, pc) = runs["cuda"], runs["cpu"]
    worst = max(float(np.max(np.abs(mg[k][:2] - mc[k][:2]) / np.abs(mc[k][:2]))) for k in mc)
    check(worst <= VIDEO_PARITY_METRIC_RTOL and all(float(v[2]) == 0.0 for v in mg.values()),
          f"video parity f32: metrics card {({k: v.tolist() for k, v in mg.items()})} vs CPU "
          f"{({k: v.tolist() for k, v in mc.items()})}: worst relative difference {worst:.3g} "
          f"(limit {VIDEO_PARITY_METRIC_RTOL}); the padded frame's are 0")
    lr = 1e-3
    worst, worst_name, noise = 0.0, "", 0.0
    for name, ref in pc.items():
        if name.endswith(".bias") and name not in ("conv_out.bias", "up2_in.bias"):
            noise = max(noise, float(np.abs(pg[name] - ref).max()))
            continue
        rel = float(np.linalg.norm(pg[name] - ref) / np.linalg.norm(ref))
        if rel > worst:
            worst, worst_name = rel, name
    check(worst <= VIDEO_PARITY_PARAM_REL_L2 and noise <= 2 * lr * 2,
          f"video parity f32: every parameter after the step within relative L2 "
          f"{VIDEO_PARITY_PARAM_REL_L2} of the CPU run (worst {worst:.3g}, {worst_name}); "
          f"the biases that a norm cancels within {2 * lr * 2} (worst {noise:.3g})")


def _recording(video):
    """Wraps video._open_video_writer so that each output's frames are kept
    (by path) as they are written. Returns (frames by path, restore)."""
    seen = {}
    real = video._open_video_writer

    class Recorder:
        def __init__(self, writer, frames):
            self.writer, self.frames = writer, frames

        def append_data(self, frame):
            self.frames.append(frame.copy())
            self.writer.append_data(frame)

        def close(self):
            self.writer.close()

    def opener(base, fps, logger):
        writer, path = real(base, fps, logger)
        return Recorder(writer, seen.setdefault(path, [])), path

    video._open_video_writer = opener
    return seen, lambda: setattr(video, "_open_video_writer", real)


def video_serve_path(torch, np, F, models):
    """convert-video of a VIDEO_FRAMES-frame clip and convert-dir of clips of
    DIR_FRAMES frames at batch DIR_BATCH, from the video checkpoint, f32 and
    bf16, with reflect and with zero padding: frame counts, launches per
    frame (no cuDNN conv: the six library convs run on conv_direct), the
    first frames against the port's CPU run, every clip of the directory
    exactly (0/255, the whole clip) its own convert-video, frames/s.
    Returns the launch counts by (pad mode, precision, command)."""
    from PIL import Image

    from styletransfer_tpu_torch import ckpt
    from styletransfer_tpu_torch.data import video as video_data
    from styletransfer_tpu_torch.engines import video
    from styletransfer_tpu_torch.utils import images

    root = os.path.join(WORK, "video_serve")
    clips = os.path.join(root, "clips")
    os.makedirs(clips)
    clip = os.path.join(root, "clip.gif")
    _write_clip(np, clip, VIDEO_FRAMES, 50_000)
    for i, n in enumerate(DIR_FRAMES):
        _write_clip(np, os.path.join(clips, f"c{i}.gif"), n, 50_001 + i)
    names = sorted(os.listdir(clips))
    reader = video_data.ImageioFrameReader(clip, normalized=False)
    first = np.stack([reader.next_frame()[0] for _ in range(VIDEO_CPU_FRAMES)])
    reader.close()
    cpu_params, _ = ckpt.load_latest_transformer("video_st", "smoke", models, device="cpu")
    params, _ = ckpt.load_latest_transformer("video_st", "smoke", models, device="cuda")
    seen, restore = _recording(video)
    library_conv, conv_calls = F.conv2d, [0]

    def counting_conv2d(*args, **kwargs):
        conv_calls[0] += 1
        return library_conv(*args, **kwargs)

    def per_frame(precision, pad_mode):
        if pad_mode == "zeros":
            return {"conv_direct": 6, **ZEROS_PER_FORWARD}
        route = "f32_fma" if precision == "f32" else "bf16_wgmma"
        return {"conv_direct": 6, "conv3x3_valid": 10, f"conv3x3_valid.{route}": 10,
                "instance_norm_pad": 15}

    def run(label, fn, frames, precision, pad_mode):
        reset_counts()
        conv_calls[0] = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        want = {k: 0 for k in counts}
        want.update({k: n * frames for k, n in per_frame(precision, pad_mode).items()})
        check(counts == want and conv_calls[0] == 0,
              f"{label}: {frames} forwards launched {counts} and {conv_calls[0]} cuDNN convs "
              f"(want {per_frame(precision, pad_mode)} per forward, no cuDNN conv)")
        return out, counts, wall

    launches = {}
    F.conv2d = counting_conv2d
    try:
        for pad_mode in ("reflect", "zeros"):
            for precision in ("f32", "bf16"):
                tag = f"{precision} {pad_mode}"
                out, counts, wall = run(
                    f"convert-video {tag}",
                    lambda: video.process_video(
                        clip, "smoke", out_dir=os.path.join(root, f"v_{precision}_{pad_mode}"),
                        models_path=models, precision=precision, pad_mode=pad_mode,
                        device="cuda"),
                    VIDEO_FRAMES, precision, pad_mode)
                launches[(pad_mode, precision, "convert_video")] = counts
                with Image.open(out) as im:
                    n_file = im.n_frames
                check(len(seen[out]) == VIDEO_FRAMES and n_file == VIDEO_FRAMES,
                      f"convert-video {tag}: {len(seen[out])} frames written, {n_file} in "
                      f"{os.path.basename(out)}")
                ref = images.to_uint8_on_device(torch.from_numpy(video.stylize_clip(
                    cpu_params, first, precision=precision, pad_mode=pad_mode))).numpy()
                _frames_checked(np, f"convert-video {tag}: card vs CPU on the first "
                                f"{VIDEO_CPU_FRAMES} frames", seen[out][:VIDEO_CPU_FRAMES],
                                list(ref), precision)
                single = {}
                for name in names:
                    path = video.process_video(
                        os.path.join(clips, name), "smoke",
                        out_dir=os.path.join(root, f"one_{precision}_{pad_mode}_{name}"),
                        models_path=models, precision=precision, pad_mode=pad_mode,
                        device="cuda")
                    single[name] = seen[path]
                forwards = sum(max(DIR_FRAMES[g:g + DIR_BATCH])
                               for g in range(0, len(DIR_FRAMES), DIR_BATCH))
                outs, counts, dir_wall = run(
                    f"convert-dir {tag}",
                    lambda: video.process_video_dir(
                        clips, "smoke", out_dir=os.path.join(root, f"d_{precision}_{pad_mode}"),
                        batch_size=DIR_BATCH, models_path=models, precision=precision,
                        pad_mode=pad_mode, device="cuda"),
                    forwards, precision, pad_mode)
                launches[(pad_mode, precision, "convert_dir")] = counts
                check([len(seen[p]) for p in outs] == list(DIR_FRAMES),
                      f"convert-dir {tag}: {[len(seen[p]) for p in outs]} frames written "
                      f"(want {list(DIR_FRAMES)})")
                for path, name in zip(outs, names):
                    # Each lane is the clip stylized alone, bit for bit: every op
                    # of the stylizer sums in an order its plan fixes without
                    # the batch (scripts/torch_video_lanes.py).
                    diff = np.abs(np.stack(seen[path]).astype(np.int32)
                                  - np.stack(single[name]).astype(np.int32))
                    check(int(diff.max()) == 0,
                          f"convert-dir {tag} {name}: all {len(diff)} frames against its own "
                          f"convert-video: max {int(diff.max())}/255 (want 0); max per frame "
                          f"{[int(d.max()) for d in diff]}")
                # Steady state: the stylizer alone on a decoded chunk of frames.
                reader = video_data.ImageioFrameReader(clip, normalized=False)
                chunk = torch.from_numpy(np.stack([reader.next_frame() for _ in range(24)]))
                reader.close()
                chunk = chunk.cuda()
                cd = torch.bfloat16 if precision == "bf16" else None
                carry = chunk[0].float()
                video._stylize_chunk(params, chunk[:2], carry, cd, pad_mode)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                video._stylize_chunk(params, chunk, carry, cd, pad_mode)[-1].sum().item()
                steady = (time.perf_counter() - t2) * 1e3 / len(chunk)
                print(f"video serve {tag}: convert-video {VIDEO_FRAMES} frames in {wall:.3f} s "
                      f"= {VIDEO_FRAMES / wall:.1f} frames/s (incl. checkpoint load, GIF decode "
                      f"and encode); convert-dir {sum(DIR_FRAMES)} frames of {len(DIR_FRAMES)} "
                      f"clips at batch {DIR_BATCH} in {dir_wall:.3f} s = "
                      f"{sum(DIR_FRAMES) / dir_wall:.1f} frames/s; the stylizer alone, batch 1: "
                      f"{steady:.3f} ms per frame = {1e3 / steady:.1f} frames/s", flush=True)
    finally:
        F.conv2d = library_conv
        restore()
    lane_batches(torch, np, params)
    return launches


def lane_batches(torch, np, params):
    """stylize_clip of LANE_CLIPS clips of LANE_FRAMES frames in one batch,
    and of its first lanes at the smaller batches of LANE_BATCHES: each lane
    is bit for bit the same at every batch (f32 and bf16, reflect and
    zeros)."""
    from styletransfer_tpu_torch.data import coco
    from styletransfer_tpu_torch.engines import video

    frames = np.stack([np.stack([np.roll(np.round(coco.synthetic_image(60_000 + c, SIZE) * 255)
                                         .astype(np.uint8), 2 * t, axis=1)
                                 for c in range(max(LANE_BATCHES))])
                       for t in range(LANE_FRAMES)])  # [T, B, H, W, 3]
    for pad_mode in ("reflect", "zeros"):
        for precision in ("f32", "bf16"):
            runs = {b: video.stylize_clip(params, frames[:, :b], precision, pad_mode)
                    for b in LANE_BATCHES}
            alone = {j: video.stylize_clip(params, frames[:, j], precision, pad_mode)
                     for j in LANE_SINGLES}
            same = all(np.array_equal(runs[b][:, j], runs[max(LANE_BATCHES)][:, j])
                       for b in LANE_BATCHES for j in range(b))
            same &= all(np.array_equal(alone[j], runs[max(LANE_BATCHES)][:, j])
                        for j in LANE_SINGLES)
            check(same and all(np.isfinite(r).all() for r in runs.values()),
                  f"stylize_clip {precision} {pad_mode}: {LANE_FRAMES} frames of lanes "
                  f"{list(LANE_SINGLES)} alone and every lane at batch {list(LANE_BATCHES)} "
                  f"are bit-identical")


def zeros_path(torch, np, in_dir, imgs):
    """Zero padding from a reference .pth: process_dir(pad_mode="zeros") of
    the 64 serving PNGs, f32 and bf16, with per forward 10 conv3x3_flat
    (each after a zero-pad copy) and 15 fused-IN forwards and no serving
    kernel; the first two outputs against the port's CPU run; img/s of the
    forward. Returns each precision's launch counts and img/s."""
    from PIL import Image

    from styletransfer_tpu_torch import ckpt
    from styletransfer_tpu_torch.engines import fast
    from styletransfer_tpu_torch.models import transformer
    from styletransfer_tpu_torch.ops.cuda import conv3x3_flat

    models = os.path.join(WORK, "models_pth")
    os.makedirs(models)
    torch.save(transformer.export_torch_state_dict(transformer.init_params(seed=4, device="cpu")),
               os.path.join(models, "fast_st_ref_epoch0.pth"))
    cpu_params, _ = ckpt.load_latest_transformer("fast_st", "ref", models, device="cpu")
    params, _ = ckpt.load_latest_transformer("fast_st", "ref", models, device="cuda")
    pads = [0]
    zero_pad = conv3x3_flat._zero_pad

    def counting_pad(t):
        pads[0] += 1
        return zero_pad(t)

    launches, rates = {}, {}
    conv3x3_flat._zero_pad = counting_pad
    try:
        for precision in ("f32", "bf16"):
            reset_counts()
            pads[0] = 0
            t0 = time.perf_counter()
            paths = fast.process_dir(in_dir, "ref", out_dir=os.path.join(WORK, f"zeros_{precision}"),
                                     batch_size=BATCH, models_path=models, precision=precision,
                                     pad_mode="zeros", device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
            launches[precision] = counts
            want = {k: 0 for k in counts}
            want.update(ZEROS_PER_FORWARD)
            check(counts == want and pads[0] == 10,
                  f"zeros path {precision}: one forward launched {counts} and {pads[0]} zero-pad "
                  f"copies (want {ZEROS_PER_FORWARD} and 10 copies; no conv3x3_valid, no IN-pad)")
            outs = np.stack([np.asarray(Image.open(p)) for p in sorted(paths)])
            check(outs.shape == (BATCH, SIZE, SIZE, 3),
                  f"zeros path {precision}: {len(paths)} PNGs {outs.shape}")
            ref = fast.make_serve_fn(precision, "zeros")(cpu_params, torch.from_numpy(imgs[:2]))
            _frames_checked(np, f"zeros path {precision}: card vs CPU on 2 images", list(outs[:2]),
                            list(ref.numpy()), precision)
            serve = fast.make_serve_fn(precision, "zeros")
            batch = torch.from_numpy(imgs).cuda()
            ms = time_ms(torch, lambda: serve(params, batch), iters=10, warmup=2)
            rates[precision] = BATCH / (ms / 1e3)
            print(f"zeros path {precision}: process_dir {BATCH} images from a .pth in "
                  f"{wall:.3f} s; serve_fn batch {BATCH}: {ms:.3f} ms = "
                  f"{rates[precision]:.1f} img/s", flush=True)
    finally:
        conv3x3_flat._zero_pad = zero_pad
    return launches, rates


def residual_flat_phase(torch, F, cf, dtype):
    """conv3x3_flat at the zero-padded forward's residual shape, x [64, 66,
    66, 128] -> 128: against the plain version, a bit-identical repeat, its
    plan, and device times of the kernel and F.conv2d (padding 1 on the
    interior), and the plain version's as the host issues it. Returns its
    JSON entry."""
    dn = str(dtype).split(".")[1]
    H, C = SIZE // 4, 128
    g = torch.Generator(device="cuda").manual_seed(12)
    interior = torch.randn(BATCH, H, H, C, device="cuda", generator=g).to(dtype)
    x = F.pad(interior, (0, 0, 1, 1, 1, 1)).contiguous()
    w = (torch.randn(3, 3, C, C, device="cuda", generator=g) * (9 * C) ** -0.5).to(dtype)
    b = torch.randn(C, device="cuda", generator=g) * 0.1
    rtol, atol = TOL[("conv3x3_flat", dn)]
    out = cf.conv3x3_flat(x, w, b)
    again = cf.conv3x3_flat(x, w, b)
    torch.cuda.synchronize()
    pout = cf.conv3x3_flat_plain(x, w, b)
    err = max_err(out, pout)
    plan = cf.flat_plan(BATCH, H, H, C, C, dtype)
    tag = f"conv3x3_flat {dn} zeros residual [{BATCH},{H + 2},{H + 2},{C}] -> {C} ({plan})"
    check(allclose(torch, out, pout, rtol, atol) and torch.equal(out, again),
          f"{tag}: max_abs_err {err:.3g} (rtol {rtol:.3g}, atol {atol:.3g}); the repeat is "
          f"bit-identical")
    ms = device_ms(torch, lambda: cf.conv3x3_flat(x, w, b), iters=10)
    # As the host issues it: the plain version's image-by-image library
    # convs may wait for the card.
    plain_ms = time_ms(torch, lambda: cf.conv3x3_flat_plain(x, w, b), iters=5)
    xc = interior.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    library_ms = device_ms(torch, lambda: F.conv2d(xc, wc, b.to(dtype), padding=1), iters=10)
    flops = 2.0 * BATCH * H * H * 9 * C * C
    nbytes = (x.numel() + w.numel() + BATCH * H * H * C) * x.element_size() + C * 4
    bound_ms, bound_by = bound(flops, nbytes, dn)
    print(f"{tag}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} "
          f"bound_ms {bound_ms:.4f} ({bound_by}) achieved {flops / ms / 1e9:.1f} TFLOP/s, "
          f"{bound_ms / ms:.3f} of the bound", flush=True)
    return {"name": f"conv3x3_flat_residual.{dn}", "route": "cuda",
            "source": SOURCES["conv3x3_flat"][0], "replaces": SOURCES["conv3x3_flat"][1],
            "plan": str(plan), "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "shape": f"x[{BATCH},{H + 2},{H + 2},{C}] w[3,3,{C},{C}] (zero-padded forward's "
                     f"residual convs, {SIZE} px)"}


def video_phase(torch, np, F, cf, in_dir, imgs):
    """The video and zero-padding slice: conv3x3_flat at the residual shape,
    video training, the scan-step parity, convert-video and convert-dir,
    the zero-padded forward from a .pth. Returns (entries, launches by
    precision and path, zeros img/s)."""
    entries = [residual_flat_phase(torch, F, cf, dtype)
               for dtype in (torch.float32, torch.bfloat16)]
    train, models = video_train_path(torch, np)
    video_parity(torch, np)
    serve = video_serve_path(torch, np, F, models)
    zeros, rates = zeros_path(torch, np, in_dir, imgs)
    launches = {p: {"video_train": train[p], "zeros": zeros[p],
                    **{f"{cmd}{'' if pad == 'reflect' else '_zeros'}": serve[(pad, p, cmd)]
                       for pad in ("reflect", "zeros")
                       for cmd in ("convert_video", "convert_dir")}}
                for p in ("f32", "bf16")}
    return entries, launches, rates


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
            _build, conv3x3, conv3x3_flat, conv_direct, fused_instance_norm, instance_norm)
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
        if sys.argv[1:] == ["--video"]:
            for dtype in (torch.float32, torch.bfloat16):
                direct_phase(torch, F, conv_direct, dtype)
            in_dir, imgs = write_inputs(np)
            video_phase(torch, np, F, conv3x3_flat, in_dir, imgs)
            multistyle_phase(torch, np, instance_norm, in_dir)
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
            entries.append(direct_phase(torch, F, conv_direct, dtype))
        check_routes(instance_norm, entries)
        in_dir, imgs = write_inputs(np)
        serve_launches, rates = main_path(torch, np, in_dir, imgs)
        multi_launches = multistyle_phase(torch, np, instance_norm, in_dir)
        train_launches = train_path(torch, np, in_dir)
        parity_phase(torch, np)
        step_rate = step_rates(torch, np)
        gatys_launches = gatys_path(torch, np, F)
        gatys_parity(torch, np)
        video_entries, video_launches, zeros_rates = video_phase(torch, np, F, conv3x3_flat,
                                                                 in_dir, imgs)
        entries += video_entries
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
        # The launches of each video-slice path in this precision.
        counter = {"conv3x3_flat_residual": "conv3x3_flat"}.get(kernel, kernel)
        e["video_launches"] = {path: counts[counter] for path, counts in
                               video_launches[precision].items()}
        if kernel == "conv3x3_flat_residual":  # the zero-padded forward from a .pth
            e["launches"] = video_launches[precision]["zeros"]["conv3x3_flat"]
            continue
        if kernel == "conv_direct":  # the video stylizer: convert-video, reflect
            e["launches"] = video_launches[precision]["convert_video"]["conv_direct"]
            continue
        if kernel == "instance_norm_pad":  # also with [N, C] affines (multi-style)
            e["multistyle_launches"] = {f"{tag}": counts["instance_norm_pad"] for
                                        (p, tag), counts in multi_launches.items()
                                        if p == precision}
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
    print(f"zeros path img/s at batch {BATCH}, 256 px: f32 {zeros_rates['f32']:.1f}, "
          f"bf16 {zeros_rates['bf16']:.1f} on {card}")
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
