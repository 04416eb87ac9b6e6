#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --convs       # phases 1-2, conv3x3_valid, upconv_phase, conv9x9
    python3 chip_smoke.py --stat-free   # phases 1-2 and the stat-free convs only
    python3 chip_smoke.py --norms       # phases 1-2 and the instance norms only
    python3 chip_smoke.py --video       # phases 1-2, conv_direct, video / zeros, multi-style
    python3 chip_smoke.py --multi       # phases 1-2, [N, C] fused IN, train-multi, daemons
    python3 chip_smoke.py --serve       # phases 1-2, the network transports, video / Gatys daemons
    python3 chip_smoke.py --parallel    # phases 1-2, multi-GPU training and serving placement
    python3 chip_smoke.py --packed      # phases 1-2, --packed training
    python3 chip_smoke.py --zoom        # phases 1-2, gatys_st --optimizer lbfgs-zoom, doctor
    python3 chip_smoke.py --aot         # phases 1-2, CUDA graphs, start-up, precision, CRC32C
    python3 chip_smoke.py --ckpt        # phases 1-2, .orbax epochs, the zstd decoder, downloads
    python3 chip_smoke.py --adain       # phases 1-2, upconv_phase, AdaIN's kernels and forward

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
   beside F.conv2d; and upconv_phase (not a TPU kernel either: the f32
   serving forward's two phase-form upsample convs) at both of its serving
   calls (batch 64, 256 px) and at ragged photo-sized grids (batch 1),
   against its plain version (the largest gap over the largest output), with
   a bit-identical repeat, one launch a call on its own counter, and device
   times beside the plain version and cuDNN's conv alone (the phase conv and
   the published conv, each on the heuristic pick and the cudnn.benchmark
   best); and conv9x9 (not a TPU kernel either: conv_out, the 9x9 32 -> 3
   conv, and its input gradient 3 -> 32) at the serving forward's call
   (batch 64), a train step's two calls (batch 4) and a ragged photo (batch
   1), against its plain version, with a bit-identical repeat, image 0 bit
   for bit image 0 alone, its plan, and device times beside cuDNN's 9x9
   conv, the former serving phase form and cuDNN's input gradient;
4. drive the serving path, fast_st inference: a seeded checkpoint written
   with ``ckpt.save``, 64 seeded 256x256 PNGs, ``engines.fast.process_dir``
   from the checkpoint load to the saved PNGs, in f32 and bf16. The launch
   counters must show 10 conv3x3 and 15 IN-pad launches per forward, the
   conv3x3 ones all on the f32_fma or bf16_wgmma route, 2 upconv_phase
   launches per f32 forward (none in bf16, which every serving path below
   holds too, and none on the video, zero-padded, training and Gatys
   paths) and 1 conv9x9 per f32 forward (also on the zero-padded path and
   in f32 previews and evals; none in bf16 and on the video stylizer),
   and the first two
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
   and a mixed batch of 64 (launches, finite output, img/s); then AdaIN's
   other kernels at its forward's shapes (``ADAIN_CALLS``: conv3x3_valid at
   each of its ten shapes with the ReLU, conv3x3_im2col at conv1_1 of 32
   images, conv3x3_flat's 64 -> 3 and the IN-pad with [N, C] affines, each
   against its plain version with a bit-identical repeat, its launches and
   its device times beside cuDNN's and the bound), and its
   serving forward (``engines.adain.make_serve_fn``, seeded weights, 16
   pairs of 512 px content and style, each pair its own style, also alone
   with ``--adain``): per forward 13 conv3x3_valid launches (all f32_fma),
   1 conv3x3_im2col, 1 conv3x3_flat, 1 IN-pad and 3 upconv_phase, the
   output within one level of the plain reference
   (``h100bench/reference/adain.py``, f32, TF32 off), a bit-identical
   repeat, and its device ms and img/s;
5. drive the training path, fast_st training: ``engines.fast.static_train``
   for a few steps at batch 4 on the synthetic corpus, seeded VGG and
   transform-net parameters, in f32 and bf16. Every step replays the
   step's CUDA graph (one capture, a replay a step: the training graph
   counters of ``utils/aot.py`` are printed), so the kernels launch in the
   capture's passes alone (``aot.WARMUP`` warm-ups and the captured pass).
   The counters must show 15 fused-IN forward and 15 backward launches per
   forward-backward pass (and 15 forward launches per eval or preview
   forward), 2 conv9x9 per f32 pass (conv_out's forward and input gradient)
   and the VGG tower's conv kernels (per pass 2 conv3x3_im2col and 12
   conv3x3_flat: the output's forward and input gradient, the content
   target's forward), every logged loss must be finite, and the epoch
   checkpoint must load and serve through ``process_dir``; then one step
   while ``record_spans()`` records: eager, no graph counter moves, and it
   launches a pass's kernels;
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
10. the multi-style training and serving slice (also alone with
   ``--multi``, after the fused IN with [N, C] affines): in phase 3 the
   fused-IN forward and backward with per-image [N, C] affines at the 15
   call shapes of a batch-4 train step (against the plain versions; with
   every row equal, dx bit for bit the [C] call's; device ms beside the
   [C] calls and the bound); ``engines.multistyle.train`` at batch 4 with 4
   seeded styles for a few steps in f32 and bf16 (every step on one CUDA
   graph; per pass 15 fused-IN forwards and 15 backwards, all with [N, C]
   affines, and the VGG kernels; the preview on the serving kernels; finite losses; the step
   state; [4, C] affines in the epoch checkpoint, which ``convert-image-
   multi`` serves by index and blend, card against CPU); one f32
   multi-style step card against CPU (undrawn styles' rows unchanged); the
   multi-style step beside the single-style step in turns; ``fast_st
   serve`` in process at batch 8 on 64 requests of 256 px and four of 512
   px, STATS (device_rtt_ms), a malformed line, RELOAD to a newer epoch,
   f32 and bf16, and ``serve-multi`` from the trained checkpoint with
   indices and blends mixed (launches, PNGs against the port's CPU
   forward, requests/s);
11. the network transports and the other two daemons (also alone with
   ``--serve``): ``fast_st serve`` at batch 8 on 64 requests of 256 px, f32
   and bf16, on scripted stdin, over ``--tcp`` (two socket clients
   pipelining 32 requests each; a goodbye, then SHUTDOWN) and over
   ``--http`` (four client threads POSTing PNG bodies after /healthz
   opens; /metrics with the device RTT gauge; POST /shutdown): every answer
   OK, the first two against the port's CPU forward, 10 conv3x3 and 15
   IN-pad launches per forward, requests/s side by side; ``video_st serve``
   (f32 and bf16, reflect and zeros, at batch 4 and 1): four streams of 12
   frames interleaved, one reset after 6, every stream's PNGs exactly
   (0/255) ``stylize_clip`` of its frames on the card, 6 conv_direct and the
   forward's kernels per forward, no cuDNN conv, frames/s; ``gatys_st
   --serve`` (256 px, 5 L-BFGS steps, H 16, f32 and bf16): four requests
   mixing two styles and a blend at batch 4 and at batch 1, finite losses,
   each lane's first closure within GATYS_LANE_FIRST_RTOL of the request
   alone (the final losses' spread printed),
   1 conv3x3_im2col and 9 conv3x3_flat per closure, no cuDNN conv, seconds
   per request;
12. the multi-GPU slice (also alone with ``--parallel``), on one card:
   NCCL at world size 1 (``parallel.distributed.initialize``;
   static_train for a few steps at batch 4, f32 and bf16, in a group of one
   against the same steps without a group, losses within 1e-5 with cuDNN's
   deterministic algorithms; steady steps with and without the all-reduce;
   train_loop's ms per step in a group of one and without, in turns; no
   training graph in the group, every step on one without it); two gloo
   ranks sharing cuda:0 (this script again with ``--rank-worker``), each
   holding 2 images of a global batch of 4 at 256 px with the published
   widths, f32 and bf16: per rank and step 15 fused-IN forwards and
   backwards, 2 conv3x3_im2col and 12 conv3x3_flat, the f32 gradients
   within 1e-3 relative L2 of one process's step on all 4, parameters bit
   for bit across the ranks, ms per step beside one process's,
   static_train over the group and each rank's checkpoint through
   process_dir, train-multi, and video_st train cut after a mid-batch step
   state and resumed from the carry sidecars, bit for bit the uninterrupted
   run, and no training graph on either rank; the serving paths over the
   device list [cuda:0, cuda:0] (process_dir at batch 64 within the serving
   limits of one device, launches per shard; convert-dir lanes split 2 + 1,
   every clip exactly its stylize_clip, launches per shard and frame row;
   fast_st serve at batch 8); and
   ``parallel/dryrun.py`` with two gloo ranks on cuda:0;
13. the packed slice (also alone with ``--packed``): ``pack_synthetic`` of 64
   images at 256 px; ``static_train`` on its loaders for a few steps at
   batch 4, f32 and bf16 (every step on a uint8 batch on the card and a
   replay of its CUDA graph, captured once with 15 fused-IN forwards and
   backwards, 2 conv3x3_im2col and 12 conv3x3_flat a pass; the eval and
   previews on uint8 batches; finite losses);
   one f32 step on two of its images, card against CPU (losses 1e-5,
   parameters 1e-3 relative L2); ``fast_st train-multi --packed`` for an
   epoch of the file; the loop's ms per step on the packed file beside the
   synthetic corpus, in turns;
14. the lbfgs-zoom slice (also alone with ``--zoom``, with phase 15):
   ``gatys_st --optimizer lbfgs-zoom`` at 256 px for 20 steps in f32 and
   bf16 and at its 300-step default in f32 (per closure 1 conv3x3_im2col and
   9 conv3x3_flat, no cuDNN conv; closures and host reads per step; s per
   image); ``_run_lbfgs`` on a 64 px image, card against CPU (first loss
   1e-5, 3 steps 1e-3), and on 3 images in one run, each lane against its
   image alone; ``gatys_st --serve --optimizer lbfgs-zoom`` as phase 11 runs
   the L-BFGS daemon;
15. ``python -m styletransfer_tpu_torch doctor``: exit 0, the card's row and
   the kernel build's row ok;
16. the aot / start-up phase (also alone with ``--aot``): ``fast_st
   convert-image`` and ``convert-dir`` (8 images, 256 px, f32 and bf16,
   reflect) with ``STX_AOT_CACHE=1`` and without: the same PNGs bit for
   bit, two graphs captured and replayed with the flag (each forward's
   kernels launched in the warm-up and the capture) and none without; the
   serving forward's wall ms per call at batch 1 and 64, on its graph and
   eagerly, in turns; a fresh process's seconds from ``python -c`` to the
   import, the first forward and the saved PNG, with the kernel build cache
   warm and with ``STX_NO_COMPILE_CACHE=1`` (every kernel it loads built
   by nvcc in the process); ``STX_MATMUL_PRECISION=high`` against unset on
   the f32 forward at batch 64 (TF32 flags, the uint8 output within
   TF32_MAX_STEPS, finite, both times); the native CRC32C built here, equal
   to Python's on 1 MiB, with its MB/s;
17. the Orbax slice (also alone with ``--ckpt``): ``native/zstd.c`` built with
   ``cc``; the committed ``.orbax`` fixture that the JAX package wrote
   (``scripts/torch_make_orbax_fixture.py``) decoded by the port's own zstd,
   OCDBT and zarr codec, every array bit for bit numpy's from the seed
   (``scripts/torch_orbax_fixture_arrays.py``, no JAX in the process);
   ``static_train`` for a few steps at batch 4 under
   ``STX_CKPT_BACKEND=orbax`` (15 fused-IN forwards and backwards per step;
   the epoch written as an ``.orbax`` directory); ``load_latest_transformer``
   picking that epoch, the trained parameters bit for bit; ``process_dir``
   from it, the PNGs bit for bit those from the same parameters saved as
   ``.msgpack`` (10 conv3x3 and 15 IN-pad launches per forward); a second
   ``static_train`` skipping the finished epoch; the host seconds to save
   and load the epoch in each format; and the seconds that
   ``download_videos_dataset`` takes to warn and return when its HEAD is
   refused (the sample URLs point at a closed port on this machine for the
   whole run: the video datasets built from a directory try that download,
   and this script reaches for no host outside the machine);
18. print one JSON line with each kernel's error, launches and times (and
   each kernel's launches on the video-slice paths, on train-multi, in the
   stdin daemons, in the network slice's daemons, on the multi-GPU slice's
   paths, on the packed paths, on the lbfgs-zoom paths, in the aot phase's
   convert commands and on the Orbax slice's paths), and as the last line
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
import re
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
    # Not the port of a TPU kernel either: the phase-form upsample conv that
    # the JAX package leaves to XLA (the phase kernel, then depth_to_space).
    "upconv_phase": ("styletransfer_tpu_torch/csrc/upconv_phase.cu",
                     "styletransfer_tpu/ops/layers.py:334"),
    # Nor this: conv_out's 9x9 conv and its input gradient, which the JAX
    # package leaves to XLA (the space-to-depth conv, or the 9x9 conv, and
    # its autodiff).
    "conv9x9": ("styletransfer_tpu_torch/csrc/conv9x9.cu",
                "styletransfer_tpu/ops/layers.py:93"),
}
# conv3x3_valid's kernel on each route of valid_plan.
ROUTE_SOURCES = {"f32_fma": "styletransfer_tpu_torch/csrc/conv3x3.cu",
                 "bf16_mma": "styletransfer_tpu_torch/csrc/conv3x3.cu",
                 "bf16_wgmma": "styletransfer_tpu_torch/csrc/conv3x3_wgmma.cu"}
# Which path launches each kernel: its JSON launch count is that path's.
SERVING_KERNELS = ("conv3x3_valid", "instance_norm_pad", "upconv_phase", "conv9x9")
# upconv_phase launches per pad-early serving forward: the two upsample convs
# in f32; bf16 keeps them on cuDNN, and the video stylizer (fixed_order) on
# conv_direct.
UPCONV_PER_FORWARD = {"f32": 2, "bf16": 0}
# conv9x9 launches: one per f32 forward of the transform net (conv_out of the
# serving, stacked and zero-padded forwards), two per f32 training step (its
# forward and input gradient); bf16 keeps conv_out on cuDNN, and the video
# stylizer (fixed_order) on conv_direct.
CONV9X9_PER_FORWARD = {"f32": 1, "bf16": 0}
CONV9X9_PER_STEP = {"f32": 2, "bf16": 0}
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
        conv3x3, conv3x3_flat, conv9x9, conv_direct, fused_instance_norm, instance_norm,
        upconv_phase)

    return {"conv3x3_valid": (conv3x3, "launches"),
            "conv3x3_valid.f32_fma": (conv3x3, "fma_launches"),
            "conv3x3_valid.bf16_mma": (conv3x3, "mma_launches"),
            "conv3x3_valid.bf16_wgmma": (conv3x3, "wgmma_launches"),
            "instance_norm_pad": (instance_norm, "launches"),
            "fused_instance_norm_fwd": (fused_instance_norm, "fwd_launches"),
            "fused_instance_norm_fwd.per_image": (fused_instance_norm,
                                                  "fwd_per_image_launches"),
            "fused_instance_norm_bwd": (fused_instance_norm, "bwd_launches"),
            "fused_instance_norm_bwd.per_image": (fused_instance_norm,
                                                  "bwd_per_image_launches"),
            "conv3x3_flat": (conv3x3_flat, "flat_launches"),
            "conv3x3_im2col": (conv3x3_flat, "im2col_launches"),
            "conv_direct": (conv_direct, "launches"),
            "upconv_phase": (upconv_phase, "launches"),
            "conv9x9": (conv9x9, "launches")}


def with_conv9x9(per_step: dict, precision: str) -> dict:
    """A training step's launches with conv9x9's (none in bf16)."""
    n = CONV9X9_PER_STEP[precision]
    return {**per_step, "conv9x9": n} if n else dict(per_step)


def reset_counts() -> None:
    for module, attr in counters().values():
        setattr(module, attr, 0)


def read_counts() -> dict:
    return {name: getattr(module, attr) for name, (module, attr) in counters().items()}


def graph_counts() -> tuple:
    """The training graphs captured and replayed so far (``utils/aot.py``)."""
    from styletransfer_tpu_torch.utils import aot

    return aot.train_captures, aot.train_replays


def graphed_since(before: tuple) -> tuple:
    """The training graphs captured and replayed since ``before``."""
    now = graph_counts()
    return now[0] - before[0], now[1] - before[1]


def step_passes(steps: int, graphs: tuple) -> int:
    """The forward-backward passes that the kernels' launch counters saw in
    ``steps`` training steps, of which ``graphs`` = (captures, replays) ran
    on CUDA graphs: a graph's kernels launch in its capture (``aot.WARMUP``
    warm-ups and the captured pass) and at no replay; an eager step
    launches its own."""
    from styletransfer_tpu_torch.utils import aot

    captures, replays = graphs
    return steps - replays + (aot.WARMUP + 1) * captures


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


# conv9x9's calls, (label, B, Hp, Wp, C, O) of its padded input: conv_out of
# the serving forward (batch BATCH) and of a train step (batch TRAIN_BATCH),
# the step's input gradient (3 -> 32 on dy zero-padded by 8), and a ragged
# 756 x 1012 photo at batch 1 (no tile divides its sides).
CONV9X9_CALLS = (("conv_out", BATCH, SIZE + 8, SIZE + 8, 32, 3),
                 ("conv_out train", TRAIN_BATCH, SIZE + 8, SIZE + 8, 32, 3),
                 ("conv_out.dx train", TRAIN_BATCH, SIZE + 16, SIZE + 16, 3, 32),
                 ("conv_out photo", 1, 764, 1020, 32, 3))
# Its largest gap from the plain version (cuDNN's 9x9 conv, TF32 off), over
# the largest plain output: the same f32 products summed in another order.
CONV9X9_REL = 1e-5


def conv9x9_phase(torch, F, c9):
    """conv9x9 against its plain version at each of CONV9X9_CALLS: the
    largest gap over the largest output, a bit-identical repeat, image 0 of
    the batch bit for bit image 0 alone, one launch a call on its own
    counter and no other; the plan; device times of the kernel, the plain
    version and cuDNN's calls for the same conv (the 9x9 conv, on the
    heuristic pick and cudnn.benchmark's best; at the forward's shapes the
    former serving form, space-to-depth, the 3x3 512 -> 48 phase conv,
    depth_to_space and the bias; at the input gradient cuDNN's dgrad, what
    autograd of the 9x9 conv ran), and the bound. Returns its JSON entry:
    the serving call's times, and each call's."""
    from styletransfer_tpu_torch.ops import layers

    name = "conv9x9"
    g = torch.Generator(device="cuda").manual_seed(19)
    worst = 0.0
    calls = []
    benchmark = torch.backends.cudnn.benchmark
    for label, B, Hp, Wp, C, O in CONV9X9_CALLS:
        H, W = Hp - 8, Wp - 8
        xp = torch.randn(B, Hp, Wp, C, device="cuda", generator=g)
        w = torch.randn(9, 9, C, O, device="cuda", generator=g) / (81 * C) ** 0.5
        b = torch.randn(O, device="cuda", generator=g) * 0.1 if O == 3 else None
        plan = c9.plan(B, H, W, C, O, torch.cuda.get_device_properties(0).multi_processor_count)
        tag = f"{name} float32 {label} xp[{B},{Hp},{Wp},{C}] -> {O}"
        reset_counts()
        out = c9.conv9x9_valid(xp, w, b)
        again = c9.conv9x9_valid(xp, w, b)
        alone = c9.conv9x9_valid(xp[:1].contiguous(), w, b)
        torch.cuda.synchronize()
        counts = read_counts()
        want = {key: 0 for key in counts}
        want[name] = 3
        check(counts == want, f"{tag}: three calls launched {counts} (want 3 {name}, no other)")
        pout = c9.conv9x9_plain(xp, w, b)
        rel = max_err(out, pout) / float(pout.abs().max())
        worst = max(worst, rel)
        check(out.shape == pout.shape == (B, H, W, O) and rel <= CONV9X9_REL
              and torch.equal(out, again) and torch.equal(out[:1], alone),
              f"{tag}: max gap {rel:.3g} of the largest output (limit {CONV9X9_REL:.0e}); the "
              f"repeat and image 0 alone bit-identical; plan {plan}")
        del again, alone, pout
        ms = device_ms(torch, lambda: c9.conv9x9_valid(xp, w, b), iters=10)
        plain_ms = device_ms(torch, lambda: c9.conv9x9_plain(xp, w, b), iters=5)
        flops = 2.0 * 81 * C * O * B * H * W
        nbytes = (xp.numel() + w.numel() + out.numel() + O) * 4
        bound_ms, bound_by = bound(flops, nbytes, "float32")
        call = {"call": label, "xp": [B, Hp, Wp, C], "O": O, "plan": plan, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "max_rel_err": rel}
        # cuDNN's calls for the same conv, on NCHW views of the channels-last tensors.
        xc = xp.permute(0, 3, 1, 2)
        wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        library = {"conv": lambda: F.conv2d(xc, wc)}
        if O == 3:
            kp = layers.phase_conv_kernel(w, 4)
            library["phase_form"] = lambda: layers.depth_to_space(
                layers.conv2d(layers.space_to_depth(xp, 4), kp), 4) + b
        else:
            # The input gradient that autograd of the forward's 9x9 conv ran:
            # x [B, H, W, 32], dy [B, H - 8, W - 8, 3] is xp's interior.
            dy = xp[:, 8:-8, 8:-8, :].contiguous().permute(0, 3, 1, 2)
            wf = w.flip((0, 1)).permute(2, 3, 0, 1).contiguous(memory_format=torch.channels_last)
            xin = torch.empty(B, H, W, O, device="cuda").permute(0, 3, 1, 2)
            library["dgrad"] = lambda: torch.ops.aten.convolution_backward(
                dy, xin, wf, None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1,
                [True, False, False])[0]
        try:
            for best in (False, True):
                torch.backends.cudnn.benchmark = best
                pick = "best" if best else "heuristic"
                for form, fn in library.items():
                    call[f"library_{form}_{pick}_ms"] = device_ms(torch, fn, iters=5)
        finally:
            torch.backends.cudnn.benchmark = benchmark
        line = (f"{tag}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms {bound_ms:.4f} "
                f"({bound_by}), {bound_ms / ms:.3f} of the bound; library_ms (cuDNN) " +
                ", ".join(f"{k[len('library_'):-len('_ms')]} {v:.4f}" for k, v in call.items()
                          if k.startswith("library_")))
        print(line, flush=True)
        calls.append(call)
        del xp, out, library
        torch.cuda.empty_cache()
    serve = calls[0]
    return {"name": f"{name}.float32", "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "max_rel_err": worst, "ms": serve["ms"],
            "plain_ms": serve["plain_ms"], "bound_ms": serve["bound_ms"],
            "bound_by": serve["bound_by"],
            "library_ms": serve["library_phase_form_heuristic_ms"],
            "library_conv_ms": serve["library_conv_heuristic_ms"],
            "train_ms": calls[1]["ms"] + calls[2]["ms"],
            "train_library_ms": (calls[1]["library_conv_heuristic_ms"]
                                 + calls[2]["library_dgrad_heuristic_ms"]), "calls": calls,
            "note": "not a TPU kernel: conv_out's 9x9 conv and its input gradient, which the "
                    "JAX package leaves to XLA",
            "shape": f"conv_out of a {SIZE} px serving forward at batch {BATCH} (32 -> 3, 9x9, "
                     f"on up2_in's reflect-padded output)"}


# AdaIN's serving forward (models/adain.py): pairs a call and the side of
# content and style, the benchmark cell's.
ADAIN_BATCH = 16
ADAIN_SIZE = 512
# upconv_phase's calls, (label, B, h, w, C, O, relu) of the small grid: the
# serving forward's up1_conv and up2_conv at batch BATCH and SIZE px, and
# ragged photo-sized grids at batch 1 (no tile of the kernel divides h or w);
# AdaIN's decoder's up1 .. up3 (bias and ReLU) at batch ADAIN_BATCH and
# ADAIN_SIZE px, and a ragged grid of its widest.
UPCONV_CALLS = (("up1_conv", BATCH, SIZE // 4, SIZE // 4, 128, 64, False),
                ("up2_conv", BATCH, SIZE // 2, SIZE // 2, 64, 32, False),
                ("up1_conv ragged", 1, 379, 505, 128, 64, False),
                ("up2_conv ragged", 1, 757, 1009, 64, 32, False),
                ("adain up1", ADAIN_BATCH, ADAIN_SIZE // 8, ADAIN_SIZE // 8, 256, 256, True),
                ("adain up2", ADAIN_BATCH, ADAIN_SIZE // 4, ADAIN_SIZE // 4, 128, 128, True),
                ("adain up3", ADAIN_BATCH, ADAIN_SIZE // 2, ADAIN_SIZE // 2, 64, 64, True),
                ("adain up1 ragged", 1, 93, 125, 256, 256, True))
# Its largest gap from the plain version (cuDNN's 3x3 phase conv, TF32 off),
# over the largest plain output: the same f32 products summed in another
# order.
UPCONV_REL = 1e-5


def upconv_phase_phase(torch, F, up):
    """upconv_phase against its plain version at the serving forward's two
    calls, at AdaIN's decoder's three (with the ReLU) and at ragged grids:
    the largest gap over the largest output, a bit-identical repeat, one
    launch a call on its own counter and no other; device times of the
    kernel, the plain version (the phase conv, the bias, depth_to_space, the
    ReLU) and, at the forwards' calls, the library's conv alone (the 3x3
    phase conv on the small grid and the published conv on the upsampled,
    reflect-padded grid, each on cuDNN's heuristic pick and on its best
    algorithm, cudnn.benchmark), and the bound. Returns its JSON entry with
    the two serving calls' totals, a forward's, and AdaIN's three's."""
    from styletransfer_tpu_torch.ops import layers

    name = "upconv_phase"
    g = torch.Generator(device="cuda").manual_seed(17)
    totals = {b: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "library_best_ms": 0.0,
                  "ops_ms": 0.0, "bytes_ms": 0.0} for b in (BATCH, ADAIN_BATCH)}
    worst = 0.0
    calls = []
    benchmark = torch.backends.cudnn.benchmark
    for label, B, h, w, C, O, relu in UPCONV_CALLS:
        s = torch.randn(B, h, w, C, device="cuda", generator=g)
        k = torch.randn(3, 3, C, O, device="cuda", generator=g) / (9 * C) ** 0.5
        b = torch.randn(O, device="cuda", generator=g) * 0.1
        y = layers.edge_pad(s, 1)
        taps = layers.upsample_phase_taps(k)
        tag = f"{name} float32 {label} y[{B},{h + 2},{w + 2},{C}] -> {O}{' relu' * relu}"
        reset_counts()
        out = up.upconv_phase(y, taps, b, relu)
        again = up.upconv_phase(y, taps, b, relu)
        torch.cuda.synchronize()
        counts = read_counts()
        want = {key: 0 for key in counts}
        want[name] = 2
        check(counts == want, f"{tag}: two calls launched {counts} (want 2 {name}, no other)")
        pout = up.upconv_phase_plain(y, taps, b, relu)
        rel = max_err(out, pout) / float(pout.abs().max())
        worst = max(worst, rel)
        check(out.shape == pout.shape == (B, 2 * h, 2 * w, O) and rel <= UPCONV_REL
              and torch.equal(out, again),
              f"{tag}: max gap {rel:.3g} of the largest output (limit {UPCONV_REL:.0e}); the "
              f"repeat bit-identical")
        ms = device_ms(torch, lambda: up.upconv_phase(y, taps, b, relu), iters=10)
        plain_ms = device_ms(torch, lambda: up.upconv_phase_plain(y, taps, b, relu), iters=5)
        flops = 2.0 * 16 * C * O * B * h * w
        nbytes = (y.numel() + taps.numel() + out.numel() + O) * 4
        bound_ms, bound_by = bound(flops, nbytes, "float32")
        call = {"call": label, "y": [B, h + 2, w + 2, C], "O": O, "relu": relu, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "max_rel_err": rel}
        line = (f"{tag}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms {bound_ms:.4f} "
                f"({bound_by}), {bound_ms / ms:.3f} of the bound")
        del again, pout
        if B in totals:
            # The library's conv alone, on NCHW views of the channels-last
            # tensors: the phase conv, and the conv that it stands for.
            yc = y.permute(0, 3, 1, 2)
            kp = layers.upsample_phase_kernel(k).permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            u = layers.reflect_pad(layers.upsample_nearest(s, 2), 1).permute(0, 3, 1, 2)
            kc = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            try:
                for best in (False, True):
                    torch.backends.cudnn.benchmark = best
                    pick = "best" if best else "heuristic"
                    call[f"library_phase_{pick}_ms"] = device_ms(
                        torch, lambda: F.conv2d(yc, kp), iters=5)
                    call[f"library_published_{pick}_ms"] = device_ms(
                        torch, lambda: F.conv2d(u, kc), iters=5)
            finally:
                torch.backends.cudnn.benchmark = benchmark
            library_ms = call["library_phase_heuristic_ms"]
            library_best_ms = min(call[f"library_{c}_best_ms"] for c in ("phase", "published"))
            total = totals[B]
            total["ms"] += ms
            total["plain_ms"] += plain_ms
            total["library_ms"] += library_ms
            total["library_best_ms"] += library_best_ms
            total["ops_ms"] += flops / PEAK_FLOPS["float32"] * 1e3
            total["bytes_ms"] += nbytes / PEAK_BYTES_PER_S * 1e3
            line += (f"; library_ms (cuDNN, conv alone) phase conv "
                     f"{call['library_phase_heuristic_ms']:.4f} heuristic, "
                     f"{call['library_phase_best_ms']:.4f} best; published conv "
                     f"{call['library_published_heuristic_ms']:.4f} heuristic, "
                     f"{call['library_published_best_ms']:.4f} best")
            del yc, kp, u, kc
        print(line, flush=True)
        calls.append(call)
        del s, y, out
        torch.cuda.empty_cache()
    for B, what in ((BATCH, "the two upsample convs of a forward"),
                    (ADAIN_BATCH, "AdaIN's three upsample convs of a forward")):
        t = totals[B]
        print(f"{name} float32: {what} at batch {B}: kernel_ms {t['ms']:.4f} plain_ms "
              f"{t['plain_ms']:.4f} library_ms {t['library_ms']:.4f} (heuristic), "
              f"{t['library_best_ms']:.4f} (best) bound_ms "
              f"{max(t['ops_ms'], t['bytes_ms']):.4f}", flush=True)
    total, adain = totals[BATCH], totals[ADAIN_BATCH]
    bound_ms = max(total["ops_ms"], total["bytes_ms"])
    return {"name": f"{name}.float32", "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "max_rel_err": worst, "ms": total["ms"],
            "plain_ms": total["plain_ms"], "bound_ms": bound_ms,
            "bound_by": "operations" if total["ops_ms"] > total["bytes_ms"] else "bytes",
            "library_ms": total["library_ms"], "library_best_ms": total["library_best_ms"],
            "adain_ms": adain["ms"], "adain_plain_ms": adain["plain_ms"],
            "adain_bound_ms": max(adain["ops_ms"], adain["bytes_ms"]),
            "adain_library_ms": adain["library_ms"],
            "adain_library_best_ms": adain["library_best_ms"], "calls": calls,
            "note": "not a TPU kernel: the phase-form upsample conv the JAX package leaves to XLA",
            "shape": f"the two upsample convs of a {SIZE} px serving forward at batch {BATCH} "
                     f"(up1 128->64 on {SIZE // 4}x{SIZE // 4}, up2 64->32 on "
                     f"{SIZE // 2}x{SIZE // 2}, phase form)"}


# One AdaIN forward's launches (models/adain.py): the eight encoder convs
# after conv1_1 and the decoder's five plain 3x3 convs on conv3x3_valid (f32
# FMA), conv1_1 (the 1x1 conv folded in) on conv3x3_im2col, conv_out (64 -> 3)
# on conv3x3_flat, AdaIN on one IN-pad, the three upsample convs on
# upconv_phase.
ADAIN_PER_FORWARD = {"conv3x3_valid": 13, "conv3x3_valid.f32_fma": 13, "conv3x3_im2col": 1,
                     "conv3x3_flat": 1, "instance_norm_pad": 1, "upconv_phase": 3}
# The output against the rounded plain reference: (max level steps, mean).
ADAIN_TOL = (1, 1e-3)


def adain_path(torch, np):
    """AdaIN's serving forward at ADAIN_BATCH pairs of ADAIN_SIZE px on
    seeded weights, each pair its own style: the launches of two forwards
    (ADAIN_PER_FORWARD each, no other kernel), a bit-identical repeat, the
    output against the plain reference in blocks of 4 pairs (levels of
    the rounded reference), device ms a forward and img/s. Returns the
    launches of one forward and the rate."""
    from h100bench.reference import adain as ref
    from styletransfer_tpu_torch.engines import adain as engine
    from styletransfer_tpu_torch.models import adain

    params = adain.init_params(seed=0, device="cuda")
    rng = np.random.default_rng(31)
    shape = (ADAIN_BATCH, ADAIN_SIZE, ADAIN_SIZE, 3)
    content = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).cuda()
    style = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).cuda()
    serve = engine.make_serve_fn("f32")
    serve(params, content, style)
    torch.cuda.synchronize()
    reset_counts()
    out = serve(params, content, style)
    again = serve(params, content, style)
    torch.cuda.synchronize()
    counts = read_counts()
    want = {key: 2 * ADAIN_PER_FORWARD.get(key, 0) for key in counts}
    check(counts == want, f"adain: two forwards launched {counts} (want {want})")
    vgg, dec = (({k: v.cuda() for k, v in sd.items()})
                for sd in adain.export_torch_state_dict(params))
    steps, gaps = 0, []
    with ref.precision(tf32=False):
        for i in range(0, ADAIN_BATCH, 4):
            r = ref.stylize(vgg, dec, content[i:i + 4].permute(0, 3, 1, 2).float() / 255,
                            style[i:i + 4].permute(0, 3, 1, 2).float() / 255)
            levels = torch.round(torch.clamp(r, 0, 1) * 255).permute(0, 2, 3, 1)
            gap = (out[i:i + 4].float() - levels).abs()
            steps = max(steps, int(gap.max()))
            gaps.append(float(gap.mean()))
    mean = float(np.mean(gaps))
    check(steps <= ADAIN_TOL[0] and mean <= ADAIN_TOL[1] and torch.equal(out, again),
          f"adain: {steps} level steps (limit {ADAIN_TOL[0]}), mean {mean:.3g} (limit "
          f"{ADAIN_TOL[1]}) from the plain reference; the repeat bit-identical")
    # The card takes about 180 ms a forward, the host a few to issue one: events
    # around calls as the host issues them time the card (the ~150 launches of
    # five forwards overflow the queue that device_ms fills behind a spin).
    ms = time_ms(torch, lambda: serve(params, content, style), iters=5, warmup=1)
    rate = ADAIN_BATCH / (ms / 1e3)
    print(f"adain float32 serving forward, {ADAIN_BATCH} pairs of {ADAIN_SIZE} px: {ms:.2f} "
          f"ms, {rate:.1f} img/s, launches {ADAIN_PER_FORWARD} a forward, {steps} level "
          f"steps and mean {mean:.3g} from the plain reference", flush=True)
    return {k: v // 2 for k, v in counts.items()}, rate


# The other kernels of one AdaIN forward at ADAIN_BATCH pairs of ADAIN_SIZE
# px (upconv_phase's three are in UPCONV_CALLS): (kernel, call, images as a
# multiple of ADAIN_BATCH (the encoder runs content and style as one batch),
# ADAIN_SIZE over the output side, C, O, ReLU, calls a forward). Each conv's
# input is reflect-padded by 1; the IN-pad writes the decoder's padded input.
ADAIN_CALLS = (
    ("conv3x3_im2col", "enc.conv1_1", 2, 1, 3, 64, True, 1),
    ("conv3x3_valid", "enc.conv1_2", 2, 1, 64, 64, True, 1),
    ("conv3x3_valid", "enc.conv2_1", 2, 2, 64, 128, True, 1),
    ("conv3x3_valid", "enc.conv2_2", 2, 2, 128, 128, True, 1),
    ("conv3x3_valid", "enc.conv3_1", 2, 4, 128, 256, True, 1),
    ("conv3x3_valid", "enc.conv3_2..conv3_4", 2, 4, 256, 256, True, 3),
    ("conv3x3_valid", "enc.conv4_1", 2, 8, 256, 512, True, 1),
    ("instance_norm_pad", "norm", 1, 8, 512, 512, False, 1),
    ("conv3x3_valid", "dec.conv1", 1, 8, 512, 256, True, 1),
    ("conv3x3_valid", "dec.conv2..conv3", 1, 4, 256, 256, True, 2),
    ("conv3x3_valid", "dec.conv4", 1, 4, 256, 128, True, 1),
    ("conv3x3_valid", "dec.conv5", 1, 2, 128, 64, True, 1),
    ("conv3x3_flat", "dec.conv_out", 1, 1, 64, 3, False, 1),
)


def adain_kernels(torch, F):
    """Each kernel of AdaIN's forward but upconv_phase (ADAIN_CALLS) through
    its wrapper on card tensors at the forward's shapes, against its plain
    version at the tolerance of TOL (conv3x3_valid's sums at SUMS_TOL): a
    bit-identical repeat, two launches on the kernel's counter (and
    conv3x3_valid's on its f32 FMA route) and none on another; device times
    of the kernel, the plain version and, for a conv, cuDNN's conv alone
    (channels-last, TF32 off), and the bound. Returns one JSON entry a
    kernel with its calls and the totals of a forward; ``counter`` names the
    launch counter whose count a forward the caller adds."""
    from styletransfer_tpu_torch.ops import layers
    from styletransfer_tpu_torch.ops.cuda import conv3x3, conv3x3_flat, instance_norm

    layers.disable_tf32()
    g = torch.Generator(device="cuda").manual_seed(23)
    fns = {"conv3x3_valid": (conv3x3.conv3x3_valid, conv3x3.conv3x3_valid_plain),
           "conv3x3_im2col": (conv3x3_flat.conv3x3_im2col, conv3x3_flat.conv3x3_im2col_plain),
           "conv3x3_flat": (conv3x3_flat.conv3x3_flat, conv3x3_flat.conv3x3_flat_plain),
           "instance_norm_pad": (instance_norm.instance_norm_pad,
                                 instance_norm.instance_norm_pad_plain)}
    entries = {}
    for kernel, label, mult, div, C, O, relu, count in ADAIN_CALLS:
        B, H = mult * ADAIN_BATCH, ADAIN_SIZE // div
        rtol, atol = TOL[(kernel, "float32")]
        fn, plain = fns[kernel]
        if kernel == "instance_norm_pad":
            x = torch.randn(B, H, H, C, device="cuda", generator=g) * 2 + 0.5
            scale = torch.rand(B, C, device="cuda", generator=g) + 0.5
            bias = torch.randn(B, C, device="cuda", generator=g)
            args = (x, scale, bias)
            kwargs = dict(pad=1)
            plan = instance_norm.in_plan(B, H, H, C, torch.float32, False)
            flops = 8.0 * x.numel()
            nbytes = (x.numel() + B * (H + 2) ** 2 * C + 2 * B * C) * 4
            shape = f"x[{B},{H},{H},{C}] [N, C] affines, reflect pad 1"
        else:
            interior = (torch.rand if C == 3 else torch.randn)(B, H, H, C, device="cuda",
                                                              generator=g)
            x = layers.reflect_pad(interior, 1)
            del interior
            w = torch.randn(3, 3, C, O, device="cuda", generator=g) * (2.0 / (9 * C)) ** 0.5
            b = torch.randn(O, device="cuda", generator=g) * 0.1
            args = (x, w, b, relu)
            kwargs = {}
            plan = {"conv3x3_valid": lambda: conv3x3.valid_plan(B, H, H, C, O, torch.float32),
                    "conv3x3_im2col": lambda: conv3x3_flat.im2col_plan(B, H, H, C, O,
                                                                       torch.float32),
                    "conv3x3_flat": lambda: conv3x3_flat.flat_plan(B, H, H, C, O,
                                                                   torch.float32)}[kernel]()
            flops = 2.0 * B * H * H * 9 * C * O
            nbytes = (x.numel() + w.numel() + B * H * H * O + O) * 4
            shape = f"x[{B},{H + 2},{H + 2},{C}] -> {O}{' relu' * relu}"
        tag = f"{kernel} float32 adain {label} {shape} ({plan})"
        reset_counts()
        out = fn(*args, **kwargs)
        again = fn(*args, **kwargs)
        torch.cuda.synchronize()
        counts = read_counts()
        want = {key: 0 for key in counts}
        want[kernel] = 2
        if kernel == "conv3x3_valid":
            want["conv3x3_valid.f32_fma"] = 2
        check(counts == want, f"{tag}: two calls launched {counts} (want {want})")
        pout = plain(*args, **kwargs)
        outs, pouts, agains = ((t,) if torch.is_tensor(t) else t for t in (out, pout, again))
        err = max_err(outs[0], pouts[0])
        check(allclose(torch, outs[0], pouts[0], rtol, atol),
              f"{tag}: max_abs_err {err:.3g} (rtol {rtol:.3g}, atol {atol:.3g})")
        if len(outs) == 3:
            check(all(allclose(torch, u, v, *SUMS_TOL) for u, v in zip(outs[1:], pouts[1:])),
                  f"{tag} sums/sumsqs: max_abs_err {max_err(outs[1], pouts[1]):.3g} / "
                  f"{max_err(outs[2], pouts[2]):.3g} (rtol {SUMS_TOL[0]}, atol {SUMS_TOL[1]})")
        check(all(torch.equal(u, v) for u, v in zip(outs, agains)),
              f"{tag}: the repeat is bit-identical")
        del out, again, pout, outs, pouts, agains
        ms = device_ms(torch, lambda: fn(*args, **kwargs), iters=5)
        plain_ms = device_ms(torch, lambda: plain(*args, **kwargs), iters=2, warmup=1)
        library_ms = None
        if kernel != "instance_norm_pad":
            # The one PyTorch call that computes the same function: cuDNN on
            # the channels-last views, TF32 off (the conv without the ReLU).
            xc = x.permute(0, 3, 1, 2)
            wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            library_ms = device_ms(torch, lambda: F.conv2d(xc, wc, b), iters=3, warmup=1)
            del xc, wc
        bound_ms, bound_by = bound(flops, nbytes, "float32")
        library = "" if library_ms is None else f"library_ms {library_ms:.4f} "
        print(f"{tag}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} {library}bound_ms "
              f"{bound_ms:.4f} ({bound_by}), {bound_ms / ms:.3f} of the bound; x{count} a "
              f"forward", flush=True)
        e = entries.setdefault(kernel, {
            "name": f"{kernel}_adain.float32", "route": "cuda", "source": SOURCES[kernel][0],
            "replaces": SOURCES[kernel][1], "counter": ("conv3x3_valid.f32_fma"
                                                        if kernel == "conv3x3_valid" else kernel),
            "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "library_ms": None if library_ms is None else 0.0, "calls": [],
            "shape": f"its calls of one AdaIN forward at {ADAIN_BATCH} pairs of {ADAIN_SIZE} "
                     f"px, summed"})
        e["max_abs_err"] = max(e["max_abs_err"], err)
        e["ms"] += ms * count
        e["plain_ms"] += plain_ms * count
        e["bound_ms"] += bound_ms * count
        if library_ms is not None:
            e["library_ms"] += library_ms * count
        e["calls"].append({"call": label, "shape": shape, "plan": str(plan), "count": count,
                           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                           "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err})
        del x, args
        torch.cuda.empty_cache()
    for e in entries.values():
        library = "" if e["library_ms"] is None else f" library_ms {e['library_ms']:.4f}"
        print(f"{e['name']}: {len(e['calls'])} shapes, {sum(c['count'] for c in e['calls'])} "
              f"calls of a forward: kernel_ms {e['ms']:.4f} plain_ms {e['plain_ms']:.4f}"
              f"{library} bound_ms {e['bound_ms']:.4f} ({e['bound_ms'] / e['ms']:.3f} of the "
              f"bound)", flush=True)
    return list(entries.values())


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
        want.update({"conv3x3_valid": 10, f"conv3x3_valid.{route}": 10, "instance_norm_pad": 15,
                     "upconv_phase": UPCONV_PER_FORWARD[precision],
                     "conv9x9": CONV9X9_PER_FORWARD[precision]})
        check(counts == want,
              f"serving path {precision}: one forward launched {counts} (want 10 conv3x3, all "
              f"on the {route} route, 15 IN-pad, {UPCONV_PER_FORWARD[precision]} upconv_phase, "
              f"{CONV9X9_PER_FORWARD[precision]} conv9x9, no training kernel)")
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
                             "instance_norm_pad": 15,
                             "upconv_phase": UPCONV_PER_FORWARD[precision],
                             "conv9x9": CONV9X9_PER_FORWARD[precision]})
                check(counts == want, f"convert-image-multi {precision} {tag}: launched "
                      f"{counts} (want 10 conv3x3 on {route}, 15 IN-pad, "
                      f"{UPCONV_PER_FORWARD[precision]} upconv_phase and "
                      f"{CONV9X9_PER_FORWARD[precision]} conv9x9)")
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
        up = UPCONV_PER_FORWARD[precision]
        check(counts["conv3x3_valid"] == 10 and counts["instance_norm_pad"] == 15
              and counts["upconv_phase"] == up
              and counts["conv9x9"] == CONV9X9_PER_FORWARD[precision]
              and y.shape == x.shape and bool(torch.isfinite(y).all()),
              f"multi-style {precision}: a batch of {BATCH} images of {MULTI_STYLES} mixed "
              f"styles: 10 conv3x3, 15 IN-pad and {up} upconv_phase launches, output "
              f"{tuple(y.shape)} finite")
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


def spans_step_checked(torch, np, vgg_params, style, precision) -> None:
    """One make_train_step step while ``record_spans()`` records: the eager
    step (no training graph captured or replayed), launching one
    forward-backward pass's kernels."""
    from styletransfer_tpu_torch.engines import fast
    from styletransfer_tpu_torch.models import transformer, vgg
    from styletransfer_tpu_torch.utils import profiling

    grams = vgg.style_gram_targets(vgg_params, torch.from_numpy(style).cuda())
    step = fast.make_train_step(vgg_params, grams,
                                compute_dtype=torch.bfloat16 if precision == "bf16" else None)
    params = transformer.init_params(seed=0, device="cuda")
    x = torch.from_numpy(_parallel_batch(np)).cuda()
    reset_counts()
    before = graph_counts()
    with profiling.record_spans() as rec:
        loss = float(step(params, fast.make_optimizer(params), x)["total"])
    graphs = graphed_since(before)
    counts = {k: v for k, v in read_counts().items() if v}
    want = with_conv9x9(PER_STEP, precision)
    print(f"training step {precision} under record_spans: training graphs {graphs[0]} captured, "
          f"{graphs[1]} replays; {len(rec.spans)} spans", flush=True)
    check(graphs == (0, 0) and counts == want and math.isfinite(loss)
          and "train.step" in {s.name for s in rec.spans},
          f"training step {precision} under record_spans: eager ({graphs[0]} graphs captured, "
          f"{graphs[1]} replays), launched {counts} (want {want}), loss finite, span "
          f"train.step recorded")


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
        before = graph_counts()
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
        graphs = graphed_since(before)
        passes = step_passes(TRAIN_STEPS, graphs)
        print(f"training path {precision}: training graphs {graphs[0]} captured, {graphs[1]} "
              f"replays in {TRAIN_STEPS} steps", flush=True)
        check(graphs == (1, TRAIN_STEPS),
              f"training path {precision}: {graphs[0]} training graphs captured and "
              f"{graphs[1]} replays (want 1 and {TRAIN_STEPS}: every step on one graph)")
        counts = read_counts()
        launches[precision] = counts
        want = {k: 0 for k in counts}
        want.update({"fused_instance_norm_fwd": NORMS_PER_FORWARD * (passes + previews
                                                                     + eval_forwards),
                     "fused_instance_norm_bwd": NORMS_PER_FORWARD * passes,
                     "conv9x9": (CONV9X9_PER_STEP[precision] * passes
                                 + CONV9X9_PER_FORWARD[precision] * (previews + eval_forwards))})
        for k in GATYS_KERNELS:
            want[k] = (VGG_PER_STEP[k] * passes + VGG_PER_EVAL[k] * eval_forwards
                       + VGG_STYLE_TARGETS[k])
        check(counts == want,
              f"training path {precision}: {TRAIN_STEPS} steps ({passes} forward-backward "
              f"passes launched: the graph's capture), {previews} previews and "
              f"{eval_forwards} eval forwards launched {counts} (want {want}: 15 IN forward and "
              f"15 backward per pass, 15 forward per preview or eval forward; conv9x9 "
              f"{CONV9X9_PER_STEP[precision]} per pass and {CONV9X9_PER_FORWARD[precision]} per "
              f"preview or eval forward; VGG convs "
              f"{VGG_PER_STEP} per pass, {VGG_PER_EVAL} per eval forward, "
              f"{VGG_STYLE_TARGETS} for the style targets)")
        spans_step_checked(torch, np, vgg_params, style, precision)
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
              and served["conv3x3_valid"] == 10 and served["instance_norm_pad"] == 15
              and served["upconv_phase"] == UPCONV_PER_FORWARD[precision]
              and served["conv9x9"] == CONV9X9_PER_FORWARD[precision],
              f"training path {precision}: the trained checkpoint stylized {len(paths)} images "
              f"through process_dir ({served['conv3x3_valid']} conv3x3, "
              f"{served['instance_norm_pad']} IN-pad, {served['upconv_phase']} upconv_phase "
              f"launches)")
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
        # The previews run the stacked forward in f32 whatever the precision.
        want["conv9x9"] = (CONV9X9_PER_STEP[precision] * steps
                           + CONV9X9_PER_FORWARD["f32"] * previews)
        for k, n in VGG_STYLE_TARGETS.items():
            want[k] += n
        check(counts == want,
              f"video train {precision}: {steps} frame steps and {previews} preview launched "
              f"{counts} (want {VIDEO_PER_STEP} and {CONV9X9_PER_STEP[precision]} conv9x9 per "
              f"frame step, 15 fused-IN forwards and 1 conv9x9 per preview, "
              f"{VGG_STYLE_TARGETS} for the style targets)")
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
            want.update(ZEROS_PER_FORWARD, conv9x9=CONV9X9_PER_FORWARD[precision])
            check(counts == want and pads[0] == 10,
                  f"zeros path {precision}: one forward launched {counts} and {pads[0]} zero-pad "
                  f"copies (want {ZEROS_PER_FORWARD}, {CONV9X9_PER_FORWARD[precision]} conv9x9 "
                  f"and 10 copies; no conv3x3_valid, no IN-pad)")
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


# The multi-style slice: S styles, the training path's batch, steps and
# cadence; the daemons at batch DAEMON_BATCH on DAEMON_REQUESTS requests of
# SIZE px and a second bucket of DAEMON_SIZE2 px.
TRAIN_STYLES = 4
DAEMON_BATCH = 8
DAEMON_REQUESTS = 64
DAEMON_SIZE2 = 512
# Requests of each daemon held against the port's CPU forward (per bucket).
DAEMON_CHECKED = 2
# The multi-style step, card against the port's CPU run: one f32 step of
# make_train_step at this size on two images (styles 1 and 3 of 4 drawn).
MULTI_PARITY_SIZE = 64
ADAM_LR = 1e-3


def fused_affine_phase(torch, fin, dtype):
    """The fused instance norm's forward and backward with per-image [N, C]
    affines (rows drawn apart) at the fifteen call shapes of a batch-4,
    256 px train step, against their plain versions (dscale and dbias [N, C]
    within GRAD_SUMS_RTOL of their largest value); with every row equal, dx
    is bit for bit the [C] call's. Device ms of the fifteen calls beside the
    same calls with a [C] affine, and their bound (the [C] call's bytes plus
    2 N C floats of affines, and 2 N C more of dscale and dbias written).
    Returns the totals."""
    dn = str(dtype).split(".")[1]
    g = torch.Generator(device="cuda").manual_seed(13)
    tot = {k: 0.0 for k in ("fwd_ms", "fwd_shared_ms", "fwd_bound_ms", "bwd_ms",
                            "bwd_shared_ms", "bwd_bound_ms")}
    worst = 0.0
    for call, H, C, with_res, relu, count in _FUSED_CALLS:
        shape = (TRAIN_BATCH, H, H, C)
        N = TRAIN_BATCH
        x = (torch.randn(*shape, device="cuda", generator=g) * 2 + 0.5).to(dtype)
        res = torch.randn(*shape, device="cuda", generator=g).to(dtype) if with_res else None
        scale = torch.rand(N, C, device="cuda", generator=g) + 0.5
        bias = torch.randn(N, C, device="cuda", generator=g)
        gy = torch.randn(*shape, device="cuda", generator=g).to(dtype)
        out, mean, inv = fin.forward(x, scale, bias, res, relu)
        dx, dscale, dbias = fin.backward(gy, x, res, mean, inv, scale, bias, relu)
        pout, pmean, pinv = fin.forward_plain(x, scale, bias, res, relu)
        pdx, pdscale, pdbias = fin.backward_plain(gy, x, res, mean, inv, scale, bias, relu)
        tag = f"{dn} {call} [{N},{H},{H},{C}] [N, C] affines"
        rtol, atol = TOL[("fused_instance_norm_fwd", dn)]
        err = max(max_err(out, pout), max_err(dx, pdx))
        worst = max(worst, err)
        check(allclose(torch, out, pout, rtol, atol)
              and allclose(torch, mean, pmean, *STATS_TOL) and allclose(torch, inv, pinv,
                                                                      *STATS_TOL),
              f"fused_instance_norm_fwd {tag}: out max_abs_err {max_err(out, pout):.3g}")
        rel = max(max_err(dscale, pdscale) / float(pdscale.abs().max()),
                  max_err(dbias, pdbias) / float(pdbias.abs().max()))
        check(tuple(dscale.shape) == tuple(dbias.shape) == (N, C)
              and allclose(torch, dx, pdx, rtol, atol) and rel <= GRAD_SUMS_RTOL,
              f"fused_instance_norm_bwd {tag}: dx max_abs_err {max_err(dx, pdx):.3g}; "
              f"dscale / dbias [N, C] {rel:.3g} of the largest (limit {GRAD_SUMS_RTOL})")
        rows = scale[1].expand(N, C).contiguous(), bias[1].expand(N, C).contiguous()
        shared = fin.backward(gy, x, res, mean, inv, scale[1], bias[1], relu)
        per_row = fin.backward(gy, x, res, mean, inv, *rows, relu)
        check(torch.equal(shared[0], per_row[0]),
              f"fused_instance_norm_bwd {tag}: with every row equal, dx is bit for bit the "
              f"[C] call's")
        ins = x.numel() * (2 if with_res else 1) * x.element_size()
        chan = 2 * N * C * 4 + 2 * N * C * 4  # scale, bias [N, C]; mean, inv
        fb, _ = bound(8.0 * x.numel(), ins + out.numel() * x.element_size() + chan, dn)
        bb, _ = bound(16.0 * x.numel(),
                      ins + 2 * gy.numel() * x.element_size() + chan + 2 * N * C * 4, dn)
        s1, b1 = scale[1], bias[1]
        for key, fn in (
                ("fwd_ms", lambda: fin.forward(x, scale, bias, res, relu)),
                ("fwd_shared_ms", lambda: fin.forward(x, s1, b1, res, relu)),
                ("bwd_ms", lambda: fin.backward(gy, x, res, mean, inv, scale, bias, relu)),
                ("bwd_shared_ms", lambda: fin.backward(gy, x, res, mean, inv, s1, b1, relu))):
            tot[key] += count * device_ms(torch, fn)
        tot["fwd_bound_ms"] += count * fb
        tot["bwd_bound_ms"] += count * bb
    print(f"fused_instance_norm {dn} [N, C] affines, all 15 calls of one train step: fwd "
          f"device_ms {tot['fwd_ms']:.4f} ([C]: {tot['fwd_shared_ms']:.4f}; bound "
          f"{tot['fwd_bound_ms']:.4f}), bwd device_ms {tot['bwd_ms']:.4f} ([C]: "
          f"{tot['bwd_shared_ms']:.4f}; bound {tot['bwd_bound_ms']:.4f}); max_abs_err "
          f"{worst:.3g}", flush=True)
    return tot


def _style_stack(np):
    from styletransfer_tpu_torch.data import coco
    from styletransfer_tpu_torch.utils import images

    return np.stack([images.normalize(coco.synthetic_image(20_000 + s, SIZE))
                     for s in range(TRAIN_STYLES)]).astype(np.float32)


def multistyle_train_path(torch, np, in_dir):
    """Multi-style training: engines.multistyle.train for TRAIN_STEPS steps at
    batch 4, S = TRAIN_STYLES seeded synthetic styles, 256 px, f32 and bf16,
    with step checkpoints. Per step 15 fused-IN forwards and 15 backwards,
    all with [N, C] affines, and the single-style path's VGG convs; 15
    fused-IN forwards per eval forward; a preview on the serving forward (10
    conv3x3_valid, 15 IN-pad). Then the epoch checkpoint ([4, C] affines)
    through ``fast_st convert-image-multi`` by index and by blend, card
    against CPU. Returns (launches by precision, the models directory)."""
    from PIL import Image

    from styletransfer_tpu_torch import ckpt, constants
    from styletransfer_tpu_torch.clis import cli
    from styletransfer_tpu_torch.data import coco
    from styletransfer_tpu_torch.engines import multistyle as engine
    from styletransfer_tpu_torch.models import multistyle, vgg
    from styletransfer_tpu_torch.utils.logging import get_logger

    styles = _style_stack(np)
    vgg_params = vgg.init_params(seed=0, device="cuda")
    _, image_every, eval_every = TRAIN_CADENCE
    root = os.path.join(WORK, "multistyle_train")
    models = os.path.join(root, "data", "models")
    launches = {}
    for precision in ("f32", "bf16"):
        name = f"smoke_{precision}"
        test_loader, train_loader = coco.get_coco_loader(
            batch_size=TRAIN_BATCH, test_limit=20, image_dir=os.path.join(WORK, "no_images"))
        previews = len(range(0, TRAIN_STEPS, image_every))
        eval_forwards = len(test_loader) * len(range(0, TRAIN_STEPS, eval_every))
        log = _LossLog()
        logger = get_logger()
        logger.addHandler(log)
        reset_counts()
        before = graph_counts()
        t0 = time.perf_counter()
        try:
            params = engine.train(
                styles, style_name=name, epochs=1, batch_size=TRAIN_BATCH,
                vgg_params=vgg_params, train_loader=train_loader, test_loader=test_loader,
                log_cadence=TRAIN_CADENCE, runs_dir=os.path.join(root, f"runs_{precision}"),
                models_path=models, max_steps_per_epoch=TRAIN_STEPS, step_checkpoint_every=3,
                precision=precision, device="cuda")
            torch.cuda.synchronize()
        finally:
            logger.removeHandler(log)
        wall = time.perf_counter() - t0
        graphs = graphed_since(before)
        passes = step_passes(TRAIN_STEPS, graphs)
        print(f"multi-style training {precision}: training graphs {graphs[0]} captured, "
              f"{graphs[1]} replays in {TRAIN_STEPS} steps", flush=True)
        check(graphs == (1, TRAIN_STEPS),
              f"multi-style training {precision}: {graphs[0]} training graphs captured and "
              f"{graphs[1]} replays (want 1 and {TRAIN_STEPS}: every step on one graph)")
        counts = read_counts()
        launches[precision] = counts
        route = "f32_fma" if precision == "f32" else "bf16_wgmma"
        fwd = NORMS_PER_FORWARD * (passes + eval_forwards)
        want = {k: 0 for k in counts}
        want.update({"fused_instance_norm_fwd": fwd, "fused_instance_norm_fwd.per_image": fwd,
                     "fused_instance_norm_bwd": NORMS_PER_FORWARD * passes,
                     "fused_instance_norm_bwd.per_image": NORMS_PER_FORWARD * passes,
                     "conv3x3_valid": 10 * previews, f"conv3x3_valid.{route}": 10 * previews,
                     "instance_norm_pad": NORMS_PER_FORWARD * previews,
                     "upconv_phase": UPCONV_PER_FORWARD[precision] * previews,
                     "conv9x9": (CONV9X9_PER_STEP[precision] * passes
                                 + CONV9X9_PER_FORWARD[precision] * (previews + eval_forwards))})
        for k in GATYS_KERNELS:
            want[k] = (VGG_PER_STEP[k] * passes + VGG_PER_EVAL[k] * eval_forwards
                       + VGG_STYLE_TARGETS[k])
        check(counts == want,
              f"multi-style training {precision}: {TRAIN_STEPS} steps ({passes} forward-backward "
              f"passes launched: the graph's capture), {previews} previews, {eval_forwards} eval "
              f"forwards launched {counts} (want {want}: per pass 15 fused-IN forwards and 15 "
              f"backwards with [N, C] affines)")
        check(len(log.train) == TRAIN_STEPS and all(math.isfinite(v) for v in log.train)
              and len(log.test) == 1 and math.isfinite(log.test[0]),
              f"multi-style training {precision}: logged losses "
              f"{['%.4f' % v for v in log.train]}, eval {log.test}, all finite")
        state = ckpt.load_step_state(engine.MODEL_NAME, name, models,
                                     extra_keys=("batch_in_epoch",))
        check(state is not None and (state["epoch"], state["iteration"]) == (1, TRAIN_STEPS)
              and int(state["opt_state"]["0"]["count"]) == TRAIN_STEPS
              and state["extra"]["batch_in_epoch"] == 0,
              f"multi-style training {precision}: step state at epoch 1, iteration "
              f"{TRAIN_STEPS}, Adam count {TRAIN_STEPS}")
        tree = ckpt.load(ckpt.checkpoint_path(engine.MODEL_NAME, name, 0, models))
        check(tree["in1"]["scale"].shape == (TRAIN_STYLES, 32)
              and tree["res3"]["in2"]["bias"].shape == (TRAIN_STYLES, 128)
              and np.array_equal(tree["up2_in"]["scale"], params.up2_in.scale.detach().cpu().numpy()),
              f"multi-style training {precision}: the epoch checkpoint holds the trained "
              f"[{TRAIN_STYLES}, C] affines")
        print(f"multi-style training {precision}: train {TRAIN_STEPS} steps at batch "
              f"{TRAIN_BATCH}, {TRAIN_STYLES} styles in {wall:.3f} s (incl. VGG targets, eval, "
              f"previews, checkpoints)", flush=True)
    # The f32 epoch checkpoint through convert-image-multi, card against CPU.
    image = os.path.join(in_dir, "img001.png")
    saved_root = constants.PROJECT_ROOT_PATH
    constants.PROJECT_ROOT_PATH = root
    try:
        for args, tag in ((["--style-index", "3"], "style3"), (["--blend", MULTI_BLEND],
                                                               "blend")):
            common = ["fast_st", "convert-image-multi", image, "smoke_f32", "--num-styles",
                      str(TRAIN_STYLES), *args]
            reset_counts()
            cli.main(common + ["-o", "card/", "--device", "cuda"], standalone_mode=False)
            torch.cuda.synchronize()
            counts = read_counts()
            check(counts["conv3x3_valid"] == 10 and counts["instance_norm_pad"] == 15
                  and counts["upconv_phase"] == UPCONV_PER_FORWARD["f32"]
                  and counts["conv9x9"] == CONV9X9_PER_FORWARD["f32"],
                  f"the trained checkpoint through convert-image-multi {tag}: 10 conv3x3, "
                  f"15 IN-pad and {UPCONV_PER_FORWARD['f32']} upconv_phase launches")
            cli.main(common + ["-o", "cpu/", "--device", "cpu"], standalone_mode=False)
            fname = f"converted_fast_multi_st_smoke_f32_{tag}.png"
            got = np.asarray(Image.open(os.path.join(root, "card", fname)))
            want_png = np.asarray(Image.open(os.path.join(root, "cpu", fname)))
            _frames_checked(np, f"trained checkpoint, convert-image-multi {tag}: card vs CPU",
                            [got], [want_png], "f32")
    finally:
        constants.PROJECT_ROOT_PATH = saved_root
    return launches, models


def multistyle_parity(torch, np):
    """One f32 multi-style make_train_step on two MULTI_PARITY_SIZE px images
    (styles 1 and 3 of TRAIN_STYLES drawn): the card against the port's CPU
    run from the same seeded parameters. Losses within PARITY_LOSS_RTOL,
    gradients within PARITY_GRAD_REL_L2 (relative L2), biases that a norm
    cancels (gradients of rounding noise) within 2 lr after the Adam step;
    the rows of styles 0 and 2 hold exactly their old values on the card."""
    from styletransfer_tpu_torch.engines import fast
    from styletransfer_tpu_torch.engines import multistyle as engine
    from styletransfer_tpu_torch.models import multistyle, transformer, vgg

    rng = np.random.default_rng(14)
    styles = torch.from_numpy(rng.standard_normal(
        (TRAIN_STYLES, MULTI_PARITY_SIZE, MULTI_PARITY_SIZE, 3)).astype(np.float32) * 0.5)
    batch = torch.from_numpy(rng.standard_normal(
        (2, MULTI_PARITY_SIZE, MULTI_PARITY_SIZE, 3)).astype(np.float32))
    start = multistyle.init_params(seed=6, num_styles=TRAIN_STYLES, device="cpu")
    with torch.no_grad():
        for p in start.parameters():
            if p.dim() == 2:
                p.add_(torch.from_numpy(rng.normal(0, 0.2, tuple(p.shape)).astype(np.float32)))
    tree = transformer.params_to_tree(start)
    idx = np.array([1, 3])
    runs = {}
    for dev in ("cuda", "cpu"):
        params = multistyle.params_from_jax(tree, device=dev)
        v = vgg.init_params(seed=0, device=dev)
        step = engine.make_train_step(v, engine.stack_style_grams(v, styles.to(dev)))
        opt = fast.make_optimizer(params)
        metrics = step(params, opt, batch.to(dev), idx)
        runs[dev] = ({k: float(m) for k, m in metrics.items()},
                     {n: p.grad.detach().cpu() for n, p in params.named_parameters()},
                     {n: p.detach().cpu() for n, p in params.named_parameters()})
    (mg, gg, pg), (mc, gc, pc) = runs["cuda"], runs["cpu"]
    worst_loss = max(abs(mg[k] - mc[k]) / abs(mc[k]) for k in mc)
    check(worst_loss <= PARITY_LOSS_RTOL,
          f"multi-style parity f32: loss components card {mg} vs CPU {mc}: worst relative "
          f"difference {worst_loss:.3g} (limit {PARITY_LOSS_RTOL})")
    scale = max(float(g.norm()) for g in gc.values())
    worst, worst_name = 0.0, ""
    for name, g in gc.items():
        if g.dim() == 2:
            old = torch.from_numpy(np.asarray(_tree_at(tree, name)))
            check(torch.equal(pg[name][0], old[0]) and torch.equal(pg[name][2], old[2]),
                  f"multi-style parity: {name} rows of the undrawn styles 0 and 2 hold their "
                  f"old values")
        if float(g.norm()) < 1e-6 * scale:
            err = float((pg[name] - pc[name]).abs().max())
            check(err <= 2 * ADAM_LR, f"multi-style parity f32: {name} (a gradient of "
                  f"rounding noise) within 2 lr after the step ({err:.3g})")
            continue
        rel = float((gg[name] - g).norm()) / float(g.norm())
        if rel > worst:
            worst, worst_name = rel, name
    check(worst <= PARITY_GRAD_REL_L2,
          f"multi-style parity f32: every parameter gradient within relative L2 "
          f"{PARITY_GRAD_REL_L2} of the CPU run (worst {worst:.3g}, {worst_name})")
    return worst_loss, worst


def _tree_at(tree, name):
    for part in name.split("."):
        tree = tree[part]
    return tree


def multistyle_step_rates(torch, np):
    """Steady-state multi-style train steps at TRAIN_BATCH beside the
    single-style step of the same run, f32 and bf16 (ms per step: host clock
    around 10 steps ending in a synchronize, after 3 warm-up steps)."""
    from styletransfer_tpu_torch.engines import fast
    from styletransfer_tpu_torch.engines import multistyle as engine
    from styletransfer_tpu_torch.models import multistyle, transformer, vgg

    styles = torch.from_numpy(_style_stack(np)).cuda()
    vgg_params = vgg.init_params(seed=0, device="cuda")
    grams = engine.stack_style_grams(vgg_params, styles)
    single_grams = {k: v[:1] for k, v in grams.items()}
    g = torch.Generator(device="cuda").manual_seed(15)
    x = torch.randn(TRAIN_BATCH, SIZE, SIZE, 3, device="cuda", generator=g)
    draws = np.random.default_rng(0)
    out = {}
    for precision in ("f32", "bf16"):
        cd = torch.bfloat16 if precision == "bf16" else None
        for kind in ("single", "multi", "multi", "single"):
            if kind == "single":
                params = transformer.init_params(seed=0, device="cuda")
                step = fast.make_train_step(vgg_params, single_grams, compute_dtype=cd)
                run = lambda: step(params, opt, x)  # noqa: E731
            else:
                params = multistyle.init_params(seed=0, num_styles=TRAIN_STYLES, device="cuda")
                step = engine.make_train_step(vgg_params, grams, compute_dtype=cd)
                run = lambda: step(params, opt, x, multistyle.style_index(  # noqa: E731
                    draws.integers(0, TRAIN_STYLES, TRAIN_BATCH), "cuda"))
            opt = fast.make_optimizer(params)
            for _ in range(3):
                run()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                m = run()
            loss = float(m["total"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / 10
            check(math.isfinite(loss), f"{kind}-style train step {precision}: loss finite")
            out.setdefault((precision, kind), []).append(ms)
        print(f"train step {precision} batch {TRAIN_BATCH} at {SIZE} px, in turns: single-style "
              f"{out[(precision, 'single')]} ms, multi-style ({TRAIN_STYLES} styles) "
              f"{out[(precision, 'multi')]} ms", flush=True)
    return out


class _Stamped:
    """A stdout for a daemon: keeps its lines, and the time of READY and of
    the last line."""

    def __init__(self):
        self.lines, self.buf, self.ready, self.last = [], "", None, None

    def write(self, text):
        self.buf += text
        while "\n" in self.buf:
            line, self.buf = self.buf.split("\n", 1)
            self.lines.append(line)
            self.last = time.perf_counter()
            if line == "READY":
                self.ready = self.last

    def flush(self):
        pass


def _drive(loop, lines, **kw):
    """Run a daemon's loop on scripted stdin lines in this process."""
    import io

    out = _Stamped()
    n = loop(stdin=io.StringIO("".join(f"{ln}\n" for ln in lines)), stdout=out, **kw)
    return n, out


def daemon_path(torch, np, in_dir, multi_models):
    """The stdin daemons in process, at batch DAEMON_BATCH: ``fast_st serve``
    (serve_loop) on DAEMON_REQUESTS requests of SIZE px and a few of
    DAEMON_SIZE2 px, STATS, a malformed line, RELOAD to a newer epoch, f32
    and bf16; then ``serve-multi`` from the multi-style training path's
    checkpoint with indices and blends mixed. Every request answers OK, the
    first DAEMON_CHECKED of each bucket lie within MAIN_TOL of the port's CPU
    forward. Returns (launches by daemon and precision, requests/s)."""
    from PIL import Image

    from styletransfer_tpu_torch import ckpt, constants
    from styletransfer_tpu_torch.engines import fast
    from styletransfer_tpu_torch.engines import multistyle as engine
    from styletransfer_tpu_torch.models import multistyle, transformer
    from styletransfer_tpu_torch.utils import images

    root = os.path.join(WORK, "daemon")
    models = os.path.join(root, "data", "models")
    for epoch in (0, 1):
        ckpt.save(transformer.init_params(seed=epoch, device="cpu"),
                  ckpt.checkpoint_path("fast_st", "smoke", epoch, models))
    names = sorted(os.listdir(in_dir))
    big = names[:4]
    saved_root = constants.PROJECT_ROOT_PATH
    constants.PROJECT_ROOT_PATH = root
    launches, rates = {}, {}
    try:
        for precision in ("f32", "bf16"):
            cd = torch.bfloat16 if precision == "bf16" else None
            epoch0 = transformer.params_from_jax(ckpt.load(ckpt.checkpoint_path(
                "fast_st", "smoke", 0, models)), device="cpu")
            lines = ([os.path.join(in_dir, n) for n in names[:DAEMON_REQUESTS]]
                     + [f"{os.path.join(in_dir, n)}\tbig_{precision}/{n}\t{DAEMON_SIZE2}"
                        for n in big]
                     + ["STATS", f"{in_dir}/img000.png\ta\tb\tc\td", "RELOAD",
                        f"{in_dir}/img000.png\tafter_{precision}.png"])
            reset_counts()
            n, out = _drive(fast.serve_loop, lines, style_name="smoke",
                            out_dir=f"fast_{precision}/", params=transformer.params_from_jax(
                                transformer.params_to_tree(epoch0), device="cuda"),
                            models_path=models, precision=precision,
                            batch_size=DAEMON_BATCH, sizes=[SIZE, DAEMON_SIZE2],
                            device="cuda")
            torch.cuda.synchronize()
            counts = read_counts()
            answers = out.lines[1:]
            served = len(lines) - 3
            ok = [a for a in answers if a.startswith("OK ") and a.endswith(".png")]
            stats = [a for a in answers if a.startswith("OK STATS")]
            check(out.lines[0] == "READY" and len(answers) == len(lines)
                  and len(ok) == served and "OK RELOAD epoch=1" in answers
                  and len(stats) == 1 and re.search(r"device_rtt_ms=[0-9.]+", stats[0])
                  and answers[-3].startswith(f"ERR {in_dir}/img000.png: expected "),
                  f"fast_st serve {precision}: READY, {served} OK, STATS with device_rtt_ms "
                  f"({stats}), ERR for a malformed line, OK RELOAD epoch=1, in request order")
            calls = counts["conv3x3_valid"] // 10
            up = UPCONV_PER_FORWARD[precision]
            check(calls >= 2 + served // DAEMON_BATCH and counts["conv3x3_valid"] == 10 * calls
                  and counts["instance_norm_pad"] == 15 * calls
                  and counts["upconv_phase"] == up * calls
                  and counts["conv9x9"] == CONV9X9_PER_FORWARD[precision] * calls,
                  f"fast_st serve {precision}: {calls} forwards (warm-ups included), 10 "
                  f"conv3x3, 15 IN-pad and {up} upconv_phase launches each")
            launches[("serve", precision)] = counts
            rates[("serve", precision)] = served / (out.last - out.ready)
            # Against the port's CPU forward: the first images of each bucket,
            # epoch 0 before RELOAD and epoch 1 after it.
            serve_cpu = fast.make_serve_fn(precision)
            epoch1, _ = ckpt.load_latest_transformer("fast_st", "smoke", models, device="cpu")
            checks = [(answers[i][3:], names[i], SIZE, epoch0) for i in range(DAEMON_CHECKED)]
            checks += [(answers[DAEMON_REQUESTS + i][3:], big[i], DAEMON_SIZE2, epoch0)
                       for i in range(DAEMON_CHECKED)]
            checks.append((answers[-1][3:], names[0], SIZE, epoch1))
            for path, name, size, params in checks:
                x = torch.from_numpy(np.array(images.load_image_uint8(
                    os.path.join(in_dir, name), size=size)))
                want = serve_cpu(params, x).numpy()[0]
                got = np.asarray(Image.open(path))
                _frames_checked(np, f"fast_st serve {precision} {size} px {name}: card vs CPU",
                                [got], [want], precision)
            print(f"fast_st serve {precision}: {served} requests at batch {DAEMON_BATCH} "
                  f"({DAEMON_REQUESTS} at {SIZE} px, {len(big)} at {DAEMON_SIZE2} px) at "
                  f"{rates[('serve', precision)]:.1f} requests/s after READY (incl. decode "
                  f"and PNG encode); {stats[0]}", flush=True)

        # serve-multi from the trained checkpoint (train-multi's f32 run).
        specs = ["0", "1", "2", "3", MULTI_BLEND, "0.25,0.25,0.25,0.25"]
        mlines = [f"{os.path.join(in_dir, n)}\t\t{specs[i % len(specs)]}"
                  for i, n in enumerate(names[:DAEMON_REQUESTS])]
        for precision in ("f32", "bf16"):
            reset_counts()
            n, out = _drive(engine.serve_loop, mlines, name="smoke_f32",
                            num_styles=TRAIN_STYLES, out_dir=f"multi_{precision}/",
                            models_path=multi_models, precision=precision,
                            batch_size=DAEMON_BATCH, device="cuda")
            torch.cuda.synchronize()
            counts = read_counts()
            answers = out.lines[1:]
            check(out.lines[0] == "READY" and len(answers) == len(mlines)
                  and all(a.startswith("OK ") for a in answers),
                  f"fast_st serve-multi {precision}: READY and {len(mlines)} OK, indices and "
                  f"blends mixed")
            calls = counts["conv3x3_valid"] // 10
            up = UPCONV_PER_FORWARD[precision]
            check(calls >= 1 + len(mlines) // DAEMON_BATCH
                  and counts["conv3x3_valid"] == 10 * calls
                  and counts["instance_norm_pad"] == 15 * calls
                  and counts["upconv_phase"] == up * calls
                  and counts["conv9x9"] == CONV9X9_PER_FORWARD[precision] * calls,
                  f"fast_st serve-multi {precision}: {calls} forwards, 10 conv3x3, 15 "
                  f"IN-pad and {up} upconv_phase launches each")
            launches[("serve_multi", precision)] = counts
            rates[("serve_multi", precision)] = len(mlines) / (out.last - out.ready)
            cpu_params = engine.load_params("smoke_f32", TRAIN_STYLES, multi_models, "cpu")
            cd = torch.bfloat16 if precision == "bf16" else None
            parse = engine._make_style_parser(TRAIN_STYLES)
            for i in range(DAEMON_CHECKED + 3):
                w, _ = parse(specs[i % len(specs)])
                x = images.maybe_normalize_on_device(torch.from_numpy(np.array(
                    images.load_image_uint8(os.path.join(in_dir, names[i])))))
                want = images.to_uint8_on_device(multistyle.apply_blend(
                    cpu_params, x, torch.from_numpy(w)[None], cd)).numpy()[0]
                got = np.asarray(Image.open(answers[i][3:]))
                _frames_checked(np, f"fast_st serve-multi {precision} style "
                                f"{specs[i % len(specs)]}: card vs CPU", [got], [want],
                                precision)
            print(f"fast_st serve-multi {precision}: {len(mlines)} requests at batch "
                  f"{DAEMON_BATCH}, {TRAIN_STYLES} styles by index and blend mixed, at "
                  f"{rates[('serve_multi', precision)]:.1f} requests/s after READY", flush=True)
    finally:
        constants.PROJECT_ROOT_PATH = saved_root
    return launches, rates


def multistyle_slice(torch, np, in_dir):
    """This slice's phases: multi-style training, its card-vs-CPU step, its
    step beside the single-style one, and the daemons. Returns (train-multi
    launches by precision, daemon launches, daemon requests/s)."""
    train, multi_models = multistyle_train_path(torch, np, in_dir)
    multistyle_parity(torch, np)
    multistyle_step_rates(torch, np)
    daemon_launches, daemon_rates = daemon_path(torch, np, in_dir, multi_models)
    return train, daemon_launches, daemon_rates


# The network transports and the other two daemons: fast_st serve over TCP
# and HTTP at DAEMON_BATCH (DAEMON_REQUESTS requests from NET_CLIENTS socket
# clients, HTTP_CLIENTS HTTP clients); video_st serve with STREAMS streams of
# STREAM_FRAMES frames, interleaved, at STREAM_BATCHES, one stream reset
# after RESET_AT of its frames; gatys_st --serve on GATYS_REQUESTS requests
# of GATYS_SIZE px (two styles and a blend), GATYS_SERVE_STEPS steps, H 16,
# at batch GATYS_REQUESTS and 1.
NET_CLIENTS = 2
HTTP_CLIENTS = 4
STREAMS = 4
STREAM_FRAMES = 12
STREAM_BATCHES = (4, 1)
RESET_AT = 6
GATYS_REQUESTS = 4
GATYS_SERVE_STEPS = 5
GATYS_SERVE_HISTORY = 16
# A lane of a Gatys group against the same request served alone: the loss of
# the first closure, the same computation summed in another order (the Gram's
# torch.bmm; in bf16 the activations round after those sums), within these
# relative distances. Later steps are not held: L-BFGS's compact history
# forms its products with torch.bmm, whose sums follow the number of lanes,
# and the trajectory carries such a difference on (on the CPU at 32 px the
# final losses of 5 steps end up to 4e-2 apart; tests/test_torch_gatys_serve.py
# holds lanes exactly with adam and the two-loop history). The spread of the
# final losses and PNGs is printed.
GATYS_LANE_FIRST_RTOL = {"f32": 1e-4, "bf16": 1e-2}
NET_TIMEOUT_S = 300


def _client_thread(fn, *args):
    """Run a client in a daemon thread; errors are kept for the check."""
    import threading

    box = {}

    def target():
        try:
            box["result"] = fn(*args)
        except BaseException as exc:  # noqa: BLE001 - reported by the caller
            box["error"] = exc
    th = threading.Thread(target=target, daemon=True)
    th.start()
    return th, box


def _joined(threads, label):
    for th, _ in threads:
        th.join(NET_TIMEOUT_S)
    errors = [repr(box.get("error")) for th, box in threads if th.is_alive() or "error" in box]
    check(not errors, f"{label}: every client ended without an error ({errors})")
    return [box["result"] for _, box in threads]


def _stopper(clients, stop):
    """After the clients end (or time out), make sure the daemon stops: a
    client that failed before its SHUTDOWN must not leave the engine loop,
    and with it this script, waiting for good."""
    def run():
        for th, _ in clients:
            th.join(NET_TIMEOUT_S)
        if not stop["done"]:
            stop["fn"]()
    return _client_thread(run)


def tcp_daemon(torch, np, in_dir, names, models, precision):
    """fast_st serve --tcp in process: the engine on this thread (every CUDA
    call stays here), NET_CLIENTS socket clients on threads, each pipelining
    its share of the requests. The first client says goodbye, the second
    SHUTDOWN. Returns (answers by client, the seconds from the first READY
    to the last answer, launch counts)."""
    import socket
    import threading

    from styletransfer_tpu_torch.engines import fast, netserve

    share = DAEMON_REQUESTS // NET_CLIENTS
    marks = {}
    goodbye = threading.Event()

    def connect(port):
        s = socket.create_connection(("127.0.0.1", port), timeout=NET_TIMEOUT_S)
        s.settimeout(NET_TIMEOUT_S)
        return s, s.makefile("r", encoding="utf-8")

    def client(k, port):
        s, r = connect(port)
        assert r.readline().strip() == "READY"
        marks.setdefault("ready", time.perf_counter())
        mine = names[k * share:(k + 1) * share]
        s.sendall("".join(f"{os.path.join(in_dir, n)}\ttcp_{precision}/{n}\n"
                          for n in mine).encode())
        answers = [r.readline().strip() for _ in mine]
        marks[k] = time.perf_counter()
        if k == 0:
            s.sendall(b"\n")
            answers.append(r.readline())  # the goodbye closes this connection: EOF
            goodbye.set()
        else:
            assert goodbye.wait(NET_TIMEOUT_S)
            s.sendall(b"SHUTDOWN\n")
            answers.append(r.readline().strip())
        s.close()
        return answers

    threads, stop = [], {"done": False}

    def on_listen(port):
        threads.extend(_client_thread(client, k, port) for k in range(NET_CLIENTS))
        stop["fn"] = lambda: connect(port)[0].sendall(b"SHUTDOWN\n")
        threads.append(_stopper(threads[:NET_CLIENTS], stop))

    out = _Stamped()
    reset_counts()
    try:
        n = netserve.serve_over_tcp(
            lambda i, o: fast.serve_loop("smoke", out_dir="unused/", models_path=models,
                                         size=SIZE, precision=precision,
                                         batch_size=DAEMON_BATCH, stdin=i, stdout=o,
                                         device="cuda"),
            stdout=out, name="smoke-tcp", _on_listen=on_listen)
    finally:
        stop["done"] = True
    torch.cuda.synchronize()
    counts = read_counts()
    answers = _joined(threads[:NET_CLIENTS], f"fast_st serve --tcp {precision}")
    check(n == DAEMON_REQUESTS and out.lines[0].startswith("TCP 127.0.0.1 ")
          and out.lines[1] == "READY",
          f"fast_st serve --tcp {precision}: 'TCP <host> <port>' and READY on stdout, "
          f"{n} requests served (want {DAEMON_REQUESTS})")
    return answers, max(marks[k] for k in range(NET_CLIENTS)) - marks["ready"], counts


def http_daemon(torch, np, in_dir, names, models, precision):
    """fast_st serve --http in process: HTTP_CLIENTS threads POST PNG bodies
    to /v1/stylize once /healthz answers 200; then /metrics (with the device
    RTT gauge) and POST /shutdown. Returns (PNG bodies in request order,
    seconds from READY to the last answer, launch counts)."""
    import urllib.error
    import urllib.request

    from styletransfer_tpu_torch.engines import fast, httpserve

    share = DAEMON_REQUESTS // HTTP_CLIENTS
    marks = {}

    def client(k, base):
        deadline = time.perf_counter() + NET_TIMEOUT_S
        while True:  # /healthz answers 503 until the engine printed READY
            try:
                with urllib.request.urlopen(base + "/healthz", timeout=NET_TIMEOUT_S) as r:
                    if r.status == 200:
                        break
            except urllib.error.HTTPError as e:
                assert e.code == 503 and time.perf_counter() < deadline
            time.sleep(0.01)
        marks.setdefault("ready", time.perf_counter())
        bodies = []
        for n in names[k * share:(k + 1) * share]:
            with open(os.path.join(in_dir, n), "rb") as f:
                req = urllib.request.Request(base + "/v1/stylize", data=f.read(), method="POST")
            with urllib.request.urlopen(req, timeout=NET_TIMEOUT_S) as r:
                assert r.status == 200 and r.headers["Content-Type"] == "image/png"
                bodies.append(r.read())
        marks[k] = time.perf_counter()
        return bodies

    def shutdown(base):
        with urllib.request.urlopen(urllib.request.Request(
                base + "/shutdown", data=b"", method="POST"), timeout=NET_TIMEOUT_S) as r:
            assert r.status == 200

    threads, stop = [], {"done": False}

    def on_listen(port):
        base = f"http://127.0.0.1:{port}"
        threads.extend(_client_thread(client, k, base) for k in range(HTTP_CLIENTS))

        def metrics_then_shutdown():
            for th, _ in threads[:HTTP_CLIENTS]:
                th.join(NET_TIMEOUT_S)
            try:
                with urllib.request.urlopen(base + "/metrics", timeout=NET_TIMEOUT_S) as r:
                    return r.read().decode()
            finally:
                shutdown(base)
        threads.append(_client_thread(metrics_then_shutdown))
        stop["fn"] = lambda: shutdown(base)
        threads.append(_stopper(threads[:HTTP_CLIENTS + 1], stop))

    out = _Stamped()
    reset_counts()
    try:
        n = httpserve.serve_over_http(
            lambda i, o: fast.serve_loop("smoke", out_dir="unused/", models_path=models,
                                         size=SIZE, precision=precision,
                                         batch_size=DAEMON_BATCH, stdin=i, stdout=o,
                                         device="cuda"),
            kind="fast", stdout=out, name="smoke-http", _on_listen=on_listen)
    finally:
        stop["done"] = True
    torch.cuda.synchronize()
    counts = read_counts()
    results = _joined(threads[:HTTP_CLIENTS + 1], f"fast_st serve --http {precision}")
    metrics = results[-1]
    rtt = re.search(r'styletransfer_device_rtt_seconds\{daemon="smoke-http"\} ([0-9.]+)',
                    metrics)
    check(n == DAEMON_REQUESTS and out.lines[0].startswith("HTTP 127.0.0.1 ")
          and out.lines[1] == "READY" and rtt is not None
          and f'outcome="ok"}} {DAEMON_REQUESTS}' in metrics,
          f"fast_st serve --http {precision}: {n} requests served, /healthz opened at READY, "
          f"/metrics with {DAEMON_REQUESTS} ok and the device RTT gauge "
          f"({rtt.group(1) if rtt else None} s)")
    bodies = [b for r in results[:-1] for b in r]
    return bodies, max(marks[k] for k in range(HTTP_CLIENTS)) - marks["ready"], counts


def transport_path(torch, np, in_dir):
    """fast_st serve over TCP and HTTP at batch DAEMON_BATCH, f32 and bf16,
    beside the stdin daemon on the same requests in the same run: every
    answer OK, the first DAEMON_CHECKED within MAIN_TOL of the port's CPU
    forward, 10 conv3x3 and 15 IN-pad launches per forward. Returns
    (launches by (transport, precision), requests/s)."""
    import io as io_mod

    from PIL import Image

    from styletransfer_tpu_torch import ckpt, constants
    from styletransfer_tpu_torch.engines import fast
    from styletransfer_tpu_torch.models import transformer
    from styletransfer_tpu_torch.utils import images

    root = os.path.join(WORK, "net")
    models = os.path.join(root, "data", "models")
    ckpt.save(transformer.init_params(seed=7, device="cpu"),
              ckpt.checkpoint_path("fast_st", "smoke", 0, models))
    cpu_params, _ = ckpt.load_latest_transformer("fast_st", "smoke", models, device="cpu")
    names = sorted(os.listdir(in_dir))[:DAEMON_REQUESTS]
    saved_root = constants.PROJECT_ROOT_PATH
    constants.PROJECT_ROOT_PATH = root
    launches, rates = {}, {}
    try:
        for precision in ("f32", "bf16"):
            serve_cpu = fast.make_serve_fn(precision)
            want = {n: serve_cpu(cpu_params, torch.from_numpy(np.array(images.load_image_uint8(
                os.path.join(in_dir, n), size=SIZE)))).numpy()[0]
                for n in names[:DAEMON_CHECKED]}
            for transport in ("stdin", "tcp", "http"):
                if transport == "stdin":
                    lines = [f"{os.path.join(in_dir, n)}\tstdin_{precision}/{n}" for n in names]
                    reset_counts()
                    _, out = _drive(fast.serve_loop, lines, style_name="smoke",
                                    out_dir="unused/", models_path=models, size=SIZE,
                                    precision=precision, batch_size=DAEMON_BATCH, device="cuda")
                    torch.cuda.synchronize()
                    counts = read_counts()
                    answers, seconds = out.lines[1:], out.last - out.ready
                    ok = answers == [f"OK {root}/stdin_{precision}/{n}" for n in names]
                    got = {n: np.asarray(Image.open(f"{root}/stdin_{precision}/{n}"))
                           for n in names[:DAEMON_CHECKED]}
                elif transport == "tcp":
                    answers, seconds, counts = tcp_daemon(torch, np, in_dir, names, models,
                                                          precision)
                    share = DAEMON_REQUESTS // NET_CLIENTS
                    ok = all(a[:share] == [f"OK {root}/tcp_{precision}/{n}" for n in
                                           names[k * share:(k + 1) * share]]
                             for k, a in enumerate(answers))
                    ok = ok and answers[0][-1] == "" and answers[1][-1] == "OK SHUTDOWN"
                    got = {n: np.asarray(Image.open(f"{root}/tcp_{precision}/{n}"))
                           for n in names[:DAEMON_CHECKED]}
                else:
                    bodies, seconds, counts = http_daemon(torch, np, in_dir, names, models,
                                                          precision)
                    ok = len(bodies) == DAEMON_REQUESTS
                    got = {n: np.asarray(Image.open(io_mod.BytesIO(b)))
                           for n, b in zip(names[:DAEMON_CHECKED], bodies)}
                check(ok, f"fast_st serve {transport} {precision}: {DAEMON_REQUESTS} answers, "
                      f"each OK with its own output, in each client's order"
                      + (" (then EOF after the goodbye, OK SHUTDOWN)" if transport == "tcp"
                         else ""))
                calls = counts["conv3x3_valid"] // 10
                up = UPCONV_PER_FORWARD[precision]
                check(calls >= 2 + DAEMON_REQUESTS // DAEMON_BATCH - 1
                      and counts["conv3x3_valid"] == 10 * calls
                      and counts["instance_norm_pad"] == 15 * calls
                      and counts["upconv_phase"] == up * calls
                      and counts["conv9x9"] == CONV9X9_PER_FORWARD[precision] * calls,
                      f"fast_st serve {transport} {precision}: {calls} forwards (the warm-up "
                      f"included), 10 conv3x3, 15 IN-pad and {up} upconv_phase launches each")
                for n in names[:DAEMON_CHECKED]:
                    _frames_checked(np, f"fast_st serve {transport} {precision} {n}: card vs "
                                    "CPU", [got[n]], [want[n]], precision)
                launches[(transport, precision)] = counts
                rates[(transport, precision)] = DAEMON_REQUESTS / seconds
            print(f"fast_st serve {precision} at batch {DAEMON_BATCH}, {DAEMON_REQUESTS} "
                  f"requests of {SIZE} px, requests/s after READY: stdin "
                  f"{rates[('stdin', precision)]:.1f}, tcp ({NET_CLIENTS} clients) "
                  f"{rates[('tcp', precision)]:.1f}, http ({HTTP_CLIENTS} clients) "
                  f"{rates[('http', precision)]:.1f}", flush=True)
    finally:
        constants.PROJECT_ROOT_PATH = saved_root
    return launches, rates


def stream_daemon_path(torch, np, F, in_dir):
    """video_st serve in process, f32 and bf16, reflect and zeros, at each of
    STREAM_BATCHES: STREAMS streams of STREAM_FRAMES frames interleaved, one
    of them reset after RESET_AT frames. Every stream's PNGs are exactly
    (0/255) stylize_clip of its frames on the card; per forward 6
    conv_direct and the forward's kernels, no cuDNN conv. Returns (launches
    by (pad mode, precision, batch), frames/s)."""
    from PIL import Image

    from styletransfer_tpu_torch import ckpt, constants
    from styletransfer_tpu_torch.engines import video
    from styletransfer_tpu_torch.models import transformer
    from styletransfer_tpu_torch.utils import images

    root = os.path.join(WORK, "stream")
    models = os.path.join(root, "data", "models")
    ckpt.save(transformer.init_video_params(seed=9, device="cpu"),
              ckpt.checkpoint_path("video_st", "smoke", 0, models))
    params, _ = ckpt.load_latest_transformer("video_st", "smoke", models, device="cuda")
    names = sorted(os.listdir(in_dir))
    frames = {(s, t): names[s * STREAM_FRAMES + t]
              for s in range(STREAMS) for t in range(STREAM_FRAMES)}
    order = [(s, t) for t in range(STREAM_FRAMES) for s in range(STREAMS)]
    lines = []
    for s, t in order:
        if (s, t) == (STREAMS - 1, RESET_AT):
            lines.append(f"RESET\t\tcam{s}")
        lines.append(f"{os.path.join(in_dir, frames[(s, t)])}\tOUT/cam{s}_{t}.png\tcam{s}")
    library_conv, conv_calls = F.conv2d, [0]

    def counting_conv2d(*args, **kwargs):
        conv_calls[0] += 1
        return library_conv(*args, **kwargs)

    launches, rates = {}, {}
    saved_root = constants.PROJECT_ROOT_PATH
    constants.PROJECT_ROOT_PATH = root
    F.conv2d = counting_conv2d
    try:
        for pad_mode in ("reflect", "zeros"):
            for precision in ("f32", "bf16"):
                # The streams as clips, stylized whole on the card.
                refs = {}
                for s in range(STREAMS):
                    cuts = ([(0, RESET_AT), (RESET_AT, STREAM_FRAMES)] if s == STREAMS - 1
                            else [(0, STREAM_FRAMES)])
                    for a, b in cuts:
                        clip = np.stack([images.load_image_uint8(os.path.join(
                            in_dir, frames[(s, t)]), size=SIZE)[0] for t in range(a, b)])
                        outs = video.stylize_clip(params, clip, precision, pad_mode)
                        u8 = images.to_uint8_on_device(torch.from_numpy(outs).cuda()).cpu()
                        for t in range(a, b):
                            refs[(s, t)] = u8[t - a].numpy()
                for batch in STREAM_BATCHES:
                    tag = f"{precision} {pad_mode} b{batch}"
                    out_tag = f"{precision}_{pad_mode}_b{batch}"
                    reset_counts()
                    conv_calls[0] = 0
                    n, out = _drive(video.serve_stream_loop,
                                    [ln.replace("OUT/", f"{out_tag}/") for ln in lines],
                                    style_name="smoke", out_dir="unused/", models_path=models,
                                    size=SIZE, precision=precision, pad_mode=pad_mode,
                                    batch_size=batch, device="cuda")
                    torch.cuda.synchronize()
                    counts = read_counts()
                    answers = out.lines[1:]
                    check(out.lines[0] == "READY" and len(answers) == len(lines)
                          and f"OK RESET cam{STREAMS - 1}" in answers
                          and sum(a.startswith("OK ") and a.endswith(".png") for a in answers)
                          == len(order),
                          f"video_st serve {tag}: READY, {len(order)} frames OK and OK RESET, "
                          "in request order")
                    gaps = {}
                    for s, t in order:
                        got = np.asarray(Image.open(os.path.join(root, out_tag,
                                                                 f"cam{s}_{t}.png")))
                        gaps[(s, t)] = int(np.abs(got.astype(np.int32)
                                                  - refs[(s, t)].astype(np.int32)).max())
                    check(max(gaps.values()) == 0,
                          f"video_st serve {tag}: every stream's {STREAM_FRAMES} frames exactly "
                          f"stylize_clip of its frames on the card (max "
                          f"{max(gaps.values())}/255; frames off: "
                          f"{[k for k, g in gaps.items() if g]})")
                    forwards = counts["conv_direct"] // 6
                    route = "f32_fma" if precision == "f32" else "bf16_wgmma"
                    per = ({"conv_direct": 6, **ZEROS_PER_FORWARD} if pad_mode == "zeros" else
                           {"conv_direct": 6, "conv3x3_valid": 10,
                            f"conv3x3_valid.{route}": 10, "instance_norm_pad": 15})
                    want = {k: per.get(k, 0) * forwards for k in counts}
                    warm = 1 if batch == 1 else 2
                    waves = forwards - warm
                    check(counts == want and conv_calls[0] == 0
                          and len(order) / batch <= waves <= len(order),
                          f"video_st serve {tag}: {forwards} forwards ({warm} warm-up, {waves} "
                          f"waves for {len(order)} frames), each 6 conv_direct and {per}, no "
                          f"cuDNN conv ({conv_calls[0]})")
                    launches[(pad_mode, precision, batch)] = counts
                    rates[(pad_mode, precision, batch)] = len(order) / (out.last - out.ready)
                    print(f"video_st serve {tag}: {len(order)} frames of {STREAMS} streams in "
                          f"{waves} waves at {rates[(pad_mode, precision, batch)]:.1f} "
                          "frames/s after READY (incl. PNG decode and encode)", flush=True)
    finally:
        F.conv2d = library_conv
        constants.PROJECT_ROOT_PATH = saved_root
    return launches, rates


def gatys_daemon_path(torch, np, F, optimizer="lbfgs"):
    """gatys_st --serve in process at GATYS_SIZE px, GATYS_SERVE_STEPS steps of
    ``optimizer`` (L-BFGS with H GATYS_SERVE_HISTORY, or lbfgs-zoom with its
    memory of 10), f32 and bf16: GATYS_REQUESTS requests
    mixing two styles and a blend, at batch GATYS_REQUESTS (one group) and at
    batch 1 (each alone). Every answer OK with a finite loss; each lane's
    first closure within GATYS_LANE_FIRST_RTOL of the request alone; per
    closure 1 conv3x3_im2col and 9 conv3x3_flat, no cuDNN conv. Returns
    (launches by (precision, batch), seconds per request)."""
    from PIL import Image

    from styletransfer_tpu_torch.engines import gatys
    from styletransfer_tpu_torch.models import vgg
    from styletransfer_tpu_torch.utils import images

    root = os.path.join(WORK, f"gatys_serve_{optimizer}")
    os.makedirs(root)
    paths = {}
    for k, seed in (("c0", 30_000), ("c1", 30_001), ("c2", 30_002), ("c3", 30_003),
                    ("s0", 30_100), ("s1", 30_101)):
        paths[k] = os.path.join(root, f"{k}.png")
        _save_png(np, paths[k], seed)
    styles = [paths["s0"], paths["s1"], f"{paths['s0']},{paths['s1']}:0.3,0.7", paths["s1"]]
    lines = [f"{paths[f'c{i}']}\t{styles[i]}" for i in range(GATYS_REQUESTS)]
    vgg_params = vgg.init_params(0, device="cuda")
    library_conv, conv_calls = F.conv2d, [0]

    def counting_conv2d(*args, **kwargs):
        conv_calls[0] += 1
        return library_conv(*args, **kwargs)

    groups = []
    real_batched = gatys._run_serve_batched

    def recorded(*args, **kwargs):
        groups.append(args[1].shape[0])
        return real_batched(*args, **kwargs)

    memory = f"H {GATYS_SERVE_HISTORY}" if optimizer == "lbfgs" else "memory 10"
    launches, seconds = {}, {}
    F.conv2d = counting_conv2d
    gatys._run_serve_batched = recorded
    try:
        for precision in ("f32", "bf16"):
            finals = {}
            for batch in (GATYS_REQUESTS, 1):
                tag = f"{optimizer} {precision} b{batch}"
                reset_counts()
                gatys.closure_evals = 0
                conv_calls[0] = 0
                groups.clear()
                n, out = _drive(gatys.serve_loop, lines, steps=GATYS_SERVE_STEPS,
                                optimizer=optimizer, history_size=GATYS_SERVE_HISTORY,
                                precision=precision,
                                size=GATYS_SIZE, out_dir=os.path.join(root, f"{precision}_b{batch}"),
                                batch=batch, vgg_params=vgg_params, device="cuda")
                torch.cuda.synchronize()
                counts, evals = read_counts(), gatys.closure_evals
                answers = out.lines[1:]
                losses = [float(a.rsplit("loss=", 1)[1]) for a in answers if " loss=" in a]
                check(out.lines[0] == "READY" and n == GATYS_REQUESTS
                      and len(losses) == GATYS_REQUESTS
                      and all(a.startswith("OK ") for a in answers)
                      and all(math.isfinite(v) for v in losses)
                      and all(os.path.isfile(a.split(" ")[1]) for a in answers),
                      f"gatys_st --serve {tag}: READY, {GATYS_REQUESTS} answers OK with finite "
                      f"losses {losses}, PNGs written")
                finals[batch] = (losses, [a.split(" ")[1] for a in answers])
                # Closures, the content targets of each optimization (the warm-ups'
                # too) and the VGG passes of the Gram targets (the warm-up's zeros
                # and each distinct style; the blend reuses both). A group of
                # lanes is one optimization, a lone lane is one too.
                lanes_batched = sum(groups[1:])
                optimizations = 1 + len(groups) + (GATYS_REQUESTS - lanes_batched)
                gram_passes = 1 + 2
                want = {k: 0 for k in counts}
                want["conv3x3_im2col"] = evals + optimizations + gram_passes
                want["conv3x3_flat"] = 9 * evals + 3 * optimizations + 4 * gram_passes
                check(evals > 0 and counts == want and conv_calls[0] == 0,
                      f"gatys_st --serve {tag}: {evals} closures, {counts['conv3x3_im2col']} "
                      f"conv3x3_im2col and {counts['conv3x3_flat']} conv3x3_flat launches (1 and "
                      f"9 per closure, 1 + 3 per optimization's content target, 1 + 4 per Gram "
                      f"pass), no cuDNN conv ({conv_calls[0]})")
                launches[(precision, batch)] = counts
                seconds[(precision, batch)] = (out.last - out.ready) / GATYS_REQUESTS
                print(f"gatys_st --serve {tag}: {GATYS_REQUESTS} requests of {GATYS_SIZE} px "
                      f"(groups of lanes after the warm-up: {groups[1:]}), "
                      f"{GATYS_SERVE_STEPS} steps, {memory}, {evals} closures in "
                      f"{out.last - out.ready:.3f} s = {seconds[(precision, batch)]:.3f} s per "
                      f"request after READY", flush=True)
            (grouped, grouped_png), (alone, alone_png) = finals[GATYS_REQUESTS], finals[1]
            rel = [abs(a - b) / abs(b) for a, b in zip(grouped, alone)]
            gaps = [int(np.abs(np.asarray(Image.open(a), np.int32)
                               - np.asarray(Image.open(b), np.int32)).max())
                    for a, b in zip(grouped_png, alone_png)]
            # The same four requests as one group of lanes and each alone,
            # through the daemon's optimizations: every lane's first closure.
            cd = torch.bfloat16 if precision == "bf16" else None
            contents = torch.cat([torch.from_numpy(images.load_image(
                paths[f"c{i}"], size=GATYS_SIZE)).cuda() for i in range(GATYS_REQUESTS)])
            grams = {k: vgg.style_gram_targets(vgg_params, torch.from_numpy(
                images.load_image(paths[k], size=GATYS_SIZE)).cuda()) for k in ("s0", "s1")}
            targets = [grams["s0"], grams["s1"],
                       gatys.blend_grams([grams["s0"], grams["s1"]], [0.3, 0.7]), grams["s1"]]
            kw = dict(compute_dtype=cd, history_size=GATYS_SERVE_HISTORY)
            _, lanes = real_batched(vgg_params, contents, {k: torch.cat([t[k] for t in targets])
                                                           for k in grams["s0"]},
                                    1, 1e5, 1.0, 0.05, optimizer, **kw)
            first = [abs(float(lanes[i, 0]) - float(gatys._run_optimizer(
                optimizer, vgg_params, contents[i:i + 1], targets[i], 1, 1e5, 1.0, **kw)[1][0]))
                / float(lanes[i, 0]) for i in range(GATYS_REQUESTS)]
            check(max(first) <= GATYS_LANE_FIRST_RTOL[precision],
                  f"gatys_st --serve {optimizer} {precision}: each lane of a group of "
                  f"{GATYS_REQUESTS} against "
                  f"the request alone: first closure's loss {[f'{r:.2e}' for r in first]} apart "
                  f"(limit {GATYS_LANE_FIRST_RTOL[precision]}); after {GATYS_SERVE_STEPS} steps "
                  f"(not held) the daemon's final losses {[f'{r:.2e}' for r in rel]} apart, "
                  f"PNGs max {gaps}/255")
    finally:
        F.conv2d = library_conv
        gatys._run_serve_batched = real_batched
    return launches, seconds


def network_slice(torch, np, F, in_dir):
    """The network transports and the video and Gatys daemons (also alone
    with ``--serve``). Returns (launches by daemon, rates by daemon)."""
    transport_launches, transport_rates = transport_path(torch, np, in_dir)
    stream_launches, stream_rates = stream_daemon_path(torch, np, F, in_dir)
    gatys_launches, gatys_seconds = gatys_daemon_path(torch, np, F)
    return ({"transports": transport_launches, "video_serve": stream_launches,
             "gatys_serve": gatys_launches},
            {"transports": transport_rates, "video_serve": stream_rates,
             "gatys_serve": gatys_seconds})


# --- The multi-GPU slice: data-parallel training over torch.distributed and
# the serving paths' placement over a device list (also alone with
# --parallel). It needs one GPU: NCCL runs at world size 1 (it refuses two
# ranks on one GPU), and two ranks share cuda:0 over gloo, which takes CUDA
# tensors.

PARALLEL_RANKS = 2
PARALLEL_STEPS = 4  # static_train steps in each distributed run
PARALLEL_TIMED = 5  # timed steps per rank and precision
PARALLEL_TIMEOUT_S = 420  # the ranks are killed after this
# train_loop timed in an NCCL group of one and without a group, in turns:
# steps per run, of which the first LOOP_SKIP (the eval, the preview) are
# not timed.
LOOP_STEPS = 24
LOOP_SKIP = 2
# A rank's step on its 2 images against one process's on all 4, card vs card:
# the losses (relative) and, in f32, every gradient (relative L2, the limit
# phase 6 holds the card to against the CPU).
PARALLEL_LOSS_RTOL = 1e-5
PARALLEL_GRAD_REL_L2 = 1e-3
PER_RANK_STEP = {"fused_instance_norm_fwd": NORMS_PER_FORWARD,
                 "fused_instance_norm_bwd": NORMS_PER_FORWARD, **VGG_PER_STEP}
PLACEMENT_DEVICES = ["cuda:0", "cuda:0"]
PAR_VIDEO_FRAMES = 8  # frames per clip of the distributed video runs
PAR_VIDEO_CHUNK = 4
PAR_CLIPS = (6, 9, 4)  # convert-dir clips over the placement, one ragged group of 3
PAR_CLIP_BATCH = 4  # divides over the two slots: the group of 3 splits 2 + 1
PAR_SERVE_REQUESTS = 16
MULTI_PAR_STEPS = 3


def _parallel_batch(np):
    """The global batch of the two-rank step: 4 seeded 256 px images."""
    from styletransfer_tpu_torch.data import coco
    from styletransfer_tpu_torch.utils import images

    return np.stack([images.normalize(coco.synthetic_image(30_000 + i, SIZE))
                     for i in range(TRAIN_BATCH)]).astype(np.float32)


def _step_ms(torch, step, params, opt, x) -> float:
    """Host ms per train step over PARALLEL_TIMED steps after 2 warm-ups,
    ending in a synchronize."""
    for _ in range(2):
        step(params, opt, x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PARALLEL_TIMED):
        metrics = step(params, opt, x)
    float(metrics["total"])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / PARALLEL_TIMED


def _flat_params(torch, params):
    return torch.cat([p.detach().reshape(-1).float() for p in params.parameters()]).cpu().numpy()


def _sharded_coco(rank, world):
    from styletransfer_tpu_torch.data import coco

    return coco.get_coco_loader(batch_size=TRAIN_BATCH // world, test_limit=8,
                                image_dir=os.path.join(WORK, "no_images"), shard_index=rank,
                                shard_count=world)


def rank_worker(torch, np, out_dir, in_dir) -> int:
    """One of the PARALLEL_RANKS ranks (gloo, sharing cuda:0): per precision,
    one step on its 2 images of the global batch (launches, gradients,
    parameters, ms per step), static_train over the group and its checkpoint
    through process_dir; then train-multi, and video_st training whole, cut
    after a mid-batch step state and resumed from the sidecars (cuDNN
    deterministic). Writes rank{r}.json and rank{r}.npz to ``out_dir``."""
    from styletransfer_tpu_torch import ckpt
    from styletransfer_tpu_torch.data import video as video_data
    from styletransfer_tpu_torch.engines import fast, multistyle, video
    from styletransfer_tpu_torch.models import multistyle as ms_model
    from styletransfer_tpu_torch.models import transformer, vgg
    from styletransfer_tpu_torch.ops import layers
    from styletransfer_tpu_torch.parallel import distributed
    from styletransfer_tpu_torch.utils.logging import get_logger

    rank, world = distributed.initialize(device="cuda", backend="gloo")
    layers.disable_tf32()
    res, arrays = {"rank": rank, "world": world}, {}
    style = _style_image(np)
    vgg_params = vgg.init_params(seed=0, device="cuda")
    grams = vgg.style_gram_targets(vgg_params, torch.from_numpy(style).cuda())
    local = TRAIN_BATCH // world
    x = torch.from_numpy(_parallel_batch(np)[rank * local:(rank + 1) * local]).cuda()
    shards = distributed.global_batch()
    for precision in ("f32", "bf16"):
        cd = torch.bfloat16 if precision == "bf16" else None
        step = fast.make_train_step(vgg_params, grams, compute_dtype=cd, shards=shards)
        params = transformer.init_params(seed=1, device="cuda")
        opt = fast.make_optimizer(params)
        reset_counts()
        metrics = step(params, opt, x)
        torch.cuda.synchronize()
        res[f"{precision}.launches"] = read_counts()
        res[f"{precision}.metrics"] = {k: float(v) for k, v in metrics.items()}
        for n, p in params.named_parameters():
            arrays[f"{precision}.grad.{n}"] = p.grad.cpu().numpy()
        arrays[f"{precision}.params"] = _flat_params(torch, params)
        res[f"{precision}.ms"] = _step_ms(torch, step, params, opt, x)

        models = os.path.join(out_dir, f"models_{precision}")
        test_loader, train_loader = _sharded_coco(rank, world)
        log = _LossLog()
        get_logger().addHandler(log)
        try:
            trained = fast.static_train(
                style, style_name="smoke", epochs=1, batch_size=TRAIN_BATCH,
                vgg_params=vgg_params, params=transformer.init_params(seed=0, device="cuda"),
                train_loader=train_loader, test_loader=test_loader, log_cadence=(1, 100, 2),
                runs_dir=os.path.join(out_dir, f"runs_{precision}_{rank}"), models_path=models,
                max_steps_per_epoch=PARALLEL_STEPS, step_checkpoint_every=2,
                precision=precision, device="cuda")
        finally:
            get_logger().removeHandler(log)
        res[f"{precision}.train_losses"], res[f"{precision}.test_losses"] = log.train, log.test
        arrays[f"{precision}.trained"] = _flat_params(torch, trained)
        reset_counts()
        paths = fast.process_dir(in_dir, "smoke", out_dir=os.path.join(out_dir, f"styl_{rank}"),
                                 batch_size=BATCH, models_path=models, precision=precision,
                                 device="cuda")
        served = read_counts()
        res[f"{precision}.served"] = [len(paths), served["conv3x3_valid"],
                                      served["instance_norm_pad"]]

    test_loader, train_loader = _sharded_coco(rank, world)
    log = _LossLog()
    get_logger().addHandler(log)
    try:
        multi = multistyle.train(
            _style_stack(np), style_name="smoke", epochs=1, batch_size=TRAIN_BATCH,
            vgg_params=vgg_params, params=ms_model.init_params(0, TRAIN_STYLES, device="cuda"),
            train_loader=train_loader, test_loader=test_loader, log_cadence=(1, 100, 100),
            runs_dir=os.path.join(out_dir, f"runs_multi_{rank}"),
            models_path=os.path.join(out_dir, "models_multi"),
            max_steps_per_epoch=MULTI_PAR_STEPS, device="cuda")
    finally:
        get_logger().removeHandler(log)
    res["multi.losses"] = log.train
    arrays["multi.trained"] = _flat_params(torch, multi)

    steps = []
    real_step = video.make_scan_train_step

    def counting(*a, **kw):
        opt, scan = real_step(*a, **kw)
        return opt, lambda *s: steps.append(int(np.sum(s[3]))) or scan(*s)

    class Stop(Exception):
        pass

    def video_run(name, stop_at=None):
        save = ckpt.save_step_state

        def save_then_stop(*args, **kw):
            path = save(*args, **kw)
            if args[3] == stop_at:
                raise Stop
            return path

        del steps[:]
        ckpt.save_step_state = save_then_stop
        video.make_scan_train_step = counting
        log = _VideoLossLog()
        get_logger().addHandler(log)
        try:
            loader = video_data.VideoDataset(
                video_dir=os.path.join(WORK, "no_videos"), batch_size=1,
                synthetic_count=2 * world, shard_index=rank, shard_count=world)
            params = video.video_train(
                style, style_name="smoke", epochs=1, batch_size=world, vgg_params=vgg_params,
                params=transformer.init_video_params(seed=0, device="cuda"),
                video_loader=loader, chunk_size=PAR_VIDEO_CHUNK, max_frames=PAR_VIDEO_FRAMES,
                runs_dir=os.path.join(out_dir, f"runs_video_{rank}"),
                models_path=os.path.join(out_dir, name),
                step_checkpoint_every=PAR_VIDEO_CHUNK, device="cuda")
            return _flat_params(torch, params), list(steps), log.train
        except Stop:
            return None, list(steps), log.train
        finally:
            ckpt.save_step_state = save
            video.make_scan_train_step = real_step
            get_logger().removeHandler(log)

    # Deterministic cuDNN algorithms, so that the resumed run can be held to
    # the whole run bit for bit.
    torch.backends.cudnn.deterministic = True
    arrays["video.whole"], res["video.whole_steps"], res["video.losses"] = video_run("video")
    _, res["video.cut_steps"], _ = video_run("video_cut", stop_at=PAR_VIDEO_CHUNK)
    res["video.sidecar"] = os.path.isfile(ckpt.carry_shard_path(
        "video_st", "smoke", os.path.join(out_dir, "video_cut")))
    arrays["video.resumed"], res["video.resumed_steps"], res["video.resumed_losses"] = \
        video_run("video_cut")
    res["train_graphs"] = list(graph_counts())
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    distributed.shutdown()
    return 0


def nccl_phase(torch, np, card):
    """NCCL at world size 1: static_train's losses for PARALLEL_STEPS steps
    at batch 4, f32 and bf16, in a group of one (initialize's real init;
    every step's all-reduce runs on NCCL, the lockstep gathers and the
    eval's mean on its gloo side group) and then without a group, after an
    untimed warm-up run; then train_loop's ms per step in a group of one and
    without a group, in turns (_loop_step_ms). One
    rank's all-reduce is a copy: the losses are expected bit for bit. cuDNN
    runs its deterministic algorithms here: its default f32 backward left
    two runs without a group 3.8e-05 apart after 4 steps (Adam turns
    rounding-noise gradients into steps of +-lr), a gap that says nothing of
    the group; the run-to-run gap is printed beside the group's."""
    from styletransfer_tpu_torch.data import coco
    from styletransfer_tpu_torch.engines import fast
    from styletransfer_tpu_torch.models import transformer, vgg
    from styletransfer_tpu_torch.parallel import distributed
    from styletransfer_tpu_torch.utils.logging import get_logger

    style = _style_image(np)
    vgg_params = vgg.init_params(seed=0, device="cuda")
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for label, grouped in (("warm-up", False), ("group", True), ("alone", False)):
        if grouped:
            t0 = time.perf_counter()
            rank, world = distributed.initialize(f"127.0.0.1:{distributed.free_port()}", 1, 0,
                                                 device="cuda")
            import torch.distributed as dist

            check((rank, world) == (0, 1) and dist.get_backend() == "nccl",
                  f"nccl: initialize formed a group of {world} on {dist.get_backend()} in "
                  f"{time.perf_counter() - t0:.2f} s")
        try:
            for precision in ("f32", "bf16"):
                test_loader, train_loader = coco.get_coco_loader(
                    batch_size=TRAIN_BATCH, test_limit=8,
                    image_dir=os.path.join(WORK, "no_images"))
                log = _LossLog()
                get_logger().addHandler(log)
                before = graph_counts()
                t0 = time.perf_counter()
                try:
                    fast.static_train(
                        style, style_name="nccl", epochs=1, batch_size=TRAIN_BATCH,
                        vgg_params=vgg_params,
                        params=transformer.init_params(seed=0, device="cuda"),
                        train_loader=train_loader, test_loader=test_loader,
                        log_cadence=(1, 100, 2),
                        runs_dir=os.path.join(WORK, f"runs_nccl_{label}_{precision}"),
                        models_path=os.path.join(WORK, f"models_nccl_{label}_{precision}"),
                        max_steps_per_epoch=PARALLEL_STEPS, precision=precision,
                        device="cuda")
                    torch.cuda.synchronize()
                finally:
                    get_logger().removeHandler(log)
                runs[(label, precision)] = (log.train + log.test, time.perf_counter() - t0)
                graphs = graphed_since(before)
                want = (0, 0) if grouped else (1, PARALLEL_STEPS)
                print(f"nccl {label} {precision}: training graphs {graphs[0]} captured, "
                      f"{graphs[1]} replays in {PARALLEL_STEPS} steps", flush=True)
                check(graphs == want,
                      f"nccl {label} {precision}: {graphs[0]} training graphs captured and "
                      f"{graphs[1]} replays (want {want}: none in a group, whose step holds "
                      f"its all-reduce, one graph for every step without)")
            if grouped:
                # Steady steps at batch 4 with the step's all-reduce (a
                # group of one) and without it, in turns.
                grams = vgg.style_gram_targets(vgg_params, torch.from_numpy(style).cuda())
                x = torch.from_numpy(_parallel_batch(np)).cuda()
                for precision in ("f32", "bf16"):
                    cd = torch.bfloat16 if precision == "bf16" else None
                    ms = {}
                    for label2, shards in (("with", distributed.global_batch()), ("without", None),
                                           ("with again", distributed.global_batch())):
                        step = fast.make_train_step(vgg_params, grams, compute_dtype=cd,
                                                    shards=shards)
                        params = transformer.init_params(seed=1, device="cuda")
                        ms[label2] = _step_ms(torch, step, params, fast.make_optimizer(params), x)
                    print(f"nccl {precision}: steady train step at batch {TRAIN_BATCH} with the "
                          f"all-reduce of a group of one {ms['with']:.2f} / "
                          f"{ms['with again']:.2f} ms, without {ms['without']:.2f} ms (cuDNN "
                          f"deterministic), on {card}",
                          flush=True)
        finally:
            if grouped:
                distributed.shutdown()
    torch.backends.cudnn.deterministic = deterministic
    for precision in ("f32", "bf16"):
        ms = {label: [] for label in ("group", "alone")}
        for label in ("group", "alone", "group", "alone"):
            ms[label].append(_loop_step_ms(torch, np, style, vgg_params, precision,
                                           label == "group"))
        print(f"nccl {precision}: train_loop at batch {TRAIN_BATCH}, steps {LOOP_SKIP}-"
              f"{LOOP_STEPS - 1} on batches held in memory (lockstep, the prefetch and the "
              f"step), in turns: "
              f"{' / '.join(f'{t:.2f}' for t in ms['group'])} ms per step in a group of one "
              f"(control collectives on gloo, the step's all-reduce on NCCL), "
              f"{' / '.join(f'{t:.2f}' for t in ms['alone'])} without a group, on {card}",
              flush=True)
    for precision in ("f32", "bf16"):
        (alone, t_alone), (group, t_group) = runs[("alone", precision)], runs[("group", precision)]
        gap = max(abs(a - b) / abs(a) for a, b in zip(alone, group))
        again = max(abs(a - b) / abs(a) for a, b in zip(alone, runs[("warm-up", precision)][0]))
        check(len(alone) == len(group) == PARALLEL_STEPS + 2 and gap <= PARALLEL_LOSS_RTOL,
              f"nccl {precision}: {PARALLEL_STEPS} static_train losses and 2 eval means in a "
              f"group of one within {PARALLEL_LOSS_RTOL} of the run without a group (largest "
              f"gap {gap:.3g}; {'bit for bit' if alone == group else 'not bit for bit'}; two "
              f"runs without a group: {again:.3g} apart); {t_group:.2f} s against "
              f"{t_alone:.2f} s on {card}")


class _HeldBatches:
    """A train loader over batches held in memory, so that the loader does
    not bound a timed loop."""

    def __init__(self, batches):
        self.batches = batches

    def set_position(self, epoch, batches_consumed):
        raise NotImplementedError

    def __iter__(self):
        return iter(self.batches)


def _loop_step_ms(torch, np, style, vgg_params, precision, grouped) -> float:
    """Wall ms per step of static_train's train_loop over steps LOOP_SKIP
    to LOOP_STEPS - 1 on batches held in memory, in an NCCL group of one
    (formed before and left after the run) or without a group. Only step 0
    logs, evaluates and previews; the clock stops at a synchronize after
    the last step."""
    from styletransfer_tpu_torch.data import coco
    from styletransfer_tpu_torch.engines import fast
    from styletransfer_tpu_torch.models import transformer
    from styletransfer_tpu_torch.parallel import distributed

    real_loop, taken, clock = fast.train_loop, [0], {}

    def timed_loop(params, train_step, *args, **kwargs):
        def step(*step_args):
            if taken[0] == LOOP_SKIP:
                clock["start"] = time.perf_counter()
            metrics = train_step(*step_args)
            taken[0] += 1
            if taken[0] == LOOP_STEPS:
                torch.cuda.synchronize()
                clock["end"] = time.perf_counter()
            return metrics
        return real_loop(params, step, *args, **kwargs)

    tag = f"{'group' if grouped else 'alone'}_{precision}_{time.perf_counter_ns()}"
    if grouped:
        distributed.initialize(f"127.0.0.1:{distributed.free_port()}", 1, 0, device="cuda")
    fast.train_loop = timed_loop
    try:
        test_loader, _ = coco.get_coco_loader(
            batch_size=TRAIN_BATCH, test_limit=8, image_dir=os.path.join(WORK, "no_images"))
        batch = _parallel_batch(np)
        fast.static_train(
            style, style_name="loop", epochs=1, batch_size=TRAIN_BATCH, vgg_params=vgg_params,
            params=transformer.init_params(seed=0, device="cuda"),
            train_loader=_HeldBatches([batch] * LOOP_STEPS),
            test_loader=test_loader, log_cadence=(10 * LOOP_STEPS,) * 3,
            runs_dir=os.path.join(WORK, f"runs_loop_{tag}"),
            models_path=os.path.join(WORK, f"models_loop_{tag}"),
            max_steps_per_epoch=LOOP_STEPS, precision=precision, device="cuda")
    finally:
        fast.train_loop = real_loop
        if grouped:
            distributed.shutdown()
    check(taken[0] == LOOP_STEPS,
          f"nccl {precision}: train_loop ran {taken[0]} steps ({LOOP_STEPS} asked)")
    return (clock["end"] - clock["start"]) * 1e3 / (LOOP_STEPS - LOOP_SKIP)


def _grads_close(np, got, want, label):
    scale = max(float(np.linalg.norm(w)) for w in want.values())
    worst, worst_name = 0.0, ""
    for name, w in want.items():
        if np.linalg.norm(w) < 1e-6 * scale:
            # A bias that an instance norm cancels: zero up to rounding.
            check(float(np.linalg.norm(got[name])) < 1e-5 * scale,
                  f"{label}: {name} gradient is zero up to rounding on both")
            continue
        rel = float(np.linalg.norm(got[name] - w) / np.linalg.norm(w))
        if rel > worst:
            worst, worst_name = rel, name
    check(worst <= PARALLEL_GRAD_REL_L2,
          f"{label}: every gradient within relative L2 {PARALLEL_GRAD_REL_L2} of one process "
          f"on all 4 images (worst {worst:.3g}, {worst_name})")


def two_rank_phase(torch, np, in_dir, card):
    """The PARALLEL_RANKS gloo ranks on cuda:0 (rank_worker), then their
    results against each other and against one process's step on the whole
    global batch. Returns rank 0's launches of one step by precision."""
    from styletransfer_tpu_torch.engines import fast
    from styletransfer_tpu_torch.models import transformer, vgg
    from styletransfer_tpu_torch.parallel import distributed

    out = os.path.join(WORK, "ranks")
    os.makedirs(out, exist_ok=True)
    torch.cuda.empty_cache()  # the card is shared with the ranks
    t0 = time.perf_counter()
    ranks = distributed.launch_local(
        [sys.executable, os.path.abspath(__file__), "--rank-worker", out, in_dir],
        PARALLEL_RANKS, PARALLEL_TIMEOUT_S, cwd=ROOT)
    for r, (code, log) in enumerate(ranks):
        if code:
            print(log[-6000:], file=sys.stderr)
        check(code == 0, f"two ranks: rank {r} exited with {code}")
    print(f"two ranks: both ranks ran in {time.perf_counter() - t0:.1f} s (start-up, steps, "
          f"static_train, process_dir, train-multi, video_st train) on {card}", flush=True)
    res = [json.load(open(os.path.join(out, f"rank{r}.json"))) for r in range(PARALLEL_RANKS)]
    arr = [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(PARALLEL_RANKS)]
    for key in arr[0]:
        if ".grad." not in key:
            check(all(np.array_equal(a[key], arr[0][key]) for a in arr[1:]),
                  f"two ranks: {key} bit-identical across the ranks")

    style = torch.from_numpy(_style_image(np)).cuda()
    vgg_params = vgg.init_params(seed=0, device="cuda")
    grams = vgg.style_gram_targets(vgg_params, style)
    x = torch.from_numpy(_parallel_batch(np)).cuda()
    launches = {}
    for precision in ("f32", "bf16"):
        for r in res:
            counts = r[f"{precision}.launches"]
            per = with_conv9x9(PER_RANK_STEP, precision)
            want = {k: per.get(k, 0) for k in counts}
            check(counts == want, f"two ranks {precision}: rank {r['rank']}'s step launched "
                  f"{counts} (want {per})")
        launches[precision] = res[0][f"{precision}.launches"]
        cd = torch.bfloat16 if precision == "bf16" else None
        step = fast.make_train_step(vgg_params, grams, compute_dtype=cd)
        params = transformer.init_params(seed=1, device="cuda")
        opt = fast.make_optimizer(params)
        metrics = {k: float(v) for k, v in step(params, opt, x).items()}
        grads = {n: p.grad.cpu().numpy() for n, p in params.named_parameters()}
        ms_one = _step_ms(torch, step, params, opt, x)
        gap = max(abs(res[0][f"{precision}.metrics"][k] - v) / abs(v) for k, v in metrics.items())
        if precision == "f32":
            check(gap <= PARALLEL_LOSS_RTOL,
                  f"two ranks f32: loss components {res[0]['f32.metrics']} against one process's "
                  f"{metrics}: largest gap {gap:.3g} (limit {PARALLEL_LOSS_RTOL})")
            _grads_close(np, {n[len("f32.grad."):]: v for n, v in arr[0].items()
                              if n.startswith("f32.grad.")}, grads, "two ranks f32")
        else:
            check(all(math.isfinite(v) for v in res[0]["bf16.metrics"].values()),
                  f"two ranks bf16: loss components finite, largest gap to one process "
                  f"{gap:.3g}")
        print(f"two ranks {precision}: {TRAIN_BATCH // PARALLEL_RANKS} images per rank: "
              f"{', '.join('%.2f' % r[f'{precision}.ms'] for r in res)} ms per step "
              f"(gloo all-reduce of the gradients through the host) against one process on "
              f"{TRAIN_BATCH} images {ms_one:.2f} ms, on {card}", flush=True)
        for r in res:
            losses = r[f"{precision}.train_losses"] + r[f"{precision}.test_losses"]
            check(len(r[f"{precision}.train_losses"]) == PARALLEL_STEPS
                  and len(r[f"{precision}.test_losses"]) == 2
                  and all(math.isfinite(v) for v in losses),
                  f"two ranks {precision}: rank {r['rank']}'s static_train logged "
                  f"{['%.4f' % v for v in losses]}, all finite")
            n, conv, norm = r[f"{precision}.served"]
            check(n == BATCH and conv == 10 and norm == 15,
                  f"two ranks {precision}: rank {r['rank']} served the trained checkpoint "
                  f"through process_dir ({n} PNGs, {conv} conv3x3, {norm} IN-pad launches)")
    for r in res:
        print(f"two ranks: rank {r['rank']}'s training graphs {r['train_graphs'][0]} captured, "
              f"{r['train_graphs'][1]} replays", flush=True)
        check(r["train_graphs"] == [0, 0],
              f"two ranks: rank {r['rank']} trained eagerly, every step with its all-reduce "
              f"({r['train_graphs'][0]} training graphs captured, {r['train_graphs'][1]} "
              f"replays; want none)")
        check(len(r["multi.losses"]) == MULTI_PAR_STEPS
              and all(math.isfinite(v) for v in r["multi.losses"]),
              f"two ranks: rank {r['rank']}'s train-multi logged "
              f"{['%.4f' % v for v in r['multi.losses']]}, all finite")
        chunks = [PAR_VIDEO_CHUNK] * (2 * PAR_VIDEO_FRAMES // PAR_VIDEO_CHUNK)
        check(r["video.whole_steps"] == chunks and r["video.cut_steps"] == chunks[:1]
              and r["video.sidecar"] and r["video.resumed_steps"] == chunks[1:]
              and all(math.isfinite(v) for v in r["video.losses"] + r["video.resumed_losses"]),
              f"two ranks: rank {r['rank']}'s video_st train stepped {r['video.whole_steps']}; "
              f"cut after the step state at frame {PAR_VIDEO_CHUNK} with its carry sidecar, it "
              f"resumed mid-batch ({r['video.resumed_steps']}); losses finite")
    gap = float(np.abs(arr[0]["video.resumed"] - arr[0]["video.whole"]).max())
    check(gap == 0, f"two ranks: the video run resumed from the sidecars ends with the whole "
          f"run's parameters bit for bit (largest gap {gap:.3g})")
    return launches


class _ReadyCounts(_Stamped):
    """A daemon's stdout that sets the launch counters to 0 once its READY
    line is complete (before the first request)."""

    def write(self, text):
        ready = self.ready
        super().write(text)
        if ready is None and self.ready is not None:
            reset_counts()


def placement_phase(torch, np, in_dir, card):
    """The serving paths over PLACEMENT_DEVICES (two slots of cuda:0):
    process_dir at batch BATCH against the one-device run, f32 and bf16;
    convert-dir of PAR_CLIPS clips at batch PAR_CLIP_BATCH (one ragged
    group: lanes 2 + 1), every clip exactly its stylize_clip; fast_st serve
    at batch DAEMON_BATCH on stdin.
    Returns the launches of each run."""
    import io

    import torch.nn.functional as F
    from PIL import Image

    from styletransfer_tpu_torch import ckpt
    from styletransfer_tpu_torch.data import video as video_data
    from styletransfer_tpu_torch.engines import fast, video
    from styletransfer_tpu_torch.models import transformer
    from styletransfer_tpu_torch.utils import images

    models = os.path.join(WORK, "models_placement")
    params = transformer.init_params(seed=0, device="cuda")
    ckpt.save(params, ckpt.checkpoint_path("fast_st", "smoke", 0, models))
    launches = {}
    for precision in ("f32", "bf16"):
        walls = {}
        outs = {}
        for label, devices in (("two", PLACEMENT_DEVICES), ("one", None)):
            reset_counts()
            t0 = time.perf_counter()
            paths = fast.process_dir(in_dir, "smoke", out_dir=os.path.join(
                WORK, f"place_{label}_{precision}"), batch_size=BATCH, models_path=models,
                precision=precision, device="cuda", devices=devices)
            torch.cuda.synchronize()
            walls[label] = time.perf_counter() - t0
            outs[label] = np.stack([np.asarray(Image.open(p)) for p in sorted(paths)])
            if label == "two":
                launches[("process_dir", precision)] = counts = read_counts()
                up = UPCONV_PER_FORWARD[precision]
                check(counts["conv3x3_valid"] == 20 and counts["instance_norm_pad"] == 30
                      and counts["upconv_phase"] == 2 * up
                      and counts["conv9x9"] == 2 * CONV9X9_PER_FORWARD[precision],
                      f"placement {precision}: process_dir of {BATCH} images over "
                      f"{PLACEMENT_DEVICES} launched {counts['conv3x3_valid']} conv3x3, "
                      f"{counts['instance_norm_pad']} IN-pad and {counts['upconv_phase']} "
                      f"upconv_phase (10, 15 and {up} per shard's forward)")
        diff = np.abs(outs["two"].astype(np.int32) - outs["one"].astype(np.int32))
        max_steps, mean_steps = MAIN_TOL[precision]
        check(outs["two"].shape == (BATCH, SIZE, SIZE, 3) and int(diff.max()) <= max_steps
              and float(diff.mean()) <= mean_steps,
              f"placement {precision}: process_dir over two slots vs one device: max "
              f"{int(diff.max())}/255, mean {float(diff.mean()):.4f}/255 (limits {max_steps}, "
              f"{mean_steps}); {BATCH / walls['two']:.1f} against {BATCH / walls['one']:.1f} "
              f"img/s with the IO, on {card}")

    clips = os.path.join(WORK, "par_clips")
    os.makedirs(clips, exist_ok=True)
    for i, n in enumerate(PAR_CLIPS):
        _write_clip(np, os.path.join(clips, f"clip{i}.gif"), n, 40_000 + i)
    vparams = transformer.init_video_params(seed=0, device="cuda")
    seen, restore = _recording(video)
    library_conv, conv_calls = F.conv2d, [0]

    def counting_conv2d(*args, **kwargs):
        conv_calls[0] += 1
        return library_conv(*args, **kwargs)

    F.conv2d = counting_conv2d
    reset_counts()
    try:
        outs = video.process_video_dir(clips, "smoke", out_dir=os.path.join(WORK, "par_video"),
                                       batch_size=PAR_CLIP_BATCH, params=vparams, chunk_size=4,
                                       device="cuda", devices=PLACEMENT_DEVICES)
    finally:
        restore()
        F.conv2d = library_conv
    launches[("convert_dir", "f32")] = counts = read_counts()
    # Every shard steps each frame row of the group (a lane past its clip's
    # end feeds its last frame), one forward a row.
    forwards = len(PLACEMENT_DEVICES) * max(PAR_CLIPS)
    per = {"conv_direct": 6, "conv3x3_valid": 10, "conv3x3_valid.f32_fma": 10,
           "instance_norm_pad": 15}
    want = {k: per.get(k, 0) * forwards for k in counts}
    check(counts == want and conv_calls[0] == 0,
          f"placement: convert-dir over two slots ran {forwards} forwards ({max(PAR_CLIPS)} "
          f"frame rows per shard), each 6 conv_direct and {per}: {counts['conv_direct']} "
          f"conv_direct, no cuDNN conv ({conv_calls[0]})")
    for i, (n, out) in enumerate(zip(PAR_CLIPS, outs)):
        reader = video_data.ImageioFrameReader(os.path.join(clips, f"clip{i}.gif"),
                                               normalized=False)
        frames = np.stack([reader.next_frame()[0] for _ in range(n)])
        reader.close()
        want = np.stack([images.to_uint8(f) for f in video.stylize_clip(vparams, frames)])
        got = np.stack(seen[out])
        check(got.shape == want.shape and np.array_equal(got, want),
              f"placement: convert-dir lane {i} ({n} frames; lanes 0-1 on the first slot, 2 "
              f"on the second) is exactly its stylize_clip (max "
              f"{int(np.abs(got.astype(np.int32) - want).max())}/255)")

    lines = [os.path.join(in_dir, f"img{i:03d}.png") for i in range(PAR_SERVE_REQUESTS)]
    out = _ReadyCounts()
    n = fast.serve_loop("smoke", out_dir=os.path.join(WORK, "par_serve"), models_path=models,
                        batch_size=DAEMON_BATCH, device="cuda", devices=PLACEMENT_DEVICES,
                        stdin=io.StringIO("".join(f"{ln}\n" for ln in lines)), stdout=out)
    launches[("serve", "f32")] = counts = read_counts()
    forwards = 2 * -(-PAR_SERVE_REQUESTS // DAEMON_BATCH)
    check(n == PAR_SERVE_REQUESTS and all(ln.startswith("OK ") for ln in out.lines[1:])
          and counts["conv3x3_valid"] == 10 * forwards
          and counts["instance_norm_pad"] == 15 * forwards
          and counts["upconv_phase"] == UPCONV_PER_FORWARD["f32"] * forwards
          and counts["conv9x9"] == CONV9X9_PER_FORWARD["f32"] * forwards,
          f"placement: fast_st serve at batch {DAEMON_BATCH} over two slots answered {n} "
          f"requests OK with {counts['conv3x3_valid']} conv3x3, "
          f"{counts['instance_norm_pad']} IN-pad and {counts['upconv_phase']} upconv_phase "
          f"launches after READY (10, 15 and {UPCONV_PER_FORWARD['f32']} per shard)")
    return launches


def dryrun_phase(torch, card):
    """parallel/dryrun.py with two gloo ranks on cuda:0."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "styletransfer_tpu_torch.parallel.dryrun",
                          "--ranks", "2", "--device", "cuda", "--backend", "gloo",
                          "--timeout", str(PARALLEL_TIMEOUT_S)], cwd=ROOT,
                         capture_output=True, text=True, timeout=PARALLEL_TIMEOUT_S + 60)
    if out.returncode:
        print(out.stderr[-6000:], file=sys.stderr)
    check(out.returncode == 0, f"dryrun: two gloo ranks on cuda:0 ran one fast_st, multi-style "
          f"and video step each and a placed Gatys pass in {time.perf_counter() - t0:.1f} s: "
          f"{out.stdout.strip().splitlines()[-1] if out.stdout.strip() else 'no result'} "
          f"on {card}")


def parallel_slice(torch, np, in_dir, card):
    """The multi-GPU slice's phases; returns the launches of each path."""
    nccl_phase(torch, np, card)
    train = two_rank_phase(torch, np, in_dir, card)
    placed = placement_phase(torch, np, in_dir, card)
    dryrun_phase(torch, card)
    return train, placed


# The packed slice (``--packed``): a file of PACKED_IMAGES synthetic 256 px
# crops (``pack_synthetic``), whose loaders give 14 train batches of 4 and
# one eval batch; static_train for TRAIN_STEPS steps on it in f32 and bf16
# (per step the training path's launches, on uint8 batches), one f32 step
# card against CPU on its first batch, ``fast_st train-multi --packed`` for
# an epoch, and ms per step of the loop on the packed file beside the
# synthetic corpus, in turns.
PACKED_IMAGES = 64
PACKED_WARM = 2  # untimed steps of each timed loop
PACKED_TIMED = 12  # timed steps of each loop (14 batches in the packed file)
PACKED_PARITY_IMAGES = 2
PER_STEP = {"fused_instance_norm_fwd": NORMS_PER_FORWARD,
            "fused_instance_norm_bwd": NORMS_PER_FORWARD, **VGG_PER_STEP}
PER_MULTI_STEP = {**PER_STEP, "fused_instance_norm_fwd.per_image": NORMS_PER_FORWARD,
                  "fused_instance_norm_bwd.per_image": NORMS_PER_FORWARD}


def _step_recording(module, steps):
    """Wrap ``module.make_train_step`` so each step records the dtype and
    device of its batch and the launches it made; returns the original."""
    real = module.make_train_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def recorded(params, optimizer, batch, *rest):
            before, graphs = read_counts(), graph_counts()
            metrics = step(params, optimizer, batch, *rest)
            after = read_counts()
            steps.append((batch.dtype, batch.device.type,
                          {k: after[k] - before[k] for k in after if after[k] != before[k]},
                          tuple(batch.shape), graphed_since(graphs)))
            return metrics

        return recorded

    module.make_train_step = make
    return real


def _steps_checked(torch, label, steps, n, per_step):
    """``n`` steps on uint8 batches on the card, each a replay of its batch
    shape's CUDA graph, captured at the shape's first step: that step
    launches ``per_step`` for each pass of the capture, the others none.
    Returns the forward-backward passes the counters saw."""
    passes = [step_passes(1, graphs) for *_, graphs in steps]
    want = [{k: v * p for k, v in per_step.items()} if p else {} for p in passes]
    captures = sum(graphs[0] for *_, graphs in steps)
    replays = sum(graphs[1] for *_, graphs in steps)
    shapes = {shape for *_, shape, _ in steps}
    print(f"{label}: training graphs {captures} captured, {replays} replays in {len(steps)} "
          f"steps", flush=True)
    check(len(steps) == n and all(dt == torch.uint8 and dev == "cuda" for dt, dev, *_ in steps)
          and [d for _, _, d, *_ in steps] == want and replays == n
          and captures == len(shapes),
          f"{label}: {len(steps)} steps on uint8 batches on the card, {replays} of them "
          f"replays of {captures} training graphs ({len(shapes)} batch shapes), launching "
          f"{[d for _, _, d, *_ in steps]} (want {n} steps, each a replay, {per_step} a pass: "
          f"{want})")
    return sum(passes)


def _loop_ms(torch, fast, prefetch, vgg_params, grams, loader, precision) -> float:
    """ms per step of the training loop's inner part (prefetched batches,
    the step, nothing else) over PACKED_TIMED steps after PACKED_WARM."""
    from styletransfer_tpu_torch.models import transformer

    step = fast.make_train_step(vgg_params, grams,
                                compute_dtype=torch.bfloat16 if precision == "bf16" else None)
    params = transformer.init_params(seed=0, device="cuda")
    opt = fast.make_optimizer(params)
    batches = prefetch.prefetch_to_device(loader, "cuda")
    try:
        for i, batch in enumerate(batches):
            if i == PACKED_WARM:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            metrics = step(params, opt, batch)
            if i == PACKED_WARM + PACKED_TIMED - 1:
                break
        loss = float(metrics["total"])
        ms = (time.perf_counter() - t0) * 1e3 / PACKED_TIMED
    finally:
        batches.close()
    check(i == PACKED_WARM + PACKED_TIMED - 1 and math.isfinite(loss),
          f"timed loop {precision}: {i + 1} steps, last loss {loss:.4f} finite")
    return ms


def packed_path(torch, np):
    """The --packed slice. Returns (launches by precision of the static_train
    runs, ms per step by (precision, corpus))."""
    from styletransfer_tpu_torch import constants
    from styletransfer_tpu_torch.clis import cli
    from styletransfer_tpu_torch.data import coco, packed
    from styletransfer_tpu_torch.engines import fast
    from styletransfer_tpu_torch.engines import multistyle as mengine
    from styletransfer_tpu_torch.models import transformer, vgg
    from styletransfer_tpu_torch.parallel import prefetch
    from styletransfer_tpu_torch.utils.logging import get_logger

    root = os.path.join(WORK, "packed")
    path = os.path.join(root, "synthetic.bin")
    t0 = time.perf_counter()
    n = packed.pack_synthetic(path, PACKED_IMAGES, SIZE)
    check(n == PACKED_IMAGES and os.path.getsize(path) == PACKED_IMAGES * SIZE * SIZE * 3,
          f"pack_synthetic: {n} images of {SIZE} px, {os.path.getsize(path)} bytes in "
          f"{time.perf_counter() - t0:.2f} s")
    style = _style_image(np)
    vgg_params = vgg.init_params(seed=0, device="cuda")
    _, image_every, eval_every = TRAIN_CADENCE
    launches, steps = {}, []
    real = _step_recording(fast, steps)
    try:
        for precision in ("f32", "bf16"):
            test_loader, train_loader = packed.get_packed_loader(
                path, batch_size=TRAIN_BATCH, test_limit=20)
            previews = len(range(0, TRAIN_STEPS, image_every))
            eval_forwards = len(test_loader) * len(range(0, TRAIN_STEPS, eval_every))
            log = _LossLog()
            logger = get_logger()
            logger.addHandler(log)
            steps.clear()
            reset_counts()
            t0 = time.perf_counter()
            try:
                fast.static_train(
                    style, style_name="packed", epochs=1, batch_size=TRAIN_BATCH,
                    vgg_params=vgg_params, params=transformer.init_params(seed=0, device="cuda"),
                    train_loader=train_loader, test_loader=test_loader,
                    log_cadence=TRAIN_CADENCE, runs_dir=os.path.join(root, f"runs_{precision}"),
                    models_path=os.path.join(root, f"models_{precision}"),
                    max_steps_per_epoch=TRAIN_STEPS, precision=precision, device="cuda")
                torch.cuda.synchronize()
            finally:
                logger.removeHandler(log)
            wall = time.perf_counter() - t0
            counts = read_counts()
            launches[precision] = counts
            passes = _steps_checked(torch, f"packed static_train {precision}", steps,
                                    TRAIN_STEPS, with_conv9x9(PER_STEP, precision))
            want = {k: 0 for k in counts}
            want.update({"fused_instance_norm_fwd": NORMS_PER_FORWARD * (
                passes + previews + eval_forwards),
                "fused_instance_norm_bwd": NORMS_PER_FORWARD * passes,
                "conv9x9": (CONV9X9_PER_STEP[precision] * passes
                            + CONV9X9_PER_FORWARD[precision] * (previews + eval_forwards))})
            for k in GATYS_KERNELS:
                want[k] = (VGG_PER_STEP[k] * passes + VGG_PER_EVAL[k] * eval_forwards
                           + VGG_STYLE_TARGETS[k])
            check(counts == want and eval_forwards == 1,
                  f"packed static_train {precision}: {TRAIN_STEPS} steps, {previews} previews "
                  f"and {eval_forwards} eval forwards of uint8 batches launched {counts} "
                  f"(want {want})")
            check(len(log.train) == TRAIN_STEPS and all(math.isfinite(v) for v in log.train)
                  and len(log.test) == 1 and math.isfinite(log.test[0]),
                  f"packed static_train {precision}: losses {['%.4f' % v for v in log.train]}, "
                  f"eval {log.test}, all finite")
            print(f"packed static_train {precision}: {TRAIN_STEPS} steps at batch {TRAIN_BATCH} "
                  f"in {wall:.3f} s (incl. VGG targets, eval, previews, checkpoint)", flush=True)
    finally:
        fast.make_train_step = real

    # One f32 step on the file's first train batch: card against CPU. Biases
    # that a norm cancels get gradients of rounding noise, which Adam's first
    # step turns into moves of about +-lr: they are held to 2 lr, the rest of
    # the parameters to PARITY_GRAD_REL_L2 (multistyle_parity's rule).
    _, train_loader = packed.get_packed_loader(path, batch_size=PACKED_PARITY_IMAGES,
                                               test_limit=20)
    batch = torch.from_numpy(next(iter(train_loader)))
    cpu_params = transformer.init_params(seed=1, device="cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        params = (cpu_params if dev == "cpu" else transformer.params_from_jax(
            transformer.params_to_tree(cpu_params), device=dev))
        vp = vgg.init_params(seed=0, device=dev)
        grams = vgg.style_gram_targets(vp, torch.from_numpy(style).to(dev))
        step = fast.make_train_step(vp, grams)
        metrics = step(params, fast.make_optimizer(params), batch.to(dev))
        runs[dev] = ({k: float(v) for k, v in metrics.items()},
                     {n: (p.grad.detach().cpu(), p.detach().cpu())
                      for n, p in params.named_parameters()})
    (mg, pg), (mc, pc) = runs["cuda"], runs["cpu"]
    worst = max(abs(mg[k] - mc[k]) / abs(mc[k]) for k in mc)
    scale = max(float(g.norm()) for g, _ in pc.values())
    noise = [n for n, (g, _) in pc.items() if float(g.norm()) < 1e-6 * scale]
    moved = max((float((pg[n][1] - pc[n][1]).abs().max()) for n in noise), default=0.0)
    rest = [n for n in pc if n not in noise]
    rel = float(torch.cat([(pg[n][1] - pc[n][1]).reshape(-1) for n in rest]).norm()
                / torch.cat([pc[n][1].reshape(-1) for n in rest]).norm())
    check(worst <= PARITY_LOSS_RTOL and rel <= PARITY_GRAD_REL_L2 and moved <= 2 * ADAM_LR,
          f"packed parity f32: a step on {PACKED_PARITY_IMAGES} uint8 images, losses card "
          f"{mg} vs CPU {mc} (worst relative {worst:.3g}, limit {PARITY_LOSS_RTOL}), "
          f"parameters after the step relative L2 {rel:.3g} (limit {PARITY_GRAD_REL_L2}); "
          f"{len(noise)} with gradients of rounding noise within {moved:.3g} (limit 2 lr)")

    # fast_st train-multi --packed: the command, one epoch of the file.
    for i in range(2):
        _save_png(np, os.path.join(root, f"style{i}.png"), 10_000 + i)
    test_loader, train_loader = packed.get_packed_loader(path, batch_size=TRAIN_BATCH,
                                                         test_limit=20)
    multi_steps = []
    real = _step_recording(mengine, multi_steps)
    saved_root = constants.PROJECT_ROOT_PATH
    constants.PROJECT_ROOT_PATH = root
    log = _LossLog()
    get_logger().addHandler(log)
    reset_counts()
    t0 = time.perf_counter()
    try:
        cli.main(["fast_st", "train-multi", "style0.png", "style1.png", "-n", "packed", "-e",
                  "1", "-b", str(TRAIN_BATCH), "--packed", "synthetic.bin", "--device", "cuda"],
                 standalone_mode=False)
        torch.cuda.synchronize()
    finally:
        get_logger().removeHandler(log)
        constants.PROJECT_ROOT_PATH = saved_root
        mengine.make_train_step = real
    wall = time.perf_counter() - t0
    launches["train_multi"] = read_counts()
    _steps_checked(torch, "fast_st train-multi --packed", multi_steps, len(train_loader),
                   with_conv9x9(PER_MULTI_STEP, "f32"))
    check(all(math.isfinite(v) for v in log.train + log.test) and len(log.test) == 1
          and os.path.isfile(os.path.join(root, "data", "models",
                                          "fast_multi_st_packed_epoch0.msgpack")),
          f"fast_st train-multi --packed: losses {log.train}, eval {log.test} finite, epoch "
          f"checkpoint written ({len(multi_steps)} steps in {wall:.3f} s with the command's "
          f"set-up)")

    # The loop's ms per step: packed batches beside the synthetic corpus.
    grams = vgg.style_gram_targets(vgg_params, torch.from_numpy(style).cuda())
    rates = {}
    for precision in ("f32", "bf16"):
        for corpus in ("packed", "synthetic", "synthetic", "packed"):
            if corpus == "packed":
                _, loader = packed.get_packed_loader(path, batch_size=TRAIN_BATCH,
                                                     test_limit=20)
            else:
                _, loader = coco.get_coco_loader(batch_size=TRAIN_BATCH, test_limit=20,
                                                 image_dir=os.path.join(WORK, "no_images"))
            ms = _loop_ms(torch, fast, prefetch, vgg_params, grams, loader, precision)
            rates.setdefault((precision, corpus), []).append(ms)
        print(f"training loop {precision} at batch {TRAIN_BATCH}, {SIZE} px, in turns: packed "
              f"{rates[(precision, 'packed')][0]:.3f} / {rates[(precision, 'packed')][1]:.3f} "
              f"ms per step, synthetic corpus {rates[(precision, 'synthetic')][0]:.3f} / "
              f"{rates[(precision, 'synthetic')][1]:.3f}", flush=True)
    return launches, rates


# The lbfgs-zoom slice: gatys_st --optimizer lbfgs-zoom at GATYS_SIZE px,
# batch 1, ZOOM_STEPS steps in f32 and bf16 and the CLI's 300-step default
# in f32; _run_lbfgs at GATYS_PARITY_SIZE px card against CPU, and on
# ZOOM_LANES images against each alone; the daemon at batch 4 and 1.
ZOOM_STEPS = 20
ZOOM_PARITY_STEPS = 3
ZOOM_LOSS_RTOL = 1e-3  # tests/test_torch_gatys.py's LBFGS_LOSS_RTOL
ZOOM_LANES = 3


def _zoom_losses(torch, gatys, vgg_params, contents, grams, cd=None, per_lane=False):
    _, losses = gatys._run_lbfgs(vgg_params, contents, grams, ZOOM_PARITY_STEPS, 1e5, 1.0,
                                 compute_dtype=cd, per_lane=per_lane)
    return losses.cpu().numpy()


def zoom_path(torch, np, F):
    """The lbfgs-zoom slice. Returns (launches by precision of the 20-step
    runs, seconds per image by run, daemon launches and seconds)."""
    from PIL import Image

    from styletransfer_tpu_torch import constants
    from styletransfer_tpu_torch.clis import cli
    from styletransfer_tpu_torch.data import coco
    from styletransfer_tpu_torch.engines import gatys
    from styletransfer_tpu_torch.models import vgg
    from styletransfer_tpu_torch.ops import lbfgs
    from styletransfer_tpu_torch.utils import images
    from styletransfer_tpu_torch.utils.logging import get_logger

    root = os.path.join(WORK, "zoom")
    os.makedirs(root)
    content, style = os.path.join(root, "content.png"), os.path.join(root, "style.png")
    _save_png(np, content, 20_000)
    _save_png(np, style, 20_001)
    library_conv, conv_calls = F.conv2d, [0]

    def counting_conv2d(*args, **kwargs):
        conv_calls[0] += 1
        return library_conv(*args, **kwargs)

    def run(label, args):
        reset_counts()
        gatys.closure_evals = 0
        conv_calls[0] = 0
        lbfgs.zoom_log.clear()
        log = _GatysLog()
        get_logger().addHandler(log)
        t0 = time.perf_counter()
        try:
            cli.main(["gatys_st", content, style, "--optimizer", "lbfgs-zoom", "--size",
                      str(GATYS_SIZE), *args, "--device", "cuda"], standalone_mode=False)
            torch.cuda.synchronize()
        finally:
            get_logger().removeHandler(log)
        wall = time.perf_counter() - t0
        counts, evals = read_counts(), gatys.closure_evals
        per_step = [int(c[0]) for c, _ in lbfgs.zoom_log]
        reads = [r for _, r in lbfgs.zoom_log]
        want = {k: 0 for k in counts}
        for k in GATYS_KERNELS:
            want[k] = GATYS_PER_CLOSURE[k] * evals + GATYS_TARGETS[k]
        check(evals == 1 + sum(per_step) and counts == want and conv_calls[0] == 0,
              f"lbfgs-zoom {label}: {evals} closures (1 + the line searches' {sum(per_step)}) "
              f"launched {counts} (want {want}), {conv_calls[0]} F.conv2d calls")
        check(len(log.losses) >= 2 and all(math.isfinite(v) for v in log.losses)
              and log.losses[-1] < log.losses[0],
              f"lbfgs-zoom {label}: logged losses {log.losses} finite and falling")
        print(f"lbfgs-zoom {label}: {wall:.3f} s for one image ({len(per_step)} steps, "
              f"{evals} closures; closures per step mean {np.mean(per_step):.2f}, max "
              f"{max(per_step)}; host reads per step mean {np.mean(reads):.2f}, max "
              f"{max(reads)}) on {GATYS_SIZE} px", flush=True)
        return counts, wall, per_step, reads

    saved_root = constants.PROJECT_ROOT_PATH
    constants.PROJECT_ROOT_PATH = root
    F.conv2d = counting_conv2d
    launches, seconds, closures = {}, {}, {}
    try:
        for precision in ("f32", "bf16"):
            counts, wall, per_step, reads = run(precision, [
                "-s", str(ZOOM_STEPS), "--precision", precision, "-n", f"zoom_{precision}.png"])
            out = np.asarray(Image.open(os.path.join(root, "results", f"zoom_{precision}.png")))
            check(out.shape == (GATYS_SIZE, GATYS_SIZE, 3),
                  f"lbfgs-zoom {precision}: PNG {out.shape} written")
            launches[precision], seconds[precision] = counts, wall
            closures[precision] = per_step
        _, seconds["default"], closures["default"], _ = run("default (300 steps, f32)", [
            "-n", "zoom_default.png"])
    finally:
        F.conv2d = library_conv
        constants.PROJECT_ROOT_PATH = saved_root

    # _run_lbfgs at GATYS_PARITY_SIZE px: the card against the port's CPU run,
    # one image, then ZOOM_LANES lanes against each image alone.
    def img(i):
        return torch.from_numpy(images.normalize(
            coco.synthetic_image(i, GATYS_PARITY_SIZE))[None].astype(np.float32))

    contents = torch.cat([img(30_010 + i) for i in range(ZOOM_LANES)])
    cpu_params = vgg.init_params(seed=0, device="cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        params = {k: {leaf: v.to(dev) for leaf, v in p.items()} for k, p in cpu_params.items()}
        grams = vgg.style_gram_targets(params, img(30_001).to(dev))
        runs[dev] = _zoom_losses(torch, gatys, params, contents[:1].to(dev), grams)
    first = abs(runs["cuda"][0] - runs["cpu"][0]) / abs(runs["cpu"][0])
    worst = float(np.max(np.abs(runs["cuda"] - runs["cpu"]) / np.abs(runs["cpu"])))
    check(first <= GATYS_PARITY_LOSS_RTOL and worst <= ZOOM_LOSS_RTOL,
          f"lbfgs-zoom parity f32 {GATYS_PARITY_SIZE} px: losses card {runs['cuda']} vs CPU "
          f"{runs['cpu']} (first relative {first:.3g}, limit {GATYS_PARITY_LOSS_RTOL}; worst "
          f"{worst:.3g} over {ZOOM_PARITY_STEPS} steps, limit {ZOOM_LOSS_RTOL})")
    params = {k: {leaf: v.cuda() for leaf, v in p.items()} for k, p in cpu_params.items()}
    grams = vgg.style_gram_targets(params, img(30_001).cuda())
    lanes = _zoom_losses(torch, gatys, params, contents.cuda(), grams, per_lane=True)
    gaps = []
    for i in range(ZOOM_LANES):
        alone = _zoom_losses(torch, gatys, params, contents[i:i + 1].cuda(), grams)
        gaps.append((abs(lanes[i][0] - alone[0]) / abs(alone[0]),
                     float(np.max(np.abs(lanes[i] - alone) / np.abs(alone)))))
    check(all(f <= GATYS_PARITY_LOSS_RTOL and w <= ZOOM_LOSS_RTOL for f, w in gaps),
          f"lbfgs-zoom lanes: {ZOOM_LANES} images of {GATYS_PARITY_SIZE} px in one run, each "
          f"lane against its image alone (first loss, worst of {ZOOM_PARITY_STEPS} steps): "
          f"{[(f'{f:.2e}', f'{w:.2e}') for f, w in gaps]}")

    daemon_launches, daemon_seconds = gatys_daemon_path(torch, np, F, optimizer="lbfgs-zoom")
    return launches, seconds, closures, daemon_launches, daemon_seconds


def doctor_phase(torch):
    """``python -m styletransfer_tpu_torch doctor`` on the card: exit 0, the
    card's probe and the kernel build (done in phase 2) both ``ok``."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "styletransfer_tpu_torch", "doctor"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    rows = [line for line in proc.stdout.splitlines() if line.startswith("[")]
    for line in rows:
        print(f"  {line}")
    check(proc.returncode == 0 and any(r.startswith("[ OK ] backend: ") for r in rows)
          and any(r.startswith("[ OK ] kernel build: ") for r in rows),
          f"doctor: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s, the card's "
          f"row and the kernel build's ok")


# The aot / start-up phase: fast_st convert-image and convert-dir with and
# without STX_AOT_CACHE=1 (CUDA graphs of the serving forward, utils/aot.py),
# the forward's wall time per batch on the graph and eagerly, cold and warm
# process start-up, STX_MATMUL_PRECISION=high against unset, native CRC32C.
AOT_IMAGES = 8
AOT_BATCHES = (1, 64)
AOT_TIMED = {1: 50, 64: 10}  # calls per timed turn
# STX_MATMUL_PRECISION=high (TF32 in cuDNN's convs) against TF32 off, on the
# f32 serving forward's uint8 output: TF32 keeps 10 bits of mantissa where
# bf16 keeps 7, so it is held to the bf16 serving limit of 16/255.
TF32_MAX_STEPS = 16
CRC_BYTES = 1 << 20
CRC_ROUNDS = 20

_STARTUP = r"""
import sys, time
t0 = float(sys.argv[1])
import numpy as np, torch
from styletransfer_tpu_torch import ckpt
from styletransfer_tpu_torch.engines import fast
from styletransfer_tpu_torch.ops.cuda import _build
from styletransfer_tpu_torch.utils import images
t_import = time.time()
params, _ = ckpt.load_latest_transformer("fast_st", "aot", sys.argv[2], "cuda")
x = torch.from_numpy(images.load_image_uint8(sys.argv[3], size=256)).cuda()
out = fast.make_serve_fn("f32")(params, x).cpu().numpy()[0]
t_forward = time.time()
images.save_uint8(out, sys.argv[4])
t_png = time.time()
print(_build.BUILD_DIR, t_import - t0, t_forward - t0, t_png - t0)
"""


def _pngs(np, root):
    """Every PNG under ``root``, by its path relative to it."""
    from PIL import Image

    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            out[os.path.relpath(path, root)] = np.asarray(Image.open(path))
    return out


def _startup(np, label, env, models, image, out_png):
    """A fresh ``python -c`` that loads the checkpoint, runs one f32 forward
    on the card and saves the PNG: seconds from its start to the import, the
    first forward's result on the host and the saved PNG."""
    full = dict(os.environ, **env)
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", _STARTUP, repr(t0), models, image, out_png],
                          cwd=ROOT, env=full, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"start-up {label}: exit {proc.returncode} "
          f"{proc.stderr[-2000:] if proc.returncode else ''}")
    build_dir, *spans = proc.stdout.split()[-4:]
    spans = [float(v) for v in spans]
    print(f"start-up {label}: kernels in {build_dir}; python -c start to import "
          f"{spans[0]:.3f} s, to the first forward {spans[1]:.3f} s, to the saved PNG "
          f"{spans[2]:.3f} s", flush=True)
    return build_dir, spans


def aot_phase(torch, np, card):
    """The aot / start-up phase. Returns each kernel's launches in the
    convert commands' runs, with the graphs and eagerly."""
    from styletransfer_tpu_torch import ckpt, constants, native
    from styletransfer_tpu_torch.clis import cli
    from styletransfer_tpu_torch.engines import fast
    from styletransfer_tpu_torch.models import transformer
    from styletransfer_tpu_torch.ops import layers
    from styletransfer_tpu_torch.ops.cuda import _build
    from styletransfer_tpu_torch.utils import aot, images, tb

    t_phase = time.perf_counter()
    root = os.path.join(WORK, "aot")
    in_dir = os.path.join(root, "images")
    os.makedirs(in_dir)
    rng = np.random.default_rng(7)
    from PIL import Image
    for i, img in enumerate(rng.integers(0, 256, (AOT_IMAGES, SIZE, SIZE, 3), dtype=np.uint8)):
        Image.fromarray(img).save(os.path.join(in_dir, f"img{i:03d}.png"))
    models = os.path.join(root, "data", "models")
    params = transformer.init_params(seed=0, device="cuda")
    ckpt.save(params, ckpt.checkpoint_path("fast_st", "aot", 0, models))
    per_forward = {"conv3x3_valid": 10, "instance_norm_pad": 15}
    launches = {}
    saved_root = constants.PROJECT_ROOT_PATH
    constants.PROJECT_ROOT_PATH = root
    try:
        # 1. The convert commands, eager and on graphs: the same PNGs.
        for precision in ("f32", "bf16"):
            outs = {}
            for flag in ("0", "1"):
                os.environ["STX_AOT_CACHE"] = flag
                aot.captures = aot.replays = 0
                reset_counts()
                out_dir = f"out_{precision}_{flag}"
                t0 = time.perf_counter()
                for args in (["convert-image", "images/img000.png", "aot", "-o", f"{out_dir}/image"],
                             ["convert-dir", "images", "aot", "-o", f"{out_dir}/dir"]):
                    cli.main(["fast_st", *args, "--precision", precision, "--device", "cuda"],
                             standalone_mode=False)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = read_counts()
                launches[(precision, flag)] = counts
                outs[flag] = _pngs(np, os.path.join(root, out_dir))
                # Two forwards (an image, a batch of AOT_IMAGES); on graphs
                # each is WARMUP eager runs and one capture, then a replay.
                forwards = 2 * (aot.WARMUP + 1) if flag == "1" else 2
                per = {**per_forward, "upconv_phase": UPCONV_PER_FORWARD[precision],
                       "conv9x9": CONV9X9_PER_FORWARD[precision]}
                got = {k: counts[k] for k in per}
                want = {k: v * forwards for k, v in per.items()}
                graphs = (aot.captures, aot.replays)
                check(got == want and graphs == ((2, 2) if flag == "1" else (0, 0))
                      and len(outs[flag]) == 1 + AOT_IMAGES,
                      f"aot {precision} STX_AOT_CACHE={flag}: convert-image and convert-dir "
                      f"({AOT_IMAGES} images) wrote {len(outs[flag])} PNGs in {wall:.3f} s; "
                      f"captures {graphs[0]}, replays {graphs[1]}; launches {got} (want {want})")
            diff = max(int(np.abs(outs["1"][k].astype(np.int32) - outs["0"][k]).max())
                       for k in outs["0"]) if sorted(outs["0"]) == sorted(outs["1"]) else -1
            check(diff == 0, f"aot {precision}: the graphs' PNGs are the eager ones bit for bit "
                  f"(max difference {diff}/255 over {len(outs['0'])} PNGs)")

        # 2. The forward's wall time per batch, graph and eager in turns.
        for precision in ("f32", "bf16"):
            serve_fn = fast.make_serve_fn(precision)
            for batch in AOT_BATCHES:
                x = torch.from_numpy(rng.integers(0, 256, (batch, SIZE, SIZE, 3),
                                                  dtype=np.uint8)).cuda()
                os.environ["STX_AOT_CACHE"] = "1"
                graphed = aot.cached_compile(serve_fn, (params, x), "smoke")
                same = bool(torch.equal(graphed(params, x), serve_fn(params, x)))
                check(graphed is not serve_fn and same,
                      f"aot {precision} batch {batch}: the graph's output is the eager one")
                times = {"eager": [], "graph": []}
                for turn in ("eager", "graph", "graph", "eager"):
                    fn = serve_fn if turn == "eager" else graphed
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(AOT_TIMED[batch]):
                        fn(params, x)
                    torch.cuda.synchronize()
                    times[turn].append((time.perf_counter() - t0) * 1e3 / AOT_TIMED[batch])
                print(f"aot {precision} batch {batch}: wall ms per forward, eager "
                      f"{'/'.join(f'{t:.3f}' for t in times['eager'])}, graph "
                      f"{'/'.join(f'{t:.3f}' for t in times['graph'])} on {card}", flush=True)
                del graphed

        # 3. STX_MATMUL_PRECISION=high against unset, on the f32 forward.
        x = torch.from_numpy(rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)).cuda()
        os.environ.pop("STX_MATMUL_PRECISION", None)
        serve_fn = fast.make_serve_fn("f32")
        flags_off = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        ref = serve_fn(params, x)
        ms_off = time_ms(torch, lambda: serve_fn(params, x), iters=10, warmup=2)
        os.environ["STX_MATMUL_PRECISION"] = "high"
        serve_fn = fast.make_serve_fn("f32")
        flags_on = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        got = serve_fn(params, x)
        y = transformer.apply(params, images.maybe_normalize_on_device(x))
        ms_on = time_ms(torch, lambda: serve_fn(params, x), iters=10, warmup=2)
        steps = (got.int() - ref.int()).abs()
        check(flags_off == (False, False) and flags_on == (True, True)
              and bool(torch.isfinite(y).all()) and int(steps.max()) <= TF32_MAX_STEPS,
              f"STX_MATMUL_PRECISION=high, f32 forward at batch {BATCH}: TF32 flags {flags_on} "
              f"(unset {flags_off}); uint8 output against TF32 off: max {int(steps.max())}/255, "
              f"mean {float(steps.float().mean()):.4f}/255 (limit {TF32_MAX_STEPS}), output "
              f"finite; {ms_on:.3f} ms against {ms_off:.3f} ms per forward on {card}")
    finally:
        os.environ.pop("STX_AOT_CACHE", None)
        os.environ.pop("STX_MATMUL_PRECISION", None)
        layers.disable_tf32()
        constants.PROJECT_ROOT_PATH = saved_root

    # 4. Start-up: a warm build cache, then none (every kernel the forward
    # runs built by nvcc in the process).
    image = os.path.join(in_dir, "img000.png")
    warm_dir, warm = _startup(np, "warm", {}, models, image, os.path.join(root, "warm.png"))
    cold_dir, cold = _startup(np, "cold (STX_NO_COMPILE_CACHE=1)",
                              {"STX_NO_COMPILE_CACHE": "1"}, models, image,
                              os.path.join(root, "cold.png"))
    check(warm_dir == _build.BUILD_DIR and cold_dir != warm_dir
          and not os.path.exists(cold_dir) and cold[1] > warm[1]
          and bool(np.array_equal(np.asarray(Image.open(os.path.join(root, "warm.png"))),
                                  np.asarray(Image.open(os.path.join(root, "cold.png"))))),
          f"start-up: warm from {warm_dir}, cold in a directory of its own (removed), "
          f"first forward cold {cold[1]:.3f} s against warm {warm[1]:.3f} s, the same PNG")

    # 5. Native CRC32C built here, against Python on CRC_BYTES bytes.
    native._crc32c_fn = None
    lib = native._build("crc32c.c")
    data = rng.integers(0, 256, CRC_BYTES, dtype=np.uint8).tobytes()
    want = tb._crc32c_py(data)
    native.crc32c(b"")
    t0 = time.perf_counter()
    for _ in range(CRC_ROUNDS):
        got = native.crc32c(data)
    mb_s = CRC_ROUNDS * CRC_BYTES / 1e6 / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    tb._crc32c_py(data)
    py_mb_s = CRC_BYTES / 1e6 / (time.perf_counter() - t0)
    check(lib is not None and native._crc32c_fn is not tb._crc32c_py and got == want,
          f"native CRC32C built ({os.path.basename(lib or '')}), {CRC_BYTES} bytes: "
          f"{got:#010x} as Python's; {mb_s:.1f} MB/s against Python's {py_mb_s:.2f} MB/s")
    print(f"aot / start-up phase took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches

# The Orbax slice: the committed fixture that the JAX package wrote, and
# static_train writing its epochs as .orbax directories (a few steps).
ORBAX_FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures", "seeded.orbax")
# Its arrays, made from the seed with numpy alone (the script that wrote the
# fixture, scripts/torch_make_orbax_fixture.py, needs JAX).
ORBAX_FIXTURE_ARRAYS = os.path.join(ROOT, "scripts", "torch_orbax_fixture_arrays.py")
ORBAX_TRAIN_STEPS = 3
# Saves and loads timed per format (the median is printed).
CKPT_TIMING_REPEATS = 5


def offline_sample_videos() -> None:
    """Point the sample-video download at a closed port on this machine.
    ``VideoDataset`` built from a directory first tries that download, as
    the JAX loader does; here it is refused at once and warns, and no
    request leaves the machine."""
    import socket

    from styletransfer_tpu_torch.data import download

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    download.SAMPLE_VIDEO_URLS = [f"http://127.0.0.1:{port}/sample/{u.rsplit('/', 1)[-1]}"
                                  for u in download.SAMPLE_VIDEO_URLS]


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _median_s(fn, repeats: int = CKPT_TIMING_REPEATS) -> float:
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def ckpt_phase(torch, np, in_dir, card):
    """The Orbax slice (phase 17). Returns each kernel's launches on its
    paths (static_train and process_dir from the .orbax epoch) and the host
    seconds it measured."""
    import importlib.util

    from PIL import Image

    from styletransfer_tpu_torch import ckpt, ckpt_orbax, native
    from styletransfer_tpu_torch.data import coco, download
    from styletransfer_tpu_torch.engines import fast
    from styletransfer_tpu_torch.models import transformer, vgg
    from styletransfer_tpu_torch.utils.logging import get_logger

    seconds = {}
    # A fresh build directory: the decoder is compiled here, whatever an
    # earlier run left under build/native.
    saved_build_dir = native.BUILD_DIR
    native.BUILD_DIR = os.path.join(WORK, "native")
    native._zstd_lib = None
    try:
        t0 = time.perf_counter()
        lib = native._build("zstd.c")
        seconds["zstd_build"] = time.perf_counter() - t0
        native.zstd_decompress(b"\x28\xb5\x2f\xfd\x20\x00\x01\x00\x00")  # loads it
    finally:
        native.BUILD_DIR = saved_build_dir
    check(lib is not None and lib.startswith(os.path.join(WORK, "native")),
          f"orbax: native/zstd.c built with cc into {lib} in {seconds['zstd_build']:.3f} s")
    spec = importlib.util.spec_from_file_location("orbax_fixture", ORBAX_FIXTURE_ARRAYS)
    fixture = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixture)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "styletransfer_tpu"))
    check(not loaded, f"orbax: the fixture's arrays loaded with no JAX in the process {loaded}")
    want = fixture.fixture_arrays()
    native.crc32c(b"")  # built and loaded apart from the timed load
    t0 = time.perf_counter()
    got = ckpt.load(ORBAX_FIXTURE)
    seconds["fixture_load"] = time.perf_counter() - t0
    # The decoder alone on the fixture's largest zstd chunk.
    chunk = max(ckpt_orbax.read_kvstore(ORBAX_FIXTURE).values(), key=len)
    plain = native.zstd_decompress(chunk)
    per_call = _median_s(lambda: native.zstd_decompress(chunk), repeats=21)
    seconds["zstd_mb_per_s"] = len(plain) / per_call / 1e6

    def leaves(tree, prefix=""):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                yield from leaves(tree[k], f"{prefix}{k}.")
            else:
                yield prefix + k, tree[k]

    got_leaves, want_leaves = dict(leaves(got)), dict(leaves(want))
    same = got_leaves.keys() == want_leaves.keys() and all(
        got_leaves[k].dtype == want_leaves[k].dtype and got_leaves[k].shape ==
        want_leaves[k].shape and np.array_equal(got_leaves[k], want_leaves[k])
        for k in want_leaves)
    nbytes = sum(v.nbytes for v in want_leaves.values())
    check(same, f"orbax: the JAX-written fixture's {len(want_leaves)} arrays ({nbytes} bytes, "
          f"the largest {max(v.nbytes for v in want_leaves.values())}) decoded bit for bit "
          f"as numpy's from seed {fixture.SEED} in {seconds['fixture_load']:.4f} s; the zstd "
          f"decoder alone {seconds['zstd_mb_per_s']:.1f} MB/s out on a {len(chunk)}-byte frame "
          f"of {len(plain)} bytes")

    style = _style_image(np)
    vgg_params = vgg.init_params(seed=0, device="cuda")
    models = os.path.join(WORK, "models_orbax")
    saved_backend = os.environ.get("STX_CKPT_BACKEND")
    os.environ["STX_CKPT_BACKEND"] = "orbax"
    launches = {}
    log = _Messages()
    logger = get_logger()
    logger.addHandler(log)
    try:
        def train(params):
            test_loader, train_loader = coco.get_coco_loader(
                batch_size=TRAIN_BATCH, test_limit=8, image_dir=os.path.join(WORK, "no_images"))
            return fast.static_train(
                style, style_name="smoke", epochs=1, batch_size=TRAIN_BATCH,
                vgg_params=vgg_params, params=params, train_loader=train_loader,
                test_loader=test_loader, log_cadence=(1, 1000, 1000),
                runs_dir=os.path.join(WORK, "runs_orbax"), models_path=models,
                max_steps_per_epoch=ORBAX_TRAIN_STEPS, precision="f32", device="cuda")

        params = transformer.init_params(seed=0, device="cuda")
        reset_counts()
        before = graph_counts()
        train(params)
        torch.cuda.synchronize()
        passes = step_passes(ORBAX_TRAIN_STEPS, graphed_since(before))
        launches["static_train"] = counts = read_counts()
        epoch_dir = ckpt.checkpoint_path("fast_st", "smoke", 0, models)
        check(epoch_dir.endswith(".orbax") and os.path.isdir(epoch_dir)
              and sorted(os.listdir(models)) == [os.path.basename(epoch_dir)],
              f"orbax: static_train under STX_CKPT_BACKEND=orbax wrote {sorted(os.listdir(models))}"
              f" (one .orbax epoch directory)")
        check(counts["fused_instance_norm_bwd"] == NORMS_PER_FORWARD * passes
              and counts["fused_instance_norm_fwd"] >= NORMS_PER_FORWARD * passes,
              f"orbax: static_train {ORBAX_TRAIN_STEPS} steps ({passes} passes) launched "
              f"{counts['fused_instance_norm_fwd']} fused-IN forwards and "
              f"{counts['fused_instance_norm_bwd']} backwards")
        path, epoch = ckpt.find_latest("fast_st", "smoke", models)
        trained, epoch = ckpt.load_latest_transformer("fast_st", "smoke", models, device="cuda")
        check(path == epoch_dir and epoch == 0 and all(
            torch.equal(a, b) for a, b in zip(trained.parameters(), params.parameters())),
            f"orbax: load_latest_transformer picked {os.path.basename(path)} (epoch {epoch}); "
            f"the trained parameters bit for bit")

        # The same parameters as .msgpack, then both through process_dir.
        msgpack_models = os.path.join(WORK, "models_msgpack")
        ckpt.save(params, os.path.join(msgpack_models, "fast_st_smoke_epoch0.msgpack"))
        outs = {}
        for fmt, where in (("orbax", models), ("msgpack", msgpack_models)):
            reset_counts()
            paths = fast.process_dir(in_dir, "smoke", out_dir=os.path.join(WORK, f"ckpt_{fmt}"),
                                     batch_size=BATCH, models_path=where, precision="f32",
                                     device="cuda")
            launches[f"process_dir_{fmt}"] = counts = read_counts()
            want_counts = {k: 0 for k in counts}
            want_counts.update({"conv3x3_valid": 10, "conv3x3_valid.f32_fma": 10,
                                "instance_norm_pad": 15, "upconv_phase": UPCONV_PER_FORWARD["f32"],
                                "conv9x9": CONV9X9_PER_FORWARD["f32"]})
            check(counts == want_counts,
                  f"orbax: process_dir from the .{fmt} epoch launched {counts} (want 10 "
                  f"conv3x3 on the f32_fma route, 15 IN-pad and "
                  f"{UPCONV_PER_FORWARD['f32']} upconv_phase per forward)")
            outs[fmt] = {os.path.basename(p): open(p, "rb").read() for p in paths}
        pixels_same = outs["orbax"].keys() == outs["msgpack"].keys() and all(
            np.array_equal(np.asarray(Image.open(os.path.join(WORK, "ckpt_orbax", n))),
                           np.asarray(Image.open(os.path.join(WORK, "ckpt_msgpack", n))))
            for n in outs["orbax"])
        check(len(outs["orbax"]) == BATCH and outs["orbax"] == outs["msgpack"] and pixels_same,
              f"orbax: process_dir's {len(outs['orbax'])} PNGs from the .orbax epoch are byte "
              f"for byte those from the .msgpack one")

        del log.messages[:]
        reset_counts()
        again = train(transformer.init_params(seed=1, device="cuda"))
        skipped = read_counts()
        check(any("Epoch 0 checkpoint exists; skipping" in m for m in log.messages)
              and skipped["fused_instance_norm_bwd"] == 0 and all(
                  torch.equal(a, b) for a, b in zip(again.parameters(), params.parameters())),
              "orbax: a second static_train skipped the finished .orbax epoch (no backward "
              "launched; its parameters are the epoch's)")
    finally:
        logger.removeHandler(log)
        if saved_backend is None:
            os.environ.pop("STX_CKPT_BACKEND", None)
        else:
            os.environ["STX_CKPT_BACKEND"] = saved_backend

    # Host seconds to save and load the epoch (1.7 M float32) in each format.
    timing = os.path.join(WORK, "ckpt_timing")
    tree = transformer.params_to_tree(params)
    for fmt in ("msgpack", "orbax"):
        target = os.path.join(timing, f"fast_st_time_epoch0.{fmt}")
        seconds[f"save_{fmt}"] = _median_s(lambda: ckpt.save(params, target))
        seconds[f"load_{fmt}"] = _median_s(lambda: ckpt.load(target))
        back = ckpt.load(target)
        check(all(np.array_equal(a, b) for (_, a), (_, b) in
                  zip(leaves(back), leaves(tree))),
              f"orbax: the {fmt} epoch saved in {seconds[f'save_{fmt}']:.4f} s and loaded in "
              f"{seconds[f'load_{fmt}']:.4f} s (median of {CKPT_TIMING_REPEATS}), bit for bit")

    # The sample-video download, refused by a closed local port.
    del log.messages[:]
    logger.addHandler(log)
    try:
        t0 = time.perf_counter()
        download.download_videos_dataset()
        seconds["download_videos_offline"] = time.perf_counter() - t0
    finally:
        logger.removeHandler(log)
    check(any("Could not download sample videos" in m for m in log.messages),
          f"orbax: download_videos_dataset warned and returned in "
          f"{seconds['download_videos_offline']:.4f} s (HEAD refused by a closed local port)")
    print("orbax slice host seconds: " + ", ".join(f"{k} {v:.4f}" for k, v in seconds.items())
          + f" on {card}", flush=True)
    return launches, seconds


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
            _build, conv3x3, conv3x3_flat, conv9x9, conv_direct, fused_instance_norm,
            instance_norm, upconv_phase)
    except ImportError as exc:
        print(f"chip_smoke: run it from a checkout of the repository ({exc})",
              file=sys.stderr)
        return 1
    offline_sample_videos()
    if sys.argv[1:2] == ["--rank-worker"]:  # one rank of two_rank_phase
        return rank_worker(torch, np, sys.argv[2], sys.argv[3])

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
            upconv_phase_phase(torch, F, upconv_phase)
            conv9x9_phase(torch, F, conv9x9)
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
                fused_affine_phase(torch, fused_instance_norm, dtype)
            check_routes(instance_norm, norms)
            print(card)
            return 0
        if sys.argv[1:] == ["--multi"]:
            for dtype in (torch.float32, torch.bfloat16):
                fused_affine_phase(torch, fused_instance_norm, dtype)
            in_dir, _ = write_inputs(np)
            multistyle_slice(torch, np, in_dir)
            print(card)
            return 0
        if sys.argv[1:] == ["--serve"]:
            in_dir, _ = write_inputs(np)
            network_slice(torch, np, F, in_dir)
            print(card)
            return 0
        if sys.argv[1:] == ["--parallel"]:
            in_dir, _ = write_inputs(np)
            parallel_slice(torch, np, in_dir, card)
            print(card)
            return 0
        if sys.argv[1:] == ["--packed"]:
            packed_path(torch, np)
            print(card)
            return 0
        if sys.argv[1:] == ["--zoom"]:
            zoom_path(torch, np, F)
            doctor_phase(torch)
            print(card)
            return 0
        if sys.argv[1:] == ["--aot"]:
            aot_phase(torch, np, card)
            print(card)
            return 0
        if sys.argv[1:] == ["--adain"]:
            upconv_phase_phase(torch, F, upconv_phase)
            adain_kernels(torch, F)
            adain_path(torch, np)
            print(card)
            return 0
        if sys.argv[1:] == ["--ckpt"]:
            in_dir, _ = write_inputs(np)
            ckpt_phase(torch, np, in_dir, card)
            print(card)
            return 0
        entries = []
        per_image = {}
        for dtype in (torch.float32, torch.bfloat16):
            entries += conv_phase(torch, F, conv3x3, dtype)
            entries.append(in_phase(torch, instance_norm, dtype))
            entries += fused_phase(torch, F, fused_instance_norm, dtype)
            per_image[dtype] = fused_affine_phase(torch, fused_instance_norm, dtype)
            entries += stat_free_phase(torch, F, conv3x3_flat, dtype)
            entries.append(direct_phase(torch, F, conv_direct, dtype))
        entries.append(upconv_phase_phase(torch, F, upconv_phase))
        entries.append(conv9x9_phase(torch, F, conv9x9))
        check_routes(instance_norm, entries)
        in_dir, imgs = write_inputs(np)
        serve_launches, rates = main_path(torch, np, in_dir, imgs)
        multi_launches = multistyle_phase(torch, np, instance_norm, in_dir)
        adain_entries = adain_kernels(torch, F)
        adain_launches, adain_rate = adain_path(torch, np)
        train_launches = train_path(torch, np, in_dir)
        parity_phase(torch, np)
        step_rate = step_rates(torch, np)
        train_multi, daemon_launches, daemon_rates = multistyle_slice(torch, np, in_dir)
        gatys_launches = gatys_path(torch, np, F)
        gatys_parity(torch, np)
        packed_launches, packed_rates = packed_path(torch, np)
        zoom_launches, zoom_seconds, zoom_closures, zoom_daemon, zoom_daemon_s = zoom_path(
            torch, np, F)
        doctor_phase(torch)
        aot_launches = aot_phase(torch, np, card)
        ckpt_launches, ckpt_seconds = ckpt_phase(torch, np, in_dir, card)
        video_entries, video_launches, zeros_rates = video_phase(torch, np, F, conv3x3_flat,
                                                                 in_dir, imgs)
        entries += video_entries
        net_launches, net_rates = network_slice(torch, np, F, in_dir)
        par_train, par_placed = parallel_slice(torch, np, in_dir, card)
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
        if kernel in TRAINING_KERNELS:  # also with [N, C] affines (train-multi)
            e["train_multi_launches"] = train_multi[precision][kernel]
            totals = per_image[torch.float32 if precision == "f32" else torch.bfloat16]
            part = "fwd" if kernel.endswith("fwd") else "bwd"
            e["per_image_step_ms"] = totals[f"{part}_ms"]
            e["per_image_step_shared_ms"] = totals[f"{part}_shared_ms"]
            e["per_image_step_bound_ms"] = totals[f"{part}_bound_ms"]
        if kernel in SERVING_KERNELS:  # the stdin daemons
            e["daemon_launches"] = {f"{d}": counts[kernel] for (d, p), counts in
                                    daemon_launches.items() if p == precision}
        if kernel == "conv3x3_valid":  # the route of the 256 px serving run
            kernel = "conv3x3_valid." + ("f32_fma" if precision == "f32" else "bf16_wgmma")
        path = (serve_launches if kernel.startswith(SERVING_KERNELS) else
                gatys_launches if kernel in GATYS_KERNELS else train_launches)
        e["launches"] = path[precision][kernel]
        if kernel == "conv9x9":  # also the training path's forwards and input gradients
            e["train_launches"] = train_launches[precision][kernel]
        if precision == "f32" and kernel in ADAIN_PER_FORWARD:  # one AdaIN forward
            e["adain_launches"] = adain_launches[kernel]
    for e in entries:  # each kernel's launches in the network slice's daemons
        kernel, dn = e["name"].split(".")
        precision = "f32" if dn == "float32" else "bf16"
        counter = {"conv3x3_flat_residual": "conv3x3_flat", "conv3x3_valid_wide": "conv3x3_valid",
                   "conv3x3_valid_widest": "conv3x3_valid",
                   "conv3x3_valid_mma": "conv3x3_valid.bf16_mma"}.get(kernel, kernel)
        e["network_launches"] = {
            **{f"fast_{t}": c[counter] for (t, p), c in net_launches["transports"].items()
               if p == precision},
            **{f"video_serve_{pad}_b{b}": c[counter]
               for (pad, p, b), c in net_launches["video_serve"].items() if p == precision},
            **{f"gatys_serve_b{b}": c[counter]
               for (p, b), c in net_launches["gatys_serve"].items() if p == precision}}
    for e in entries:  # each kernel's launches on the multi-GPU slice's paths
        kernel, dn = e["name"].split(".")
        precision = "f32" if dn == "float32" else "bf16"
        counter = {"conv3x3_flat_residual": "conv3x3_flat", "conv3x3_valid_wide": "conv3x3_valid",
                   "conv3x3_valid_widest": "conv3x3_valid",
                   "conv3x3_valid_mma": "conv3x3_valid.bf16_mma"}.get(kernel, kernel)
        e["parallel_launches"] = {
            "rank0_train_step": par_train[precision][counter],
            **{f"placement_{path}": c[counter] for (path, p), c in par_placed.items()
               if p == precision}}
    for e in entries:  # each kernel's launches on the --packed and lbfgs-zoom paths
        kernel, dn = e["name"].split(".")
        precision = "f32" if dn == "float32" else "bf16"
        counter = {"conv3x3_flat_residual": "conv3x3_flat", "conv3x3_valid_wide": "conv3x3_valid",
                   "conv3x3_valid_widest": "conv3x3_valid",
                   "conv3x3_valid_mma": "conv3x3_valid.bf16_mma"}.get(kernel, kernel)
        e["packed_launches"] = {"static_train": packed_launches[precision][counter],
                                "train_multi_f32": packed_launches["train_multi"][counter]}
        e["zoom_launches"] = {"gatys_st": zoom_launches[precision][counter],
                              **{f"gatys_serve_b{b}": c[counter]
                                 for (p, b), c in zoom_daemon.items() if p == precision}}
    for e in entries:  # each kernel's launches in the aot phase's convert commands
        kernel, dn = e["name"].split(".")
        precision = "f32" if dn == "float32" else "bf16"
        counter = {"conv3x3_flat_residual": "conv3x3_flat", "conv3x3_valid_wide": "conv3x3_valid",
                   "conv3x3_valid_widest": "conv3x3_valid",
                   "conv3x3_valid_mma": "conv3x3_valid.bf16_mma"}.get(kernel, kernel)
        e["aot_launches"] = {"convert_graph": aot_launches[(precision, "1")][counter],
                             "convert_eager": aot_launches[(precision, "0")][counter]}
        # The Orbax slice runs in f32 only: its launches stand on the f32 entries.
        if precision == "f32":
            route = "conv3x3_valid.f32_fma" if counter == "conv3x3_valid" else counter
            e["ckpt_launches"] = {path: c[route] for path, c in ckpt_launches.items()}
    for e in adain_entries:  # each kernel's launches in one AdaIN forward
        e["launches"] = adain_launches[e.pop("counter")]
    entries += adain_entries
    unused = [e["name"] for e in entries if e["launches"] == 0 and "forced" not in e]
    if unused:
        print(f"chip_smoke: FAILED: {unused} launched no time on their main path",
              file=sys.stderr)
        return 1
    kind = torch.cuda.get_device_name(0)
    print(f"serving path img/s at batch {BATCH}, 256 px: f32 {rates['f32']:.1f}, "
          f"bf16 {rates['bf16']:.1f} on {card}")
    print(f"AdaIN serving img/s at {ADAIN_BATCH} pairs, {ADAIN_SIZE} px: f32 {adain_rate:.1f} "
          f"on {card}")
    print(f"zeros path img/s at batch {BATCH}, 256 px: f32 {zeros_rates['f32']:.1f}, "
          f"bf16 {zeros_rates['bf16']:.1f} on {card}")
    print("daemons requests/s at batch %d: " % DAEMON_BATCH + ", ".join(
        f"{d} {p} {r:.1f}" for (d, p), r in daemon_rates.items()) + f" on {card}")
    print("fast_st serve requests/s at batch %d: " % DAEMON_BATCH + ", ".join(
        f"{t} {p} {r:.1f}" for (t, p), r in net_rates["transports"].items()) + f" on {card}")
    print("video_st serve frames/s: " + ", ".join(
        f"{p} {pad} b{b} {r:.1f}" for (pad, p, b), r in net_rates["video_serve"].items())
        + f" on {card}")
    print(f"gatys_st --serve s per request at {GATYS_SIZE} px, {GATYS_SERVE_STEPS} steps: " +
          ", ".join(f"{p} b{b} {r:.3f}" for (p, b), r in net_rates["gatys_serve"].items())
          + f" on {card}")
    print(f"lbfgs-zoom s per image at {GATYS_SIZE} px: " + ", ".join(
        f"{k} {v:.2f} (closures per step mean {np.mean(zoom_closures[k]):.2f}, max "
        f"{max(zoom_closures[k])})" for k, v in zoom_seconds.items()) + f" on {card}")
    print(f"gatys_st --serve --optimizer lbfgs-zoom s per request, {GATYS_SERVE_STEPS} steps: "
          + ", ".join(f"{p} b{b} {r:.3f}" for (p, b), r in zoom_daemon_s.items()) + f" on {card}")
    print(f"training loop ms per step at batch {TRAIN_BATCH}, packed / synthetic corpus: " +
          ", ".join(f"{p} {c} {'/'.join(f'{v:.3f}' for v in r)}"
                    for (p, c), r in packed_rates.items()) + f" on {card}")
    print("training img/s at 256 px: " + ", ".join(
        f"{p} batch {b} {r:.1f}" for (p, b), r in step_rate.items()) + f" on {card}")
    print("orbax slice host seconds: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                                  ckpt_seconds.items()) + f" on {card}")
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s after the import")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
