#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU and ``nvcc``.
It imports nothing of JAX. Phases:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``styletransfer_tpu_torch/csrc`` (``sm_90a``);
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes (batch 64, 256 px images) in f32 and bf16, and time
   the kernel, the plain version and, for the conv, one ``F.conv2d``;
4. drive the main path, fast_st inference: a seeded checkpoint written with
   ``ckpt.save``, 64 seeded 256x256 PNGs, ``engines.fast.process_dir`` from
   the checkpoint load to the saved PNGs, in f32 and bf16. The kernels'
   launch counters must show 10 conv3x3 and 15 IN-pad launches per forward,
   and the first two outputs must match the port's own CPU run;
5. print one JSON line with each kernel's error, launches and times, and as
   the last line ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero and prints no ``ok`` line; so does a machine
without a GPU, or a directory without the package. Scratch files go to
``build/smoke/`` in the checkout.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "smoke")
BATCH = 64
SIZE = 256

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
}
# The conv's f32 sums over 4096 pixels: another summation order.
SUMS_TOL = (1e-4, 1e-2)
# Main path against the port's CPU run, in 1/255 steps of the uint8 output.
# f32: one step (rounding of values that land near a half step). bf16 (card
# bf16 against CPU bf16): 8-bit mantissas rounded at other places through
# some twenty layers drift a few steps; the mean must stay under one.
MAIN_TOL = {"f32": (1, 0.05), "bf16": (16, 1.0)}  # (max steps, mean steps)

SOURCES = {
    "conv3x3_valid": ("styletransfer_tpu_torch/csrc/conv3x3.cu",
                      "styletransfer_tpu/ops/pallas/conv3x3.py:192"),
    "instance_norm_pad": ("styletransfer_tpu_torch/csrc/instance_norm.cu",
                          "styletransfer_tpu/ops/pallas/instance_norm.py:229"),
}


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


def bound(flops: float, nbytes: float, dtype: str):
    """Least time on the card in ms, and what bounds it."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def allclose(torch, a, b, rtol, atol) -> bool:
    return bool(torch.all((a.float() - b.float()).abs() <= atol + rtol * b.float().abs()))


def conv_phase(torch, F, conv3x3, dtype):
    """conv3x3 kernel vs its plain version at the residual convs' shape."""
    name = "conv3x3_valid"
    dn = str(dtype).split(".")[1]
    g = torch.Generator(device="cuda").manual_seed(1)
    H = W = SIZE // 4
    C = O = 128
    x = torch.randn(BATCH, H + 2, W + 2, C, device="cuda", generator=g).to(dtype)
    bnd = 1.0 / (9 * C) ** 0.5
    w = ((torch.rand(3, 3, C, O, device="cuda", generator=g) * 2 - 1) * bnd).to(dtype)
    b = (torch.rand(O, device="cuda", generator=g) * 2 - 1) * bnd
    out, s, ss = conv3x3.conv3x3_valid(x, w, b)
    torch.cuda.synchronize()
    pout, ps, pss = conv3x3.conv3x3_valid_plain(x, w, b)
    rtol, atol = TOL[(name, dn)]
    err = max_err(out, pout)
    check(allclose(torch, out, pout, rtol, atol),
          f"{name} {dn} [{BATCH},{H + 2},{W + 2},{C}]: max_abs_err {err:.3g} "
          f"(rtol {rtol:.3g}, atol {atol:.3g})")
    check(allclose(torch, s, ps, *SUMS_TOL) and allclose(torch, ss, pss, *SUMS_TOL),
          f"{name} {dn} sums/sumsqs: max_abs_err {max_err(s, ps):.3g} / "
          f"{max_err(ss, pss):.3g} (rtol {SUMS_TOL[0]}, atol {SUMS_TOL[1]})")
    ms = time_ms(torch, lambda: conv3x3.conv3x3_valid(x, w, b))
    plain_ms = time_ms(torch, lambda: conv3x3.conv3x3_valid_plain(x, w, b))
    xc = x.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    bc = b.to(dtype)
    library_ms = time_ms(torch, lambda: F.conv2d(xc, wc, bc))
    flops = 2.0 * BATCH * H * W * 9 * C * O
    nbytes = (x.numel() + w.numel() + out.numel()) * x.element_size() + (O + 2 * BATCH * O) * 4
    bound_ms, bound_by = bound(flops, nbytes, dn)
    print(f"{name} {dn}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
          f"{library_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}; {flops / 1e9:.1f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB) achieved {flops / ms / 1e9:.1f} TFLOP/s", flush=True)
    return {"name": f"{name}.{dn}", "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "shape": f"x[{BATCH},{H + 2},{W + 2},{C}] w[3,3,{C},{O}]"}


# The fifteen instance norms of one forward at 256 px: (name, H, C, pad,
# residual pad or None, relu, mode, stats from the conv, calls per forward).
_IN_CALLS = [
    ("in1", 256, 32, 1, None, True, "reflect", False, 1),
    ("in2", 128, 64, 1, None, True, "reflect", False, 1),
    ("in3", 64, 128, 1, None, True, "reflect", False, 1),
    ("res.in1", 64, 128, 1, None, True, "reflect", True, 5),
    ("res.in2", 64, 128, 1, 1, False, "reflect", False, 4),
    ("res5.in2", 64, 128, 1, 1, False, "edge", False, 1),
    ("up1_in", 128, 64, 1, None, True, "edge", False, 1),
    ("up2_in", 256, 32, 4, None, True, "reflect", False, 1),
]


def in_phase(torch, instance_norm, dtype):
    """IN-pad kernel vs its plain version at every call shape of the forward;
    the JSON entry times the largest call (in1)."""
    name = "instance_norm_pad"
    dn = str(dtype).split(".")[1]
    rtol, atol = TOL[(name, dn)]
    g = torch.Generator(device="cuda").manual_seed(2)
    entry = None
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    worst = 0.0
    for call, H, C, pad, rp, relu, mode, with_stats, count in _IN_CALLS:
        x = (torch.randn(BATCH, H, H, C, device="cuda", generator=g) * 2 + 0.5).to(dtype)
        scale = torch.rand(C, device="cuda", generator=g) + 0.5
        bias = torch.randn(C, device="cuda", generator=g)
        res = None
        if rp is not None:
            res = torch.randn(BATCH, H + 2 * rp, H + 2 * rp, C, device="cuda",
                              generator=g).to(dtype)
        stats = None
        if with_stats:
            xf = x.float()
            stats = (xf.sum(dim=(1, 2)), (xf * xf).sum(dim=(1, 2)))
        args = (x, scale, bias, res, rp or 0, relu, pad, mode, stats)
        out = instance_norm.instance_norm_pad(*args)
        torch.cuda.synchronize()
        pout = instance_norm.instance_norm_pad_plain(*args)
        err = max_err(out, pout)
        worst = max(worst, err)
        check(allclose(torch, out, pout, rtol, atol),
              f"{name} {dn} {call} [{BATCH},{H},{H},{C}] pad {pad} {mode}: max_abs_err "
              f"{err:.3g} (rtol {rtol:.3g}, atol {atol:.3g})")
        ms = time_ms(torch, lambda: instance_norm.instance_norm_pad(*args), iters=10)
        plain_ms = time_ms(torch, lambda: instance_norm.instance_norm_pad_plain(*args), iters=5)
        interior = x.numel() * (2 if res is not None else 1)
        nbytes = (interior + out.numel()) * x.element_size() + 2 * C * 4
        nbytes += 0 if stats is None else 2 * BATCH * C * 4
        bound_ms, bound_by = bound(8.0 * x.numel(), nbytes, dn)
        print(f"{name} {dn} {call}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"bound_ms {bound_ms:.4f} ({bound_by}; {nbytes / 1e6:.1f} MB) "
              f"x{count} per forward", flush=True)
        total["ms"] += ms * count
        total["plain_ms"] += plain_ms * count
        total["bound_ms"] += bound_ms * count
        if entry is None:
            entry = {"name": f"{name}.{dn}", "route": "cuda", "source": SOURCES[name][0],
                     "replaces": SOURCES[name][1], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                     "shape": f"x[{BATCH},{H},{H},{C}] pad {pad} (in1, the largest call)"}
    entry["max_abs_err"] = worst
    print(f"{name} {dn}: all 15 calls of one forward: kernel_ms {total['ms']:.4f} "
          f"plain_ms {total['plain_ms']:.4f} bound_ms {total['bound_ms']:.4f}", flush=True)
    entry["forward_ms"] = total["ms"]
    entry["forward_bound_ms"] = total["bound_ms"]
    return entry


def write_inputs(np):
    from PIL import Image

    in_dir = os.path.join(WORK, "images")
    os.makedirs(in_dir, exist_ok=True)
    imgs = np.random.default_rng(0).integers(0, 256, size=(BATCH, SIZE, SIZE, 3),
                                             dtype=np.uint8)
    for i, img in enumerate(imgs):
        Image.fromarray(img).save(os.path.join(in_dir, f"img{i:03d}.png"))
    return in_dir, imgs


def main_path(torch, np, conv3x3, instance_norm):
    """fast_st inference through process_dir, from a seeded checkpoint."""
    from PIL import Image

    from styletransfer_tpu_torch import ckpt
    from styletransfer_tpu_torch.engines import fast
    from styletransfer_tpu_torch.models import transformer
    from styletransfer_tpu_torch.utils import images

    models = os.path.join(WORK, "models")
    params = transformer.init_params(seed=0, device="cuda")
    ckpt.save(params, ckpt.checkpoint_path("fast_st", "smoke", 0, models))
    in_dir, imgs = write_inputs(np)
    cpu_params, _ = ckpt.load_latest_transformer("fast_st", "smoke", models, device="cpu")
    launches = {}
    rates = {}
    for precision in ("f32", "bf16"):
        out_dir = os.path.join(WORK, f"out_{precision}")
        conv3x3.launches = 0
        instance_norm.launches = 0
        t0 = time.perf_counter()
        paths = fast.process_dir(in_dir, "smoke", out_dir=out_dir, batch_size=BATCH,
                                 models_path=models, precision=precision, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = (conv3x3.launches, instance_norm.launches)
        launches[precision] = counts
        check(counts == (10, 15),
              f"main path {precision}: one forward launched {counts[0]} conv3x3 and "
              f"{counts[1]} IN-pad kernels (want 10 and 15)")
        check(len(paths) == BATCH, f"main path {precision}: {len(paths)} PNGs written")
        outs = np.stack([np.asarray(Image.open(p)) for p in sorted(paths)])
        check(outs.shape == (BATCH, SIZE, SIZE, 3) and outs.dtype == np.uint8,
              f"main path {precision}: outputs {outs.shape} {outs.dtype}")
        # The CPU run of the port on the first two images.
        serve = fast.make_serve_fn(precision)
        ref = serve(cpu_params, torch.from_numpy(imgs[:2])).numpy()
        diff = np.abs(outs[:2].astype(np.int32) - ref.astype(np.int32))
        max_steps, mean_steps = MAIN_TOL[precision]
        check(int(diff.max()) <= max_steps and float(diff.mean()) <= mean_steps,
              f"main path {precision}: card vs CPU on 2 images: max {int(diff.max())}/255, "
              f"mean {float(diff.mean()):.4f}/255 (limits {max_steps}, {mean_steps})")
        # The float output before the uint8 cast (which would hide a NaN).
        batch = torch.from_numpy(imgs).cuda()
        y = transformer.apply(params, images.maybe_normalize_on_device(batch),
                              compute_dtype=torch.bfloat16 if precision == "bf16" else None)
        check(y.shape == (BATCH, SIZE, SIZE, 3) and bool(torch.isfinite(y).all()),
              f"main path {precision}: forward output {tuple(y.shape)}, all finite")
        # Steady-state serving rate of the forward at batch 64 on the card.
        out = serve(params, batch)
        same = int((out.cpu().int() - torch.from_numpy(outs).int()).abs().max())
        check(same <= 1, f"main path {precision}: serve_fn within {same}/255 of the saved PNGs")
        ms = time_ms(torch, lambda: serve(params, batch), iters=10, warmup=2)
        rates[precision] = BATCH / (ms / 1e3)
        print(f"main path {precision}: process_dir {BATCH} images in {wall:.3f} s "
              f"(incl. checkpoint load, decode, PNG encode); serve_fn batch {BATCH}: "
              f"{ms:.3f} ms = {rates[precision]:.1f} img/s", flush=True)
    return launches, rates


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
        from styletransfer_tpu_torch.ops.cuda import _build, conv3x3, instance_norm
    except ImportError as exc:
        print(f"chip_smoke: run it from a checkout of the repository ({exc})",
              file=sys.stderr)
        return 1

    card = gpu_line()
    print(card, flush=True)
    layers.disable_tf32()
    shutil.rmtree(WORK, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        built = _build.build_all()
        print(f"built {built} with {' '.join(_build.NVCC_FLAGS)} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        for src, log in _build.build_logs.items():
            for line in log.splitlines():
                if "Used" in line or "spill" in line:
                    print(f"  {src}: {line.strip()}")
        entries = []
        for dtype in (torch.float32, torch.bfloat16):
            entries.append(conv_phase(torch, F, conv3x3, dtype))
            entries.append(in_phase(torch, instance_norm, dtype))
        launches, rates = main_path(torch, np, conv3x3, instance_norm)
    except CheckFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    for e in entries:
        kernel, dn = e["name"].split(".")
        e["launches"] = launches["f32" if dn == "float32" else "bf16"][
            0 if kernel == "conv3x3_valid" else 1]
    kind = torch.cuda.get_device_name(0)
    print(f"main path img/s at batch {BATCH}, 256 px: f32 {rates['f32']:.1f}, "
          f"bf16 {rates['bf16']:.1f} on {card}")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
