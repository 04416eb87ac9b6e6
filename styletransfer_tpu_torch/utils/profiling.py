"""Where the time of the fast_st forward, of a training step, or of a
Gatys closure and L-BFGS step goes on the GPU.

    python -m styletransfer_tpu_torch.utils.profiling [--batch 64] [--size 256]
    python -m styletransfer_tpu_torch.utils.profiling --train [--batch 4]
    python -m styletransfer_tpu_torch.utils.profiling --gatys [--size 256]

Runs ``engines.fast.make_serve_fn`` (with ``--train``, the train step of
``engines.fast.make_train_step``: forward, backward and Adam; with
``--gatys``, one Gatys closure, the loss and pixel gradient of
``engines.gatys.make_loss_fn``, and one outer L-BFGS step of
``engines.gatys._run_lbfgs_torch``, up to 20 closures with the history math,
at batch 1) on seeded parameters and inputs on the card, in f32 and bf16,
under ``torch.profiler``, and prints the device time of each kernel and of
each group of kernels (the port's kernels, cuDNN's convolutions, matrix
products, the optimizer, everything else), the wall time per call (without
the profiler, and under it) and the share of it in which the device ran no
kernel. The last line is one JSON object with the same numbers. Needs a CUDA
GPU; fails without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from typing import Dict

import numpy as np
import torch

from styletransfer_tpu_torch.engines import fast, gatys
from styletransfer_tpu_torch.models import transformer, vgg

# First match wins. The IN kernel serves both the IN-pad of the serving
# forward and the fused-IN forward of the training forward.
_GROUPS = (
    ("conv3x3_flat kernel", ("conv3x3_flat_",)),
    ("conv3x3_im2col kernel", ("conv3x3_im2col_",)),
    ("conv3x3 kernel", ("conv3x3_", "tile_sums_kernel")),
    ("IN kernel (IN-pad / fused-IN forward)", ("::in_kernel<",)),
    ("fused-IN backward kernel", ("::inb_kernel<",)),
    ("conv_direct kernel", ("::direct_kernel<",)),
    ("cuDNN convolutions", ("conv", "cudnn", "implicit", "winograd", "fft", "fprop", "dgrad",
                            "wgrad", "pointwise_mult_and_sum")),
    ("matrix-vector products and solves (L-BFGS history)", ("gemv", "trsm")),
    ("matrix products (Gram)", ("gemm", "cutlass")),
    ("optimizer (Adam)", ("multi_tensor", "adam")),
)


def _group(kernel_name: str) -> str:
    name = kernel_name.lower()
    for group, keys in _GROUPS:
        if any(k in name for k in keys):
            return group
    return "other (copies, pads, elementwise)"


WARMUP = 2


def _wall_ms(run, iters: int) -> float:
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _profile(run, batch: int, iters: int) -> Dict:
    """Profile ``iters`` calls of ``run`` after a warm-up; device times in ms
    per call. ``wall_ms`` and the idle share come from ``iters`` calls
    without the profiler (which adds host time of its own to every launch);
    ``profiled_wall_ms`` is the wall time under it."""
    for _ in range(WARMUP):
        run()
    torch.cuda.synchronize()
    wall_ms = _wall_ms(run, iters)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        profiled_wall_ms = _wall_ms(run, iters)
    kernels: Dict[str, float] = defaultdict(float)
    launches: Dict[str, int] = defaultdict(int)
    for ev in prof.events():
        # Device-side spans of record_function ranges (an optimizer step)
        # cover kernels counted on their own.
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
            kernels[ev.name] += ev.time_range.elapsed_us() / 1e3 / iters
            launches[_group(ev.name)] += 1
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    groups: Dict[str, float] = defaultdict(float)
    for name, ms in kernels.items():
        groups[_group(name)] += ms
    busy = sum(kernels.values())
    return {
        "wall_ms": wall_ms, "profiled_wall_ms": profiled_wall_ms, "device_busy_ms": busy,
        "idle_share": max(0.0, 1.0 - busy / wall_ms),
        "img_per_s": batch / (wall_ms / 1e3),
        "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "device_ops_per_call": {k: v / iters for k, v in sorted(launches.items())},
        "top_kernels_ms": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:12]),
    }


def profile_forward(precision: str, batch: int, size: int, iters: int = 5) -> Dict:
    """The serving forward (uint8 in and out)."""
    dev = torch.device("cuda")
    params = transformer.init_params(seed=0, device=dev)
    x = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, size=(batch, size, size, 3), dtype=np.uint8)
    ).to(dev)
    serve = fast.make_serve_fn(precision)
    out = _profile(lambda: serve(params, x), batch, iters)
    return {"precision": precision, "batch": batch, "size": size, **out}


def profile_train_step(precision: str, batch: int, size: int, iters: int = 5) -> Dict:
    """One training step (forward, backward, Adam) on seeded parameters,
    seeded VGG and a seeded batch."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    params = transformer.init_params(seed=0, device=dev)
    vgg_params = vgg.init_params(seed=0, device=dev)
    style = torch.from_numpy(rng.standard_normal((1, size, size, 3)).astype(np.float32)).to(dev)
    grams = vgg.style_gram_targets(vgg_params, style)
    x = torch.from_numpy(rng.standard_normal((batch, size, size, 3)).astype(np.float32)).to(dev)
    step = fast.make_train_step(vgg_params, grams,
                                compute_dtype=torch.bfloat16 if precision == "bf16" else None)
    opt = fast.make_optimizer(params)
    out = _profile(lambda: step(params, opt, x), batch, iters)
    return {"precision": precision, "batch": batch, "size": size, "train_step": True, **out}


def profile_gatys(precision: str, size: int) -> Dict:
    """One Gatys closure (loss and pixel gradient) and one outer L-BFGS step
    (H = 100, compact) at batch 1, on seeded VGG parameters and images."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    vgg_params = vgg.init_params(seed=0, device=dev)
    content, style = (torch.from_numpy(rng.standard_normal((1, size, size, 3)).astype(np.float32))
                      .to(dev) for _ in range(2))
    grams = vgg.style_gram_targets(vgg_params, style)
    cd = torch.bfloat16 if precision == "bf16" else None
    loss_fn = gatys.make_loss_fn(vgg_params, content, grams, compute_dtype=cd)

    def closure():
        x = content.detach().requires_grad_()
        return torch.autograd.grad(loss_fn(x).sum(), x)

    def outer_step():
        return gatys._run_lbfgs_torch(vgg_params, content, grams, 1, 100_000.0, 1.0,
                                      compute_dtype=cd, history_size=100,
                                      history_math="compact")

    out = {"precision": precision, "batch": 1, "size": size, "gatys": True}
    out["closure"] = _profile(closure, 1, iters=10)
    gatys.closure_evals = 0
    iters = 2
    out["outer_step"] = _profile(outer_step, 1, iters=iters)
    # _profile calls it WARMUP times, then iters times twice.
    out["outer_step"]["closures_per_call"] = gatys.closure_evals / (WARMUP + 2 * iters)
    return out


def _print_profile(label: str, r: Dict, card: str) -> None:
    print(f"{label} on {card}: {r['wall_ms']:.3f} ms/call ({r['img_per_s']:.1f} img/s; "
          f"{r['profiled_wall_ms']:.3f} under the profiler), device busy "
          f"{r['device_busy_ms']:.3f} ms, idle share {r['idle_share']:.4f}")
    for name, ms in r["groups_ms"].items():
        print(f"  {name:50s} {ms:9.3f} ms  {ms / r['device_busy_ms']:6.1%}  "
              f"{r['device_ops_per_call'][name]:.0f} kernels")
    for name, ms in r["top_kernels_ms"].items():
        print(f"    {ms:9.3f} ms  {name[:110]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=None,
                    help="batch size (default 64 for the forward, 4 for --train)")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--train", action="store_true", help="profile a training step")
    ap.add_argument("--gatys", action="store_true",
                    help="profile a Gatys closure and an outer L-BFGS step")
    args = ap.parse_args(argv)
    batch = args.batch or (4 if args.train else 64)
    what = "train step" if args.train else "forward"
    if not torch.cuda.is_available():
        print("profiling: needs a CUDA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    results = []
    for precision in ("f32", "bf16"):
        if args.gatys:
            r = profile_gatys(precision, args.size)
            _print_profile(f"{precision} gatys closure at {r['size']} px", r["closure"], card)
            _print_profile(f"{precision} gatys outer L-BFGS step at {r['size']} px "
                           f"({r['outer_step']['closures_per_call']:.1f} closures)",
                           r["outer_step"], card)
        else:
            run = profile_train_step if args.train else profile_forward
            r = run(precision, batch, args.size)
            _print_profile(f"{precision} batch {r['batch']} {what} at {r['size']} px", r, card)
        results.append(r)
    print(json.dumps({"card": card, "profiles": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
