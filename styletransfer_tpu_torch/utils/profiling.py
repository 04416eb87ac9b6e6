"""Where the time of the fast_st forward goes on the GPU.

    python -m styletransfer_tpu_torch.utils.profiling [--batch 64] [--size 256]

Runs ``engines.fast.make_serve_fn`` on seeded parameters and a seeded uint8
batch on the card, in f32 and bf16, under ``torch.profiler``, and prints the
device time of each kernel and of each group of kernels (the port's two
kernels, cuDNN's convolutions, everything else), the wall time per forward
and the share of it in which the device ran no kernel. The last line is one
JSON object with the same numbers. Needs a CUDA GPU; fails without one.
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

from styletransfer_tpu_torch.engines import fast
from styletransfer_tpu_torch.models import transformer

_GROUPS = (
    ("conv3x3 kernel", ("conv3x3_", "tile_sums_kernel")),
    ("IN-pad kernel", ("in_partial_stats", "in_finalize", "in_apply_pad")),
    ("cuDNN convolutions", ("conv", "xmma", "cudnn", "gemm", "implicit", "winograd", "fft")),
)


def _group(kernel_name: str) -> str:
    name = kernel_name.lower()
    for group, keys in _GROUPS:
        if any(k in name for k in keys):
            return group
    return "other (copies, pads, elementwise)"


def profile_forward(precision: str, batch: int, size: int, iters: int = 5) -> Dict:
    """Profile ``iters`` forwards after a warm-up; device times in ms per forward."""
    dev = torch.device("cuda")
    params = transformer.init_params(seed=0, device=dev)
    x = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, size=(batch, size, size, 3), dtype=np.uint8)
    ).to(dev)
    serve = fast.make_serve_fn(precision)
    for _ in range(2):
        serve(params, x)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            serve(params, x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    kernels: Dict[str, float] = defaultdict(float)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name] += ev.time_range.elapsed_us() / 1e3 / iters
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    groups: Dict[str, float] = defaultdict(float)
    for name, ms in kernels.items():
        groups[_group(name)] += ms
    busy = sum(kernels.values())
    return {
        "precision": precision, "batch": batch, "size": size,
        "wall_ms": wall_ms, "device_busy_ms": busy,
        "idle_share": max(0.0, 1.0 - busy / wall_ms),
        "img_per_s": batch / (wall_ms / 1e3),
        "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:12]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--size", type=int, default=256)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiling: needs a CUDA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    results = []
    for precision in ("f32", "bf16"):
        r = profile_forward(precision, args.batch, args.size)
        results.append(r)
        print(f"{precision} batch {r['batch']} at {r['size']} px on {card}: "
              f"{r['wall_ms']:.3f} ms/forward ({r['img_per_s']:.1f} img/s), device busy "
              f"{r['device_busy_ms']:.3f} ms, idle share {r['idle_share']:.4f}")
        for name, ms in r["groups_ms"].items():
            print(f"  {name:36s} {ms:9.3f} ms  {ms / r['device_busy_ms']:6.1%}")
        for name, ms in r["top_kernels_ms"].items():
            print(f"    {ms:9.3f} ms  {name[:110]}")
    print(json.dumps({"card": card, "profiles": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
