#!/usr/bin/env python3
"""Host microseconds per call of the port's conv wrappers on the GPU.

    python3 scripts/torch_host_cost.py [TREE]

Imports ``styletransfer_tpu_torch`` from the checkout at TREE (default: this
one; for example an older commit unpacked with ``git archive`` under
``build/``) and times how long the host takes to make one call of
conv3x3_flat (conv2_2 of a 256 px Gatys closure, f32 and bf16) and, where
the package has ``valid_plan``, of conv3x3_valid on its two bf16 routes (the
residual shape at batch 1). The calls are queued behind a spin kernel, so
the host never waits for the card. Run it once per tree, each in a fresh
process, to compare trees in one session. Needs a CUDA GPU and nvcc.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

CALLS = 1000
CHUNK = 200


def host_us(torch, fn) -> float:
    """Mean host microseconds to make one call: CALLS calls in chunks of
    CHUNK, each queued behind a spin kernel that the card is still running
    when the chunk has been queued (an event recorded after the spin has not
    completed; else the chunk is queued again behind a longer spin)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles, total, done = 50_000_000, 0.0, 0
    while done < CALLS:
        torch.cuda._sleep(cycles)
        mark = torch.cuda.Event()
        mark.record()
        t0 = time.perf_counter()
        for _ in range(CHUNK):
            fn()
        dt = time.perf_counter() - t0
        ahead = not mark.query()
        torch.cuda.synchronize()
        if ahead:
            total += dt
            done += CHUNK
        elif cycles > 2_000_000_000:
            raise RuntimeError("the host could not queue the calls ahead of the card")
        else:
            cycles *= 2
    return total / done * 1e6


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tree = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else root
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("torch_host_cost: needs a CUDA GPU", file=sys.stderr)
        return 1
    from styletransfer_tpu_torch.ops.cuda import conv3x3, conv3x3_flat

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(7)
    costs = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(1, 130, 130, 128, device="cuda", generator=g).to(dtype)
        w = (torch.randn(3, 3, 128, 128, device="cuda", generator=g) * 0.03).to(dtype)
        b = torch.randn(128, device="cuda", generator=g)
        costs[f"conv3x3_flat {str(dtype).split('.')[1]}"] = host_us(
            torch, lambda: conv3x3_flat.conv3x3_flat(x, w, b))
    if hasattr(conv3x3, "valid_plan"):
        x = torch.randn(1, 66, 66, 128, device="cuda", generator=g).bfloat16()
        w = (torch.randn(3, 3, 128, 128, device="cuda", generator=g) * 0.03).bfloat16()
        b = torch.randn(128, device="cuda", generator=g)
        for route in ("bf16_wgmma", "bf16_mma"):
            plan = conv3x3.valid_plan(1, 64, 64, 128, 128, torch.bfloat16, route=route)
            costs[f"conv3x3_valid {route}"] = host_us(
                torch, lambda: conv3x3.launch(x, w, b, False, plan))
    print(f"host us per call ({CALLS} calls queued behind a spin kernel; {conv3x3_flat.__file__}): "
          + ", ".join(f"{k} {v:.2f}" for k, v in costs.items()) + f" on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
