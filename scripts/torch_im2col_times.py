#!/usr/bin/env python3
"""conv3x3_im2col on the GPU, of this checkout or of another one.

    python3 scripts/torch_im2col_times.py [TREE]

Imports ``styletransfer_tpu_torch`` from the checkout at TREE (default: this
one; for example an older commit unpacked with ``git archive`` under
``build/``) and times its ``conv3x3_im2col`` wrapper at VGG conv1_1's shape,
x [B, 258, 258, 3] -> 64 (a 256 px image) for B = 1 (a Gatys closure), 4 (a
train step, a 4-image Gatys directory) and 16 (a train step at batch 16), in
f32 and bf16, each call held against the tree's plain version and beside
``F.conv2d`` (padding 1 on the interior, channels last, TF32 off) and the
bound (inputs read once and the output written once at 3.35 TB/s, or the
FLOPs at 67 TFLOP/s in f32 and 989 in bf16). Device ms: CUDA events around
20 calls queued behind a spin kernel, the best of three. Run it once per
tree, each in a fresh process, to compare trees on one card (parent,
change, change, parent). Needs a CUDA GPU and nvcc.
"""

from __future__ import annotations

import os
import subprocess
import sys

SHAPES = [(1, 256, 256, 3, 64), (4, 256, 256, 3, 64), (16, 256, 256, 3, 64)]  # B, H, W, C, O
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12
# (rtol, atol) against the plain version, as chip_smoke.py's TOL.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2 ** -7, 1e-3)}


def _device_ms(torch, fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(100_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return min(times)


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tree = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else root
    sys.path.insert(0, tree)
    import torch
    import torch.nn.functional as F

    from styletransfer_tpu_torch.ops import layers
    from styletransfer_tpu_torch.ops.cuda import conv3x3_flat as cf

    if not torch.cuda.is_available():
        print("torch_im2col_times: needs a CUDA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"tree {tree} on {card}", flush=True)
    layers.disable_tf32()
    failed = False
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for B, H, W, C, O in SHAPES:
            g = torch.Generator(device="cuda").manual_seed(9)
            interior = torch.randn(B, H, W, C, device="cuda", generator=g).to(dtype)
            x = F.pad(interior, (0, 0, 1, 1, 1, 1)).contiguous()
            w = (torch.randn(3, 3, C, O, device="cuda", generator=g) * (9 * C) ** -0.5).to(dtype)
            b = torch.randn(O, device="cuda", generator=g) * 0.1
            out = cf.conv3x3_im2col(x, w, b)
            plain = cf.conv3x3_im2col_plain(x, w, b)
            err = float((out.float() - plain.float()).abs().max())
            rtol, atol = TOL[dn]
            ok = bool(torch.all((out.float() - plain.float()).abs()
                                <= atol + rtol * plain.float().abs()))
            failed |= not ok
            ms = _device_ms(torch, lambda: cf.conv3x3_im2col(x, w, b))
            xc = interior.permute(0, 3, 1, 2)
            wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            bc = b.to(dtype)
            library_ms = _device_ms(torch, lambda: F.conv2d(xc, wc, bc, padding=1))
            flops = 2.0 * B * H * W * 9 * C * O
            nbytes = (x.numel() + w.numel() + B * H * W * O) * x.element_size() + O * 4
            bound_ms = max(flops / PEAK_FLOPS[dn], nbytes / PEAK_BYTES_PER_S) * 1e3
            plan = cf.im2col_plan(B, H, W, C, O, dtype) if hasattr(cf, "im2col_plan") else "-"
            print(f"conv3x3_im2col {dn} [{B},{H + 2},{W + 2},{C}] -> {O}: kernel {ms:.4f} ms "
                  f"({bound_ms / ms:.3f} of the bound), F.conv2d {library_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms, max_abs_err {err:.3g} ({'within' if ok else 'OUTSIDE'} "
                  f"rtol {rtol:.3g}, atol {atol:.3g}), plan {plan}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
