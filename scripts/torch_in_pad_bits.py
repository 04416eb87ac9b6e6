#!/usr/bin/env python3
"""Whether two trees' instance-norm kernels give the same bits, on one CUDA GPU.

    python3 scripts/torch_in_pad_bits.py TREE OUT.pt     # run TREE's kernels
    python3 scripts/torch_in_pad_bits.py --compare A.pt B.pt

The first form runs the kernels of the checkout at TREE (for example an
older commit unpacked with ``git archive`` into a git-ignored directory)
with one [C] affine, from seeded inputs, and saves a SHA-256 digest of each
output's bytes (with its shape and dtype); one process per tree:

- ``instance_norm_pad`` at the fifteen call shapes of a 256 px serving
  forward at batch 8, f32 and bf16;
- the training norm's forward (``fused_instance_norm.forward``: output,
  mean, inv) and backward (dx, dscale, dbias, and dscale, dbias without the
  dx pass) at the fifteen calls of a 256 px train step at batch 4, f32 and
  bf16.

The second form says, call by call, whether two such files hold the same
bits: a change that adds per-image affines to a kernel must leave a
single-style call as it was.
"""

from __future__ import annotations

import hashlib
import os
import sys

# The fifteen calls, by kind: (name, H divisor of 256, C, pad, residual pad
# or None, relu, mode, sums given).
CALLS = [("in1", 1, 32, 1, None, True, "reflect", False),
         ("in2", 2, 64, 1, None, True, "reflect", False),
         ("in3", 4, 128, 1, None, True, "reflect", False),
         ("res.in1", 4, 128, 1, None, True, "reflect", True),
         ("res.in2", 4, 128, 1, 1, False, "reflect", False),
         ("res5.in2", 4, 128, 1, 1, False, "edge", False),
         ("up1_in", 2, 64, 1, None, True, "edge", False),
         ("up2_in", 1, 32, 4, None, True, "reflect", False)]
# The fifteen calls of the training forward: (name, H, C, residual, relu, count).
TRAIN_CALLS = [("in1", 256, 32, False, True, 1), ("in2", 128, 64, False, True, 1),
               ("in3", 64, 128, False, True, 1), ("res.in1", 64, 128, False, True, 5),
               ("res.in2", 64, 128, True, False, 5), ("up1_in", 128, 64, False, True, 1),
               ("up2_in", 256, 32, False, True, 1)]


def _digest(t) -> str:
    """Shape, dtype and SHA-256 of a tensor's bytes: equal exactly when the
    bits are."""
    import torch

    raw = t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes()
    return f"{tuple(t.shape)} {t.dtype} {hashlib.sha256(raw).hexdigest()}"


def run(tree: str, out: str) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_in_pad_bits: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(tree))
    from styletransfer_tpu_torch.ops.cuda import fused_instance_norm as fin
    from styletransfer_tpu_torch.ops.cuda import instance_norm

    g = torch.Generator(device="cuda").manual_seed(3)
    outs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, div, C, pad, rp, relu, mode, with_stats in CALLS:
            H = 256 // div
            x = (torch.randn(8, H, H, C, device="cuda", generator=g) * 2 + 0.5).to(dtype)
            scale = torch.rand(C, device="cuda", generator=g) + 0.5
            bias = torch.randn(C, device="cuda", generator=g)
            res = None if rp is None else torch.randn(
                8, H + 2 * rp, H + 2 * rp, C, device="cuda", generator=g).to(dtype)
            stats = ((x.float().sum(dim=(1, 2)), (x.float() ** 2).sum(dim=(1, 2)))
                     if with_stats else None)
            outs[f"{name} {dtype}"] = _digest(instance_norm.instance_norm_pad(
                x, scale, bias, res, rp or 0, relu, pad, mode, stats))
    for dtype in (torch.float32, torch.bfloat16):
        for name, H, C, with_res, relu, count in TRAIN_CALLS:
            for i in range(count):
                shape = (4, H, H, C)
                x = (torch.randn(*shape, device="cuda", generator=g) * 2 + 0.5).to(dtype)
                res = (torch.randn(*shape, device="cuda", generator=g).to(dtype)
                       if with_res else None)
                scale = torch.rand(C, device="cuda", generator=g) + 0.5
                bias = torch.randn(C, device="cuda", generator=g)
                gy = torch.randn(*shape, device="cuda", generator=g).to(dtype)
                fwd = fin.forward(x, scale, bias, res, relu)
                bwd = fin.backward(gy, x, res, fwd[1], fwd[2], scale, bias, relu)
                sums = fin.backward(gy, x, res, fwd[1], fwd[2], scale, bias, relu,
                                    need_dx=False)[1:]
                for part, t in zip(("out", "mean", "inv", "dx", "dscale", "dbias",
                                    "dscale without dx", "dbias without dx"),
                                   (*fwd, *bwd, *sums)):
                    outs[f"fused {name}[{i}] {dtype} {part}"] = _digest(t)
    torch.save(outs, out)
    print(f"{tree}: {len(outs)} calls saved to {out}")
    return 0


def compare(a: str, b: str) -> int:
    import torch

    ta, tb = torch.load(a), torch.load(b)
    same = [k for k in ta if ta[k] == tb.get(k)]
    for k in ta:
        print(f"{k}: {'the same bits' if k in same else 'DIFFERENT'}")
    print(f"{len(same)} of {len(ta)} calls give the same bits in {a} and {b}")
    return 0 if len(same) == len(ta) == len(tb) else 1


if __name__ == "__main__":
    args = sys.argv[1:]
    if len(args) == 3 and args[0] == "--compare":
        sys.exit(compare(args[1], args[2]))
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(run(*args))
