#!/usr/bin/env python3
"""The training instance norm's kernels on the GPU, of this checkout or of
another one.

    python3 scripts/torch_fused_in_times.py [TREE]

Imports ``chip_smoke`` and ``styletransfer_tpu_torch`` from the checkout at
TREE (default: this one; for example an older commit unpacked with ``git
archive`` under ``build/``) and runs its ``chip_smoke.fused_phase`` in f32
and bf16: the fused-IN forward and backward held against their plain
versions and timed at each call shape of a batch-4 train step, with the
step's totals. Run it once per tree, each in a fresh process, to compare
trees on one card (parent, change, change, parent). Needs a CUDA GPU
and nvcc.
"""

from __future__ import annotations

import os
import sys


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tree = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else root
    sys.path.insert(0, tree)
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from styletransfer_tpu_torch.ops import layers
    from styletransfer_tpu_torch.ops.cuda import fused_instance_norm

    if not torch.cuda.is_available():
        print("torch_fused_in_times: needs a CUDA GPU", file=sys.stderr)
        return 1
    print(f"tree {tree} on {chip_smoke.gpu_line()}", flush=True)
    layers.disable_tf32()
    for dtype in (torch.float32, torch.bfloat16):
        chip_smoke.fused_phase(torch, F, fused_instance_norm, dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
