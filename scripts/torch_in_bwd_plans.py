"""The fused-IN backward's plans on the GPU: the fifteen calls of a batch-4
train step timed under several values of ``fused_instance_norm.
BWD_MIN_ELEMS`` (the least elements of x per block, which sets how many
blocks share an image), in f32 and bf16.

    python3 scripts/torch_in_bwd_plans.py

Prints each call's plan and the step's device time (CUDA events around
calls queued behind a spin kernel, ``chip_smoke.device_ms``) beside the
bound, for each setting; the plain version checks every call. Needs a CUDA
GPU and nvcc.
"""

from __future__ import annotations

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from styletransfer_tpu_torch.ops import layers  # noqa: E402
from styletransfer_tpu_torch.ops.cuda import fused_instance_norm as fin  # noqa: E402

MIN_ELEMS = (8192, 16384, 32768)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_in_bwd_plans: needs a CUDA GPU", file=sys.stderr)
        return 1
    card = chip_smoke.gpu_line()
    layers.disable_tf32()
    chosen = fin.BWD_MIN_ELEMS
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        g = torch.Generator(device="cuda").manual_seed(3)
        calls = []
        for call, H, C, with_res, relu, count in chip_smoke._FUSED_CALLS:
            shape = (chip_smoke.TRAIN_BATCH, H, H, C)
            x = (torch.randn(*shape, device="cuda", generator=g) * 2 + 0.5).to(dtype)
            res = torch.randn(*shape, device="cuda", generator=g).to(dtype) if with_res else None
            scale = torch.rand(C, device="cuda", generator=g) + 0.5
            bias = torch.randn(C, device="cuda", generator=g)
            gy = torch.randn(*shape, device="cuda", generator=g).to(dtype)
            _, mean, inv = fin.forward(x, scale, bias, res, relu)
            args = (gy, x, res, mean, inv, scale, bias, relu)
            nbytes = (x.numel() * (2 if with_res else 1) + 2 * gy.numel()) * x.element_size()
            bound_ms, _ = chip_smoke.bound(16.0 * x.numel(), nbytes + (4 + 2 * len(x)) * C * 4, dn)
            calls.append((call, shape, args, count, bound_ms))
        step_bound = sum(b * n for *_, n, b in calls)
        resident = fin._resident(torch.device("cuda"), dtype)
        for min_elems in MIN_ELEMS:
            fin.BWD_MIN_ELEMS = min_elems
            fin.bwd_plan.cache_clear()
            total, plans = 0.0, []
            for call, shape, args, count, _ in calls:
                dx, dscale, dbias = fin.backward(*args)
                pdx, pdscale, pdbias = fin.backward_plain(*args)
                chip_smoke.check(chip_smoke.allclose(torch, dx, pdx, *chip_smoke.TOL[
                    ("fused_instance_norm_bwd", dn)]), f"{dn} {call} at {min_elems}: dx")
                ms = chip_smoke.device_ms(torch, lambda: fin.backward(*args))
                total += ms * count
                plan = fin.bwd_plan(*shape, resident)
                plans.append(f"{call} {plan.blocks} blocks, chunks of {plan.chunk} px "
                             f"{ms:.4f} ms")
            print(f"fused-IN backward {dn}, BWD_MIN_ELEMS {min_elems}"
                  f"{' (the default)' if min_elems == chosen else ''}: 15 calls {total:.4f} ms, "
                  f"bound {step_bound:.4f} ms ({step_bound / total:.3f} of it); {resident} "
                  f"blocks resident; " + "; ".join(plans) + f" on {card}", flush=True)
    fin.BWD_MIN_ELEMS = chosen
    fin.bwd_plan.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
