"""What bounds conv3x3_valid's wgmma kernel on the GPU: the kernel timed
against copies of its source with one part taken out.

    python3 scripts/torch_wgmma_ablation.py

Builds ``csrc/conv3x3_wgmma.cu`` as it is and with, in turn, no TMA loads
(the producer only signals the stages, so the tensor cores read whatever the
ring holds), no wgmma (the consumers only wait for and free the stages), and
no output store (the staging tile is written but not stored), each into its
own library under ``build/ablation/``, and times each on the residual
stage's shape at 256 px ([B, 66, 66, 128] -> 128, B = 64, 16 and 4) on each
of the kernel's configurations, and at the wide serving shapes on their
plans (1040 px at batch 4, [4, 262, 262, 128], and a 4032 x 3024 photo,
[1, 758, 1010, 128]: rows cut into segments), as device time (CUDA events around 20 calls queued behind a
spin kernel, the best of three). The copies compute wrong outputs: only
their times mean something. Each part is taken out by replacing its text
in a copy of the source, so a change to those lines of the kernel needs the
same change here (a build stops with the variant's name otherwise). Needs a
CUDA GPU and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
from typing import Dict, List, Tuple

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from styletransfer_tpu_torch.ops.cuda import _build, conv3x3  # noqa: E402

OUT_DIR = os.path.join(os.path.dirname(_build.BUILD_DIR), "ablation")

_LOADS = """          mbar_expect(full + stage, positions * BK * 2 + boxes * B_BOX_BYTES);
          tma_4d(a, &tx, c0, tile.x0 + tap % 3, tile.y0 + tap / 3, tile.img, full + stage);
          for (int h = 0; h < boxes; ++h)
            tma_3d(a + A_BYTES + h * B_BOX_BYTES, &tw, tile.n0 + h * 64, c0, tap, full + stage);"""
_MMA = """          wgmma_m64n128k16_ss(acc[mi], smem_desc(a + mi * 64 * 128 + kk * 32, 16, 1024, true),
                              db);"""
_STORE = """        tma_store_4d(&to, staging + h * BOX, tile.n0 + h * 64, tile.x0, tile.y0, tile.img);"""

# name -> (text of the source, what replaces it)
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "kernel": [],
    "no loads": [(_LOADS, "          (void)a; (void)boxes; (void)tap; mbar_arrive(full + stage);")],
    "no wgmma": [(_MMA, "          (void)db;")],
    "no store": [(_STORE, "        (void)BOX;")],
}


def _start(name: str, edits: List[Tuple[str, str]]):
    d = os.path.join(OUT_DIR, name.replace(" ", "_"))
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.SOURCE_DIR, d)
    path = os.path.join(d, "conv3x3_wgmma.cu")
    with open(path) as f:
        src = f.read()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"variant {name!r}: its text is no longer in the source")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(d, "libconv3x3_wgmma.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, path]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def _device_ms(fn, iters: int = 20) -> float:
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
    if not torch.cuda.is_available():
        print("ablation: needs a CUDA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    builds = {name: _start(name, edits) for name, edits in VARIANTS.items()}
    libs = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, (proc, path) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{log}")
        lib = ctypes.CDLL(path)
        lib.stx_conv3x3_wgmma.argtypes = [p] * 8 + [i] * 10 + [p]
        lib.stx_conv3x3_wgmma.restype = i
        libs[name] = lib
    C = O = 128
    shapes = [(batch, 64, 64, conv3x3.wgmma_plan(batch, 64, 64, O, bm, stages, 64))
              for batch in (64, 16, 4) for bm, stages in conv3x3.WGMMA_CONFIGS]
    shapes += [(B, H, W, conv3x3.valid_plan(B, H, W, C, O, torch.bfloat16))
               for B, H, W in ((4, 260, 260), (1, 756, 1008))]
    for batch, H, W, plan in shapes:
        g = torch.Generator(device="cuda").manual_seed(1)
        x = torch.randn(batch, H + 2, W + 2, C, device="cuda", generator=g).bfloat16()
        w = (torch.randn(3, 3, C, O, device="cuda", generator=g) * 0.03).bfloat16()
        b = torch.randn(O, device="cuda", generator=g)
        out = torch.empty(batch, H, W, O, device="cuda", dtype=torch.bfloat16)
        sums = torch.empty(2, batch, O, device="cuda")
        flops = 2.0 * batch * H * W * 9 * C * O
        part = torch.empty(2, batch, plan.image_tiles, O, device="cuda")
        row = []
        for name, lib in libs.items():
            def call():
                err = lib.stx_conv3x3_wgmma(
                    x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                    part[0].data_ptr(), part[1].data_ptr(), sums[0].data_ptr(),
                    sums[1].data_ptr(), batch, H + 2, W + 2, C, O, 0, plan.bm, plan.stages,
                    plan.segment, plan.blocks, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"variant {name!r} failed to launch: {err}")
            ms = _device_ms(call)
            row.append(f"{name} {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s)")
        print(f"conv3x3_wgmma [{batch},{H + 2},{W + 2},{C}] ({plan}): " + "; ".join(row)
              + f" on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
