"""What bounds conv3x3_im2col's kernel on the GPU: the kernel timed against
copies of its source with one part taken out.

    python3 scripts/torch_im2col_ablation.py

Builds ``csrc/conv3x3_im2col.cu`` as it is and with parts of one route
taken out, each into its own library under ``build/ablation/``:

- the gather route (the first design; run here at C = 3, which the plan
  sends to the band route): no operand gather (no input loads and no index
  arithmetic: the operand is zeros), no math (no FMAs in f32, no mma.sync
  in bf16), no output store (the store sits behind a test that no call
  passes), and all three out;
- the band route: no span load (the bulk copy not issued, its barrier
  expecting no bytes), no math (the FMAs or mma.syncs behind a test that no
  call passes, so their operands are still read), no output store (the same
  test), and all three out.

Each is timed at VGG conv1_1's shape, x [B, 258, 258, 3] -> 64 (a 256 px
image; B = 1, a Gatys closure, and B = 4, a train step), in f32 and bf16,
the band route on the grid its plan gives, as device time (CUDA events
around 20 calls queued behind a spin kernel, the best of three). The copies
compute wrong outputs: only their times mean something. Each part is taken
out by replacing its text in a copy of the source, so a change to those
lines of the kernel needs the same change here (a build stops with the
variant's name otherwise). Needs a CUDA GPU and nvcc.
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
from styletransfer_tpu_torch.ops.cuda import _build, conv3x3_flat  # noqa: E402

OUT_DIR = os.path.join(os.path.dirname(_build.BUILD_DIR), "ablation")
SOURCE = "conv3x3_im2col.cu"

# route -> variant -> [(text of the source, what replaces it)]; every
# occurrence is replaced (the f32 and bf16 kernels share some lines).
_GATHER = {
    "no gather": [("v = xb[(size_t)row * s.C + c];", "(void)row; (void)c;")],
    "no math": [
        ("acc[i][j] = fmaf(a[i], b[j], acc[i][j]);", "(void)a; (void)b;"),
        ("""          conv3x3::mma_bf16_16816(acc[mi][2 * np], a[mi], b[0], b[1]);
          conv3x3::mma_bf16_16816(acc[mi][2 * np + 1], a[mi], b[2], b[3]);""",
         "          (void)b;"),
    ],
    "no store": [("if (p >= s.HW) continue;", "if (p >= s.HW || relu != 12345) continue;")],
}
_BAND = {
    "no span load": [("""  mbar_expect(bar, sp.bulk);
  if (sp.bulk > 0) bulk_load(stage, x + sp.from, sp.bulk, bar);""",
                      "  mbar_expect(bar, 0);")],
    "no math": [
        ("            const float a = win[(i + dx) * C + c];",
         "            if (relu != 12345) continue;\n"
         "            const float a = win[(i + dx) * C + c];"),
        ("for (int mt = 0; mt < 2; ++mt) conv3x3::mma_bf16_16816(",
         "for (int mt = 0; mt < 2; ++mt) if (relu == 12345) conv3x3::mma_bf16_16816("),
    ],
    "no store": [("if (q < s.M && xx < s.W) {", "if (q < s.M && xx < s.W && relu == 12345) {"),
                 ("          if (x0 < x1)\n            bulk_store(",
                  "          if (x0 < x1 && relu == 12345)\n            bulk_store("),
                 ("if (q < s.M && xx < s.W && n < s.O) {",
                  "if (q < s.M && xx < s.W && n < s.O && relu == 12345) {")],
}
VARIANTS: Dict[str, Dict[str, List[Tuple[str, str]]]] = {}
for _route, _parts in (("gather", _GATHER), ("band", _BAND)):
    VARIANTS[_route] = {"kernel": [], **_parts,
                        # The three taken out at once: what is left is the
                        # launch, the blocks' scheduling and their set-up
                        # (and, on the band route, the operand reads).
                        "none of them": [e for edits in _parts.values() for e in edits]}
SHAPES = [(1, 256, 256, 3, 64), (4, 256, 256, 3, 64)]  # (B, H, W, C, O)


def _start(name: str, edits: List[Tuple[str, str]]):
    d = os.path.join(OUT_DIR, "im2col_" + name.replace(" ", "_").replace("/", "_"))
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.SOURCE_DIR, d)
    path = os.path.join(d, SOURCE)
    with open(path) as f:
        src = f.read()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"variant {name!r}: its text is no longer in the source")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(d, "libconv3x3_im2col.so")
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
    builds = {}
    for route, variants in VARIANTS.items():
        for name, edits in variants.items():
            key = "kernel" if name == "kernel" else f"{route}/{name}"
            if key not in builds:
                builds[key] = _start(key, edits)
    libs = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for key, (proc, path) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {key!r}:\n{log}")
        lib = ctypes.CDLL(path)
        for dn in ("f32", "bf16"):
            fn = getattr(lib, f"stx_conv3x3_im2col_{dn}")
            fn.argtypes = [p] * 4 + [i] * 8 + [p]
            fn.restype = i
        libs[key] = lib
    for dtype, dn in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for B, H, W, C, O in SHAPES:
            g = torch.Generator(device="cuda").manual_seed(1)
            x = torch.randn(B, H + 2, W + 2, C, device="cuda", generator=g).to(dtype)
            w = (torch.randn(3, 3, C, O, device="cuda", generator=g) * 0.2).to(dtype)
            b = torch.randn(O, device="cuda", generator=g)
            out = torch.empty(B, H, W, O, device="cuda", dtype=dtype)
            plan = conv3x3_flat.im2col_plan(B, H, W, C, O, dtype)
            for route, variants in VARIANTS.items():
                band = route == "band"
                route_arg = (2 if plan.bulk_store else 1) if band else 0
                row = []
                for name in variants:
                    key = "kernel" if name == "kernel" else f"{route}/{name}"
                    fn = getattr(libs[key], f"stx_conv3x3_im2col_{dn}")

                    def call():
                        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), B,
                                 H + 2, W + 2, C, O, 0, route_arg, plan.blocks,
                                 torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise RuntimeError(f"variant {key!r} failed to launch: {err}")
                    row.append(f"{name} {_device_ms(call):.4f} ms")
                print(f"conv3x3_im2col {route} {dn} [{B},{H + 2},{W + 2},{C}] -> {O}"
                      f"{f' ({plan})' if band else ''}: " + "; ".join(row) + f" on {card}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
