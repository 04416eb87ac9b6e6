#!/usr/bin/env python3
"""Where a serving daemon's request time goes, part by part, on one CUDA GPU.

    python3 scripts/torch_daemon_times.py

The daemons (``fast_st serve``, ``video_st serve``) spend a request on a PNG
decode, the device work and a PNG encode; ``chip_smoke.py`` times them only
whole. This script times each part alone, host clock, mean of many calls
after a warm-up, with seeded parameters:

- PNG decode (``images.load_image_uint8``, crop and resize to 256 px) and
  encode (``images.save_uint8``) of a 256 px image, for uniform noise (the
  smoke test's inputs, which PNG cannot compress) and for a smooth synthetic
  image (``data.coco.synthetic_image``, closer to a photo);
- ``fast.make_serve_fn`` at batch 1 and 8, f32 and bf16: uint8 in, uint8
  back on the host (the copy waits for the device);
- one wave of ``video_st serve`` at batch 1 and 4, f32 and bf16, reflect:
  the slot-table index copies from pinned memory, the gather, the stylizer
  step (``fixed_order``), the uint8 copy back and the scatter, as
  ``engines.video.serve_stream_loop`` runs them;
- the pinned index copy alone.

It prints one line per part and the card's name and power limit.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 256


def _ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_daemon_times: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from styletransfer_tpu_torch.ops import layers

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    layers.disable_tf32()
    dev = torch.device("cuda")
    work = tempfile.mkdtemp(prefix="daemon_times_")
    try:
        _parts(np, torch, dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(card)
    return 0


def _parts(np, torch, dev, work) -> None:
    from PIL import Image

    from styletransfer_tpu_torch.data import coco
    from styletransfer_tpu_torch.engines import fast, video
    from styletransfer_tpu_torch.models import transformer
    from styletransfer_tpu_torch.parallel import prefetch
    from styletransfer_tpu_torch.utils import images

    kinds = {"noise": np.random.default_rng(0).integers(0, 256, (SIZE, SIZE, 3), np.uint8),
             "synthetic": np.round(coco.synthetic_image(1, SIZE) * 255).astype(np.uint8)}
    for kind, arr in kinds.items():
        path = os.path.join(work, f"{kind}.png")
        Image.fromarray(arr).save(path)
        decode = _ms(lambda: images.load_image_uint8(path, size=SIZE), 64)
        encode = _ms(lambda: images.save_uint8(arr, os.path.join(work, f"out_{kind}.png")), 64)
        print(f"PNG {kind} {SIZE} px ({os.path.getsize(path)} bytes): decode {decode:.3f} ms, "
              f"encode {encode:.3f} ms", flush=True)

    params = transformer.init_params(seed=1, device=dev)
    vparams = transformer.init_video_params(seed=2, device=dev)
    pinned = _ms(lambda: prefetch.to_device(np.arange(4, dtype=np.int64), dev), 200)
    print(f"index copy from pinned memory (4 int64): {pinned:.4f} ms", flush=True)
    for precision in ("f32", "bf16"):
        serve = fast.make_serve_fn(precision)
        for batch in (1, 8):
            x = torch.from_numpy(np.repeat(kinds["noise"][None], batch, 0)).to(dev)
            ms = _ms(lambda: serve(params, x).cpu(), 20)
            print(f"fast_st serve forward {precision} batch {batch}: {ms:.3f} ms per call "
                  f"(uint8 back on the host), {ms / batch:.3f} ms per image", flush=True)
        cd = fast._compute_dtype(precision)
        for batch in (1, 4):
            table = torch.zeros((9, SIZE, SIZE, 3), dtype=torch.float32, device=dev)
            frames = np.repeat(kinds["noise"][None], batch, 0)
            slots = np.arange(1, batch + 1, dtype=np.int64)

            def wave():
                idx = prefetch.to_device(slots, dev)
                f = prefetch.to_device(frames, dev)
                old = table.index_select(0, idx)
                with torch.no_grad():
                    out = transformer.apply(vparams, torch.cat(
                        [images.maybe_normalize_on_device(f), old], dim=-1), compute_dtype=cd,
                        fixed_order=True)
                images.to_uint8_on_device(out).cpu()
                table.index_copy_(0, prefetch.to_device(slots, dev), out)

            ms = _ms(wave, 20)
            step = _ms(lambda: video._stylize_chunk(
                vparams, torch.from_numpy(frames[None]).to(dev),
                images.maybe_normalize_on_device(torch.from_numpy(frames).to(dev)),
                cd)[-1].sum().item(), 20)
            print(f"video_st serve wave {precision} batch {batch}: {ms:.3f} ms ({ms / batch:.3f} "
                  f"ms per frame); the stylizer step alone {step:.3f} ms", flush=True)


if __name__ == "__main__":
    sys.exit(main())
