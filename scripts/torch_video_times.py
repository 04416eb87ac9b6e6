#!/usr/bin/env python3
"""Frames per second of the video stylizer of one tree, on one CUDA GPU.

    python3 scripts/torch_video_times.py [TREE]

TREE is the root of a checkout of this repository (default: this one), for
example an older commit unpacked with ``git archive`` into a git-ignored
directory; run two trees in turns, one process each (parent, change,
change, parent), to compare them on one card. It times, in f32 and bf16,
with seeded 6-channel parameters on synthetic 256 px GIF clips:

- ``engines.video.process_video`` (``video_st convert-video``) of a
  48-frame clip: frames/s of the whole command, GIF decode and encode
  included;
- ``engines.video.process_video_dir`` (``video_st convert-dir``) of clips of
  24, 40 and 48 frames at batch 2, and of four 24-frame clips at batch 4;
- the stylizer alone (``_stylize_chunk``) on 24 decoded frames at batch 1
  and at batch 4: ms per frame step, host clock around a synchronize.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time


def main() -> int:
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_video_times: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, tree)
    from PIL import Image

    from styletransfer_tpu_torch.data import coco
    from styletransfer_tpu_torch.engines import video
    from styletransfer_tpu_torch.models import transformer
    from styletransfer_tpu_torch.ops.cuda import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    _build.build_all()
    work = os.path.join(tree, "build", "video_times")
    shutil.rmtree(work, ignore_errors=True)

    def write_clip(path, frames, seed):
        base = np.round(coco.synthetic_image(seed, 256) * 255).astype(np.uint8)
        imgs = [Image.fromarray(np.roll(base, 2 * i, axis=1)) for i in range(frames)]
        imgs[0].save(path, save_all=True, append_images=imgs[1:], duration=42, loop=0)

    dirs = {2: (24, 40, 48), 4: (24, 24, 24, 24)}
    os.makedirs(work)
    clip = os.path.join(work, "clip.gif")
    write_clip(clip, 48, 50_000)
    for batch, lengths in dirs.items():
        os.makedirs(os.path.join(work, f"clips{batch}"))
        for i, n in enumerate(lengths):
            write_clip(os.path.join(work, f"clips{batch}", f"c{i}.gif"), n, 50_001 + i)
    params = transformer.init_video_params(seed=0, device="cuda")
    frames = torch.from_numpy(np.stack([np.stack([np.roll(
        np.round(coco.synthetic_image(50_010 + c, 256) * 255).astype(np.uint8), 2 * t, axis=1)
        for c in range(4)]) for t in range(24)])).cuda()  # [24, 4, 256, 256, 3]
    for precision, cd in (("f32", None), ("bf16", torch.bfloat16)):
        out = os.path.join(work, f"out_{precision}")
        video._stylize_chunk(params, frames[:2, :1], frames[0, :1].float(), cd)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        video.process_video(clip, "t", out_dir=out, params=params, precision=precision,
                            device="cuda")
        torch.cuda.synchronize()
        rates = [f"convert-video {48 / (time.perf_counter() - t0):.2f}"]
        for batch, lengths in dirs.items():
            t0 = time.perf_counter()
            video.process_video_dir(os.path.join(work, f"clips{batch}"), "t", out_dir=out,
                                    batch_size=batch, params=params, precision=precision,
                                    device="cuda")
            torch.cuda.synchronize()
            rates.append(f"convert-dir batch {batch} "
                         f"{sum(lengths) / (time.perf_counter() - t0):.2f}")
        steps = []
        for lanes in (1, 4):
            chunk = frames[:, :lanes]
            carry = chunk[0].float()
            video._stylize_chunk(params, chunk[:2], carry, cd)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            video._stylize_chunk(params, chunk, carry, cd)
            torch.cuda.synchronize()
            steps.append(f"batch {lanes} {(time.perf_counter() - t0) * 1e3 / len(chunk):.3f} ms")
        print(f"{tree} {precision}: frames/s {', '.join(rates)}; the stylizer alone per frame "
              f"step: {', '.join(steps)} ({card})", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
