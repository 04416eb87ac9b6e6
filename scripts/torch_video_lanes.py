#!/usr/bin/env python3
"""How far a clip stylized in a lane of a batch drifts from the same clip
stylized alone, on one CUDA GPU.

    python3 scripts/torch_video_lanes.py

``video_st convert-dir`` stylizes several clips at once, one carry lane
each; ``convert-video`` stylizes one clip at batch 1. Every op of the
forward is per image, but a library conv may take another algorithm, and so
another summation order, at another batch size, and the recurrence (each
stylized frame is the next frame's input) carries the difference on. This
prints, in f32 and bf16, with cuDNN's default algorithm choice and with
``torch.backends.cudnn.deterministic``:

1. one forward of two frames at batch 2 against each at batch 1: the
   largest difference of the output, and of each cuDNN conv of the forward
   (the transform net's 9x9, stride-2, phase-form and space-to-depth convs
   at their 256 px shapes);
2. a 48-frame clip stylized in lane 0 of a batch of 2 against alone: the
   largest uint8 difference of each frame, and the float difference of the
   carry after the last frame;

and first, without those flags, the forward at batch 4 and 64 against its
images one at a time, with the forward's device time at that batch.

Seeded parameters and synthetic clips; nothing is read from disk.
"""

from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 48
SIZE = 256


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_video_lanes: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from styletransfer_tpu_torch.data import coco
    from styletransfer_tpu_torch.engines import video
    from styletransfer_tpu_torch.models import transformer
    from styletransfer_tpu_torch.ops import layers
    from styletransfer_tpu_torch.utils import images

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    layers.disable_tf32()
    params = transformer.init_video_params(seed=0, device="cuda")

    def clip(seed):
        base = np.round(coco.synthetic_image(seed, SIZE) * 255).astype(np.uint8)
        return np.stack([np.roll(base, 2 * t, axis=1) for t in range(FRAMES)])

    a, b = clip(50_001), clip(50_002)
    # The cuDNN convs of the forward at 256 px: (name, input, kernel, stride).
    g = torch.Generator(device="cuda").manual_seed(0)
    convs = [("conv1 9x9 6->32", (SIZE + 8, 6), (9, 6, 32), 1),
             ("conv2 3x3/2 32->64", (SIZE + 2, 32), (3, 32, 64), 2),
             ("conv3 3x3/2 64->128", (SIZE // 2 + 2, 64), (3, 64, 128), 2),
             ("up1 phase 128->256", (SIZE // 4 + 2, 128), (3, 128, 256), 1),
             ("up2 phase 64->128", (SIZE // 2 + 2, 64), (3, 64, 128), 1),
             ("conv_out s2d 512->48", (SIZE // 4 + 2, 512), (3, 512, 48), 1)]
    # Each forward at batch 4 and 64 against its images one at a time.
    for precision, cd in (("f32", None), ("bf16", torch.bfloat16)):
        for n in (4, 64):
            frames = torch.from_numpy(np.stack([clip(60_000 + i)[0] for i in range(n)])).cuda()
            x = images.maybe_normalize_on_device(frames)
            x = torch.cat([x, x], dim=-1)
            many = transformer.apply(params, x, compute_dtype=cd)
            one = torch.cat([transformer.apply(params, x[i:i + 1], compute_dtype=cd)
                             for i in range(n)])
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                transformer.apply(params, x, compute_dtype=cd)
            end.record()
            torch.cuda.synchronize()
            print(f"{precision}: forward batch {n} vs its images one at a time: max |diff| "
                  f"{float((many - one).abs().max()):.3g}; {start.elapsed_time(end) / 5:.3f} ms a "
                  f"forward at batch {n}", flush=True)
    for deterministic in (False, True):
        torch.backends.cudnn.deterministic = deterministic
        for precision, cd in (("f32", None), ("bf16", torch.bfloat16)):
            tag = f"{precision}, cudnn.deterministic={deterministic}"
            for name, (hw, c), (k, ci, co), stride in convs:
                x = torch.randn(2, hw, hw, c, device="cuda", generator=g)
                w = torch.randn(k, k, ci, co, device="cuda", generator=g) / (k * k * ci) ** 0.5
                two = layers.conv2d(x, w, None, stride, compute_dtype=cd)
                one = torch.cat([layers.conv2d(x[i:i + 1], w, None, stride, compute_dtype=cd)
                                 for i in range(2)])
                print(f"{tag}: {name} batch 2 vs batch 1: max |diff| "
                      f"{float((two.float() - one.float()).abs().max()):.3g}")
            frames = torch.from_numpy(np.stack([a[0], b[0]])).cuda()
            x = images.maybe_normalize_on_device(frames)
            x = torch.cat([x, x], dim=-1)
            two = transformer.apply(params, x, compute_dtype=cd)
            one = torch.cat([transformer.apply(params, x[i:i + 1], compute_dtype=cd)
                             for i in range(2)])
            print(f"{tag}: forward batch 2 vs batch 1: max |diff| "
                  f"{float((two - one).abs().max()):.3g}")
            pair = video.stylize_clip(params, np.stack([a, b], axis=1), precision)
            alone = video.stylize_clip(params, a, precision)
            u8 = images.to_uint8_on_device
            steps = (u8(torch.from_numpy(pair[:, 0])).int()
                     - u8(torch.from_numpy(alone)).int()).abs()
            per_frame = [int(s.max()) for s in steps]
            print(f"{tag}: {FRAMES}-frame clip in a lane of 2 vs alone: max uint8 diff per "
                  f"frame {per_frame}; mean over the clip {float(steps.float().mean()):.5f}; "
                  f"carry max |diff| after the last frame "
                  f"{float(np.abs(pair[-1, 0] - alone[-1]).max()):.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
