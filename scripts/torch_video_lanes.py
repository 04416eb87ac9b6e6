#!/usr/bin/env python3
"""Whether a frame stylized in a lane of a batch is bit for bit the frame
stylized alone, op by op, on one CUDA GPU (or, at a small size, the CPU).

    python3 scripts/torch_video_lanes.py                 # the card, 256 px
    python3 scripts/torch_video_lanes.py --device cpu --size 32 --batches 2 4

``video_st convert-dir`` stylizes several clips at once, one carry lane
each; ``convert-video`` stylizes one clip at batch 1; each stylized frame is
the next frame's input, so a lane must be a function of that lane alone, bit
for bit, or the recurrence grows a rounding difference into whole steps of
the uint8 output. This prints:

1. the op table: the video stylizer's forward (``transformer.apply`` with
   ``fixed_order=True``, as ``engines/video.py`` runs it) at batch B (2, 4
   and 64), in f32 and bf16, reflect and zeros padding; every call of each
   kernel wrapper is run again on each lane's own inputs at batch 1, and a
   row per call says "identical" when every lane's output (and, for
   conv3x3_valid, its sums) equals that, else the largest difference.
   Reflect: the six ``conv_direct`` convs, the ten ``conv3x3_valid``
   outputs and sums, the fifteen IN-pad outputs. Zeros (the stacked
   forward): the six ``conv_direct`` convs, the ten ``conv3x3_flat``
   residual convs, the fifteen fused-IN forwards. Then the whole forward;
   and the same forward without ``fixed_order`` (the six convs on cuDNN,
   ``layers.conv2d``, rows of their own), as it ran before the video
   stylizer asked for the fixed order;
2. a clip of FRAMES frames stylized in lane 0 of a batch of 2 against
   alone, through ``engines.video.stylize_clip``: the largest uint8
   difference of each frame;
3. the forward's device time at each batch, with and without
   ``fixed_order``.

Seeded parameters and synthetic frames; nothing is read from disk.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 48


def _lane_args(args, kwargs, j, B):
    """The call's arguments for lane j alone, cut to [j:j+1]: the input (the
    first argument), the residual, and the per-image [B, C] tensors (the
    statistics, per-image affines); the weights stay whole."""
    import torch

    def cut(v, whole=False):
        if isinstance(v, torch.Tensor) and (whole or v.dim() == 2) and v.shape[0] == B:
            return v[j:j + 1].contiguous()
        if isinstance(v, tuple):
            return tuple(cut(t) for t in v)
        return v
    return ([cut(args[0], True)] + [cut(a) for a in args[1:]],
            {k: cut(v, k == "residual") for k, v in kwargs.items()})


def _diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


class Recorder:
    """Wraps the kernel wrappers that ``models/transformer.py`` calls, and
    ``layers.conv2d`` (cuDNN, where ``fixed_order`` is off); each call's
    inputs and outputs are kept, in call order, by name."""

    NAMES = ("conv_direct", "conv3x3_valid", "instance_norm_pad", "conv3x3_same",
             "fused_instance_norm")

    def __init__(self, transformer):
        self.targets = [(transformer, n) for n in self.NAMES] + [(transformer.layers, "conv2d")]
        self.calls, self.real = [], {}

    def __enter__(self):
        for module, name in self.targets:
            real = getattr(module, name)
            self.real[name] = real

            def wrapped(*args, _name=name, _real=real, **kwargs):
                out = _real(*args, **kwargs)
                self.calls.append((_name, args, kwargs, out))
                return out
            setattr(module, name, wrapped)
        return self

    def __exit__(self, *exc):
        for module, name in self.targets:
            setattr(module, name, self.real[name])


def op_table(transformer, params, x, cd, pad_mode, fixed_order=True):
    """[(op label, None if every lane is bit-identical to it alone, else the
    largest difference)] for each kernel call of the forward of x, then the
    forward itself."""
    import torch

    B = x.shape[0]
    with Recorder(transformer) as rec:
        out = transformer.apply(params, x, cd, pad_mode=pad_mode, fixed_order=fixed_order)
    rows, seen = [], {}
    for name, args, kwargs, got in rec.calls:
        seen[name] = seen.get(name, 0) + 1
        worst = 0.0
        for j in range(B):
            a, k = _lane_args(args, kwargs, j, B)
            with torch.no_grad():
                want = rec.real[name](*a, **k)
            pairs = (zip(got, want) if isinstance(got, tuple) else [(got, want)])
            for g, w in pairs:
                worst = max(worst, _diff(g[j:j + 1], w))
        label = (f"{'cuDNN conv2d' if name == 'conv2d' else name} #{seen[name]}"
                 + (" (out, sums, sumsqs)" if name == "conv3x3_valid" else ""))
        rows.append((label, worst or None))
    one = torch.cat([transformer.apply(params, x[j:j + 1], cd, pad_mode=pad_mode,
                                       fixed_order=fixed_order) for j in range(B)])
    rows.append(("forward", _diff(out, one) or None))
    return rows


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--batches", type=int, nargs="+", default=[2, 4, 64])
    ap.add_argument("--frames", type=int, default=FRAMES)
    opts = ap.parse_args()
    if opts.device.startswith("cuda") and not torch.cuda.is_available():
        print("torch_video_lanes: needs a CUDA GPU (or --device cpu)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from styletransfer_tpu_torch.data import coco
    from styletransfer_tpu_torch.engines import video
    from styletransfer_tpu_torch.models import transformer
    from styletransfer_tpu_torch.ops import layers
    from styletransfer_tpu_torch.utils import images

    dev, size = opts.device, opts.size
    on_card = dev.startswith("cuda")
    if on_card:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    layers.disable_tf32()
    params = transformer.init_video_params(seed=0, device=dev)

    def frame(seed):
        return np.round(coco.synthetic_image(seed, size) * 255).astype(np.uint8)

    n_max = max(opts.batches)
    frames = torch.from_numpy(np.stack([frame(60_000 + i) for i in range(n_max)])).to(dev)
    x_all = images.maybe_normalize_on_device(frames)
    x_all = torch.cat([x_all, x_all.flip(2)], dim=-1)  # [frame, a previous stylized frame]
    failed = 0
    for precision, cd in (("f32", None), ("bf16", torch.bfloat16)):
        for pad_mode in ("reflect", "zeros"):
            for fixed_order in (True, False):
                for B in opts.batches:
                    rows = op_table(transformer, params, x_all[:B], cd, pad_mode, fixed_order)
                    tag = (f"{precision} {pad_mode} {'fixed_order' if fixed_order else 'cuDNN'} "
                           f"B={B}")
                    bad = [r for r in rows if r[1] is not None]
                    if fixed_order:
                        failed += len(bad)
                    for label, d in rows:
                        print(f"{tag}: {label}: "
                              + ("identical" if d is None else f"differs, max |diff| {d:.3g}"))
                    print(f"{tag}: {len(rows) - len(bad)} of {len(rows)} rows identical",
                          flush=True)
    # A clip in a lane of 2 against alone, through the video engine.
    for precision in ("f32", "bf16"):
        clips = np.stack([np.stack([np.roll(frame(50_001 + c), 2 * t, axis=1)
                                    for t in range(opts.frames)]) for c in range(2)], axis=1)
        pair = video.stylize_clip(params, clips, precision)
        alone = video.stylize_clip(params, clips[:, 0], precision)
        u8 = images.to_uint8_on_device
        steps = (u8(torch.from_numpy(pair[:, 0])).int() - u8(torch.from_numpy(alone)).int()).abs()
        per_frame = [int(s.max()) for s in steps]
        exact = bool(np.array_equal(pair[:, 0], alone))
        failed += not exact
        print(f"{precision}: {opts.frames}-frame clip in lane 0 of 2 vs alone: "
              f"{'bit-identical' if exact else 'differs'}; max uint8 diff per frame "
              f"{per_frame}", flush=True)
    if on_card:
        for precision, cd in (("f32", None), ("bf16", torch.bfloat16)):
            for B in opts.batches:
                x = x_all[:B]
                times = []
                for fixed_order in (True, False):
                    for _ in range(2):
                        transformer.apply(params, x, cd, fixed_order=fixed_order)
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(5):
                        transformer.apply(params, x, cd, fixed_order=fixed_order)
                    end.record()
                    torch.cuda.synchronize()
                    times.append(start.elapsed_time(end) / 5)
                print(f"{precision}: reflect forward at batch {B}, {size} px: fixed_order "
                      f"{times[0]:.3f} ms, cuDNN {times[1]:.3f} ms a forward", flush=True)
    print(f"torch_video_lanes: {failed} fixed-order rows or clips not bit-identical")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
