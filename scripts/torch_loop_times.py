#!/usr/bin/env python3
"""Wall ms per step of the fast_st training loop of one tree, in a
process group of one and without a group, on one CUDA GPU.

    python3 scripts/torch_loop_times.py [TREE]

TREE is the root of a checkout of this repository (default: this one), for
example another commit unpacked with ``git archive`` into a git-ignored
directory; run two trees in turns, one process each (A, B, B, A), to
compare them on one card. In f32 and bf16 it runs ``engines.fast.
static_train`` at batch 4, 256 px, for ``STEPS`` steps on batches held in
memory (so the loader does not bound the loop), in turns in an NCCL group
of one (``parallel.distributed.initialize``, left after the run) and without
a group, and times the loop's steps ``SKIP`` to ``STEPS - 1`` (lockstep, the
prefetch and the step; only step 0 logs, evaluates and previews), the clock
stopping at a synchronize after the last step. Prints one JSON line per
precision.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

STEPS = 40
SKIP = 4
BATCH = 4
TURNS = ("group", "alone", "group", "alone")


class _Batches:
    """A train loader over batches held in memory."""

    def __init__(self, batches):
        self.batches = batches

    def set_position(self, epoch, batches_consumed):
        raise NotImplementedError

    def __iter__(self):
        return iter(self.batches)


def main() -> int:
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_loop_times: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, tree)
    from styletransfer_tpu_torch.data import coco
    from styletransfer_tpu_torch.engines import fast
    from styletransfer_tpu_torch.models import transformer, vgg
    from styletransfer_tpu_torch.ops.cuda import _build
    from styletransfer_tpu_torch.parallel import distributed
    from styletransfer_tpu_torch.utils import images

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    _build.build_all()
    work = os.path.join(tree, "build", "loop_times")
    shutil.rmtree(work, ignore_errors=True)
    style = images.normalize(coco.synthetic_image(7, 256))[None].astype(np.float32)
    batches = [np.stack([images.normalize(coco.synthetic_image(BATCH * i + j, 256))
                         for j in range(BATCH)]).astype(np.float32) for i in range(STEPS)]
    vgg_params = vgg.init_params(seed=0, device="cuda")
    real_loop = fast.train_loop

    def run(precision, grouped, tag):
        taken, clock = [0], {}

        def timed_loop(params, train_step, *args, **kwargs):
            def step(*step_args):
                if taken[0] == SKIP:
                    clock["start"] = time.perf_counter()
                metrics = train_step(*step_args)
                taken[0] += 1
                if taken[0] == STEPS:
                    torch.cuda.synchronize()
                    clock["end"] = time.perf_counter()
                return metrics
            return real_loop(params, step, *args, **kwargs)

        if grouped:
            distributed.initialize(f"127.0.0.1:{distributed.free_port()}", 1, 0, device="cuda")
        fast.train_loop = timed_loop
        try:
            test_loader, _ = coco.get_coco_loader(batch_size=BATCH, test_limit=8,
                                                  image_dir=os.path.join(work, "no_images"))
            fast.static_train(
                style, style_name="loop", epochs=1, batch_size=BATCH, vgg_params=vgg_params,
                params=transformer.init_params(seed=0, device="cuda"),
                train_loader=_Batches(batches), test_loader=test_loader,
                log_cadence=(10 * STEPS,) * 3, runs_dir=os.path.join(work, "runs", tag),
                models_path=os.path.join(work, "models", tag), max_steps_per_epoch=STEPS,
                precision=precision, device="cuda")
        finally:
            fast.train_loop = real_loop
            if grouped:
                distributed.shutdown()
        assert taken[0] == STEPS, f"the loop ran {taken[0]} of {STEPS} steps"
        return (clock["end"] - clock["start"]) * 1e3 / (STEPS - SKIP)

    run("f32", False, "warm-up")
    for precision in ("f32", "bf16"):
        ms = {"group": [], "alone": []}
        for i, label in enumerate(TURNS):
            ms[label].append(run(precision, label == "group", f"{precision}_{label}_{i}"))
        print(json.dumps({"tree": tree, "precision": precision, "batch": BATCH,
                          "steps_timed": STEPS - SKIP, "ms_per_step_group_of_one": ms["group"],
                          "ms_per_step_no_group": ms["alone"], "card": card}), flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
