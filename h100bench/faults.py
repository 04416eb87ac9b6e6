"""Faults planted under the timed path, to show that ``correct`` catches
them: each replaces one function of the program for the length of a
``with planted(name)`` block.

- ``unchanged_state``: a training step, or an L-BFGS run, that returns its
  state unchanged (the parameters, or the pixels, as they came in);
- ``half_batch``: a training step on the first half of its batch only (the
  mean over the rest), or a forward that leaves the second half of its
  batch out (those images all zeros);
- ``altered_answer``: a forward whose first image has one pixel 64 levels
  off, or a Gatys image with a colour cast of a tenth of a standard
  deviation on its red channel.

Which faults a cell can have is ``FAULTS[kind]``. On the chip, at a cell's
own size:

    python -m h100bench.faults --workload <cell> --fault <name> --seed <n> --seconds <s>
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from typing import Iterator

import torch

from h100bench import harness

FAULTS = {
    "offline": ("half_batch", "altered_answer"),
    "daemon": ("half_batch", "altered_answer"),
    "train": ("unchanged_state", "half_batch"),
    "gatys": ("unchanged_state", "altered_answer"),
}


@contextlib.contextmanager
def _replaced(module, name: str, make) -> Iterator[None]:
    original = getattr(module, name)
    setattr(module, name, make(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def _serve(fault):
    def make(make_serve_fn):
        def faulty_make_serve_fn(*args, **kwargs):
            serve = make_serve_fn(*args, **kwargs)

            def faulty(params, batch):
                if fault == "half_batch":
                    half = batch.shape[0] // 2
                    out = serve(params, batch[: batch.shape[0] - half])
                    return torch.cat([out, out.new_zeros((half,) + out.shape[1:])])
                out = serve(params, batch).clone()
                out[0, 0, 0] += 64
                return out

            return faulty

        return faulty_make_serve_fn

    return make


def _train(fault):
    def make(make_train_step):
        def faulty_make_train_step(*args, **kwargs):
            step = make_train_step(*args, **kwargs)

            def faulty(params, optimizer, batch):
                if fault == "half_batch":
                    return step(params, optimizer, batch[: max(1, batch.shape[0] // 2)])
                kept = [p.detach().clone() for p in params.parameters()]
                metrics = step(params, optimizer, batch)
                with torch.no_grad():
                    for p, k in zip(params.parameters(), kept):
                        p.copy_(k)
                return metrics

            return faulty

        return faulty_make_train_step

    return make


def _lbfgs(fault):
    def make(lbfgs_torch):
        def faulty(loss_and_grad_fn, x0, steps, *args, **kwargs):
            if fault == "unchanged_state":
                x = x0.unsqueeze(0) if x0.dim() == 1 else x0
                loss, _ = loss_and_grad_fn(x)
                history = loss.float().unsqueeze(-1).repeat(1, steps)
                return (x0, history[0]) if x0.dim() == 1 else (x0, history)
            x, history = lbfgs_torch(loss_and_grad_fn, x0, steps, *args, **kwargs)
            x = x.clone()
            x.view(x.shape[0], -1, 3)[..., 0] += 0.1  # NHWC rows, channel 0
            return x, history

        return faulty

    return make


@contextlib.contextmanager
def planted(kind: str, fault: str) -> Iterator[None]:
    """Plant ``fault`` under the timed path of a cell of traffic ``kind``."""
    if fault not in FAULTS[kind]:
        raise ValueError(f"a {kind} cell cannot have the fault {fault!r}")
    if kind in ("offline", "daemon"):
        from styletransfer_tpu_torch.engines import fast

        with _replaced(fast, "make_serve_fn", _serve(fault)):
            yield
    elif kind == "train":
        from styletransfer_tpu_torch.engines import fast

        with _replaced(fast, "make_train_step", _train(fault)):
            yield
    else:
        from styletransfer_tpu_torch.ops import lbfgs

        with _replaced(lbfgs, "lbfgs_torch", _lbfgs(fault)):
            yield


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args(argv)
    harness.set_cache_dirs()
    kind = harness.load_json("cells", a.workload)["kind"]
    with planted(kind, a.fault):
        line = harness.execute(a.workload, a.seed, a.seconds, False, "cuda", time.monotonic())
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps({"fault": a.fault, **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
