"""Faults planted under the timed path of a cell of the ``offline_pairs``
kind (AdaIN), to show that ``correct`` catches them; each replaces one
function of the program for the length of a ``with planted(name)`` block:

- ``neighbour_style``: every pair given its neighbour's style (the style
  batch rolled by one), so each output carries another image's style
  statistics;
- ``half_batch``: a forward that leaves the second half of its pairs out
  (those images all zeros);
- ``altered_answer``: a forward whose first image has one pixel 64 levels
  off;
- ``tf32_encoder``: every encoder conv's output rounded to TF32's 10-bit
  mantissa (the precision the tensor cores would keep), the rest of the
  forward in f32.

On the chip, at the cell's own size:

    python -m h100bench.faults_pairs --workload <cell> --fault <name> --seed <n> --seconds <s>
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
from h100bench.faults import _replaced

FAULTS = ("neighbour_style", "half_batch", "altered_answer", "tf32_encoder")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to the nearest value with a 10-bit mantissa (ties
    away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _serve(fault):
    def make(make_serve_fn):
        def faulty_make_serve_fn(*args, **kwargs):
            serve = make_serve_fn(*args, **kwargs)

            def faulty(params, content, style, *rest, **kw):
                if fault == "neighbour_style":
                    return serve(params, content, style.roll(1, dims=0), *rest, **kw)
                if fault == "half_batch":
                    half = content.shape[0] // 2
                    keep = content.shape[0] - half
                    out = serve(params, content[:keep], style[:keep], *rest, **kw)
                    return torch.cat([out, out.new_zeros((half,) + out.shape[1:])])
                out = serve(params, content, style, *rest, **kw).clone()
                out[0, 0, 0] += 64
                return out

            return faulty

        return faulty_make_serve_fn

    return make


def _rounded_encoder(model):
    def make(encode):
        def faulty(params, x):
            names = ("conv3x3_valid", "conv3x3_im2col")
            originals = {n: getattr(model, n) for n in names}

            def valid(*a, **k):
                out, s, ss = originals["conv3x3_valid"](*a, **k)
                return round_tf32(out), s, ss

            def im2col(*a, **k):
                return round_tf32(originals["conv3x3_im2col"](*a, **k))

            model.conv3x3_valid, model.conv3x3_im2col = valid, im2col
            try:
                return encode(params, x)
            finally:
                for n, f in originals.items():
                    setattr(model, n, f)

        return faulty

    return make


@contextlib.contextmanager
def planted(fault: str) -> Iterator[None]:
    """Plant ``fault`` under AdaIN's serving forward."""
    if fault not in FAULTS:
        raise ValueError(f"an offline_pairs cell cannot have the fault {fault!r}")
    if fault == "tf32_encoder":
        from styletransfer_tpu_torch.models import adain as model

        with _replaced(model, "encode", _rounded_encoder(model)):
            yield
        return
    from styletransfer_tpu_torch.engines import adain as engine

    with _replaced(engine, "make_serve_fn", _serve(fault)):
        yield


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=FAULTS)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args(argv)
    harness.set_cache_dirs()
    with planted(a.fault):
        line = harness.execute(a.workload, a.seed, a.seconds, False, "cuda", time.monotonic())
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps({"fault": a.fault, **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
