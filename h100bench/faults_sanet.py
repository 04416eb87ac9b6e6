"""Faults planted under the timed path of a cell of the
``offline_pairs_sanet`` kind (SANet), to show that ``correct`` catches
them; each replaces one function of the program for the length of a ``with
planted(name)`` block:

- ``neighbour_style``: every pair given its neighbour's style (the style
  batch rolled by one);
- ``half_batch``: a forward that leaves the second half of its pairs out
  (those images all zeros);
- ``altered_answer``: a forward whose first image has one pixel 64 levels
  off;
- ``sdpa_scale``: the scores scaled by 1/sqrt(512) before the softmax, what
  a ``scaled_dot_product_attention``-style call gives by default;
- ``tf32_qk``: Q and K rounded to TF32's 10-bit mantissa before the scores
  (the precision the tensor cores would keep), the rest in f32;
- ``subsampled_keys``: relu4_1's block attending to every other style
  position only (its keys and values subsampled by 2).

And a control that is no fault of the program: ``tf32_reference``, a
forward that returns the plain reference itself computed with TF32 on (the
nearest precision below the configuration's f32), rounded to levels.

On the chip, at the cell's own size:

    python -m h100bench.faults_sanet --workload <cell> --fault <name> --seed <n> --seconds <s>
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
from h100bench.faults_pairs import _serve, round_tf32

FAULTS = ("neighbour_style", "half_batch", "altered_answer", "sdpa_scale", "tf32_qk",
          "subsampled_keys")
CONTROLS = ("tf32_reference",)
SCALE = 512 ** -0.5


def _attention(fault):
    def make(attention):
        def faulty(q, k, v):
            if fault == "sdpa_scale":
                return attention(q * SCALE, k, v)
            return attention(round_tf32(q), round_tf32(k), v)

        return faulty

    return make


def _subsampled_block(model):
    def make(block):
        def faulty(params, content, style, tap):
            if tap != "r4_1":
                return block(params, content, style, tap)
            original = model.attention

            def every_other(q, k, v):
                return original(q, k[:, ::2].contiguous(), v[:, ::2].contiguous())

            model.attention = every_other
            try:
                return block(params, content, style, tap)
            finally:
                model.attention = original

        return faulty

    return make


def _tf32_reference(model):
    def make(make_serve_fn):
        def reference_make_serve_fn(*args, **kwargs):
            make_serve_fn(*args, **kwargs)
            from h100bench.reference import sanet as ref

            def serve(params, content, style):
                weights = [{k: v.to(content.device) for k, v in sd.items()}
                           for sd in model.export_torch_state_dict(params)]
                outs = []
                with ref.precision(tf32=True):
                    for i in range(content.shape[0]):
                        s = style[i if style.shape[0] > 1 else 0][None]
                        r = ref.stylize(*weights, content[i:i + 1].permute(0, 3, 1, 2) / 255.0,
                                        s.permute(0, 3, 1, 2) / 255.0)
                        outs.append(torch.round(torch.clamp(r, 0.0, 1.0) * 255.0)
                                    .to(torch.uint8).permute(0, 2, 3, 1))
                return torch.cat(outs)

            return serve

        return reference_make_serve_fn

    return make


@contextlib.contextmanager
def planted(fault: str) -> Iterator[None]:
    """Plant ``fault`` (or the control) under SANet's serving forward."""
    if fault not in FAULTS + CONTROLS:
        raise ValueError(f"an offline_pairs_sanet cell cannot have the fault {fault!r}")
    from styletransfer_tpu_torch.engines import sanet as engine
    from styletransfer_tpu_torch.models import sanet as model

    if fault in ("sdpa_scale", "tf32_qk"):
        with _replaced(model, "attention", _attention(fault)):
            yield
    elif fault == "subsampled_keys":
        with _replaced(model, "block", _subsampled_block(model)):
            yield
    elif fault == "tf32_reference":
        with _replaced(engine, "make_serve_fn", _tf32_reference(model)):
            yield
    else:
        with _replaced(engine, "make_serve_fn", _serve(fault)):
            yield


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=FAULTS + CONTROLS)
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
