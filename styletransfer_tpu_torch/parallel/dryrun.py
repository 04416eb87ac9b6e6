"""A dry run of the port's data-parallel paths over ``n`` ranks.

The counterpart of ``__graft_entry__.py::dryrun_multichip``:

    python -m styletransfer_tpu_torch.parallel.dryrun --ranks 2
    python -m styletransfer_tpu_torch.parallel.dryrun --ranks 2 --backend gloo
    python -m styletransfer_tpu_torch.parallel.dryrun --ranks 2 --device cpu

It starts ``--ranks`` processes on this host (``distributed.launch_local``),
on the card unless ``--device cpu`` asks for the CPU: NCCL, one rank per
GPU, or gloo ranks that may share one GPU when ``--backend gloo`` names it.
Each joins the group and, on tiny seeded shapes, runs on its slice of a
global batch (``PER_RANK`` images per rank) one fast_st train step, one
multi-style step (a style index per image) and one video scan step of three
frames, the third padded; then a Gatys Adam pass of two lanes, each with its
own Gram targets, placed over two slots of its device
(``mesh.Placement``), beside the same lanes unplaced. Each rank writes its
metrics, gradients and parameters after the steps to ``rank{r}.npz`` in
``--out``; the parent checks that every rank holds the same parameters and
metrics, bit for bit, and finite losses. The seeded inputs and models
(:func:`inputs`, :func:`models`) and the steps (:func:`run_steps`) are
public, so that a one-process run of the same global batch can be set
beside the ranks'.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from styletransfer_tpu_torch import constants

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SIZE = 32
PER_RANK = 2
STYLES = 2
VALID = (True, True, False)
GATYS_STEPS = 2
# Inputs on which no VGG max-pool window holds a tie that rounds apart in the
# two packages, so the port and JAX take the same subgradient: a test holds
# the ranks against the JAX step on them.
SEED = 0


def inputs(world: int) -> Dict[str, np.ndarray]:
    """The global inputs of a ``world``-rank run, from ``SEED``: a style
    image, a stack of ``STYLES`` styles, a batch of ``PER_RANK * world``
    images with a style index each, and ``len(VALID)`` frames of as many
    clips."""
    rng = np.random.default_rng(SEED)
    g = PER_RANK * world

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"style": normal(1, SIZE, SIZE, 3), "styles": normal(STYLES, SIZE, SIZE, 3) * 0.5,
            "batch": normal(g, SIZE, SIZE, 3), "idx": rng.integers(0, STYLES, g),
            "frames": normal(len(VALID), g, SIZE, SIZE, 3)}


def models(device) -> dict:
    """Seeded VGG, fast_st, multi-style and video parameters on ``device``."""
    from styletransfer_tpu_torch.models import multistyle, transformer, vgg

    return {"vgg": vgg.init_params(0, device=device),
            "fast": transformer.init_params(1, device=device),
            "multi": multistyle.init_params(3, STYLES, device=device),
            "video": transformer.init_video_params(2, device=device)}


def _record(out: dict, tag: str, params: torch.nn.Module, metrics: dict,
            grads: bool = True) -> None:
    for k, v in metrics.items():
        out[f"{tag}.metric.{k}"] = v.detach().float().cpu().numpy()
    for name, p in params.named_parameters():
        if grads:
            out[f"{tag}.grad.{name}"] = p.grad.cpu().numpy()
        out[f"{tag}.param.{name}"] = p.detach().cpu().numpy()


def run_steps(m: dict, inp: Dict[str, np.ndarray], rows: slice, device,
              shards=None) -> Dict[str, np.ndarray]:
    """One step of each trainer on ``rows`` of the global inputs (all rows
    and ``shards=None`` for one process), in place on ``m``'s parameters;
    returns the metrics, the gradients and the parameters after the step,
    by ``{trainer}.{kind}.{name}``. The video scan runs its first frame,
    whose gradients are kept (later frames' depend on the Adam steps
    before them), then the other two."""
    from styletransfer_tpu_torch.engines import fast, multistyle, video
    from styletransfer_tpu_torch.models import vgg

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    out: Dict[str, np.ndarray] = {}
    grams = vgg.style_gram_targets(m["vgg"], dev(inp["style"]))
    batch = dev(inp["batch"][rows])
    step = fast.make_train_step(m["vgg"], grams, shards=shards)
    _record(out, "fast", m["fast"], step(m["fast"], fast.make_optimizer(m["fast"]), batch))

    style_grams = multistyle.stack_style_grams(m["vgg"], dev(inp["styles"]))
    step = multistyle.make_train_step(m["vgg"], style_grams, shards=shards)
    _record(out, "multi", m["multi"], step(m["multi"], fast.make_optimizer(m["multi"]), batch,
                                           inp["idx"][rows]))

    opt, scan = video.make_scan_train_step(m["vgg"], grams, shards=shards)
    frames, optimizer = dev(inp["frames"][:, rows]), opt(m["video"])
    mask = video.freeze_mask(m["video"], False)
    _, _, content, stylized, first = scan(m["video"], optimizer, frames[:1], list(VALID[:1]),
                                          frames[0], frames[0], mask)
    for name, p in m["video"].named_parameters():
        out[f"video.grad.{name}"] = p.grad.cpu().numpy()
    *_, rest = scan(m["video"], optimizer, frames[1:], list(VALID[1:]), content, stylized, mask)
    _record(out, "video", m["video"], {k: torch.cat([first[k], rest[k]]) for k in first},
            grads=False)
    return out


def gatys_lanes(vgg_params, inp: Dict[str, np.ndarray], devices: Sequence) -> Dict[str, np.ndarray]:
    """Two Gatys lanes (the first two images, against the style and the
    first of the stack) for ``GATYS_STEPS`` Adam steps, placed over
    ``devices`` and unplaced."""
    from styletransfer_tpu_torch.engines import gatys
    from styletransfer_tpu_torch.models import vgg
    from styletransfer_tpu_torch.parallel import mesh

    device = devices[0]
    contents = torch.from_numpy(inp["batch"][:2]).to(device)
    per_lane = [vgg.style_gram_targets(vgg_params, torch.from_numpy(s).to(device))
                for s in (inp["style"], inp["styles"][:1])]
    grams = {k: torch.cat([g[k] for g in per_lane]) for k in per_lane[0]}
    args = (GATYS_STEPS, 1e5, 1.0, 0.05, "adam")
    placed = gatys._run_serve_placed(mesh.Placement(devices, vgg_params), contents, grams, *args)
    alone = gatys._run_serve_batched(vgg_params, contents, grams, *args)
    return {"gatys.placed.pixels": placed[0].cpu().numpy(),
            "gatys.placed.losses": placed[1].cpu().numpy(),
            "gatys.alone.pixels": alone[0].cpu().numpy(),
            "gatys.alone.losses": alone[1].cpu().numpy()}


def _rank_main(args) -> int:
    from styletransfer_tpu_torch.parallel import distributed

    if args.threads:
        torch.set_num_threads(args.threads)
    rank, world = distributed.initialize(device=args.device, backend=args.backend)
    device = torch.device(args.device)
    inp = inputs(world)
    m = models(device)
    rows = slice(rank * PER_RANK, (rank + 1) * PER_RANK)
    out = run_steps(m, inp, rows, device, distributed.global_batch())
    out.update(gatys_lanes(m["vgg"], inp, [device, device]))
    np.savez(os.path.join(args.out, f"rank{rank}.npz"), **out)
    distributed.shutdown()
    return 0


def check(results: Sequence[Dict[str, np.ndarray]]) -> dict:
    """Every rank's parameters and metrics bit for bit rank 0's, every loss
    finite, the placed Gatys lanes within 1e-4 of the unplaced. Returns a
    summary; raises AssertionError."""
    first = results[0]
    for r, res in enumerate(results[1:], 1):
        for k in first:
            if ".param." in k or ".metric." in k:
                assert np.array_equal(res[k], first[k]), f"rank {r} differs from rank 0 at {k}"
    totals = {tag: first[f"{tag}.metric.total"].tolist() for tag in ("fast", "multi", "video")}
    assert all(np.isfinite(v).all() for v in totals.values()), totals
    assert np.isfinite(first["gatys.placed.losses"]).all()
    gap = float(np.abs(first["gatys.placed.losses"] - first["gatys.alone.losses"]).max()
                / np.abs(first["gatys.alone.losses"]).max())
    assert gap < 1e-4, f"placed Gatys lanes {gap:.2e} from the unplaced"
    return {"ranks": len(results), "totals": totals, "gatys_lane_gap": gap}


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ranks", type=int, default=2)
    parser.add_argument("--device", default=constants.DEFAULT_DEVICE,
                        help="cuda (default) or cpu")
    parser.add_argument("--backend", default=None,
                        help="gloo or nccl (default: nccl on CUDA, gloo on the CPU)")
    parser.add_argument("--threads", type=int, default=0,
                        help="torch threads per rank (0: torch's default)")
    parser.add_argument("--out", default=None, help="directory of the ranks' .npz results")
    parser.add_argument("--timeout", type=float, default=600.0)
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        return _rank_main(args)

    from styletransfer_tpu_torch.parallel import distributed

    out = args.out or tempfile.mkdtemp(prefix="dryrun")
    os.makedirs(out, exist_ok=True)
    cmd = [sys.executable, "-m", "styletransfer_tpu_torch.parallel.dryrun", "--worker",
           "--device", args.device, "--threads", str(args.threads),
           "--out", out] + (["--backend", args.backend] if args.backend else [])
    try:
        ranks = distributed.launch_local(cmd, args.ranks, args.timeout, cwd=ROOT)
        for r, (code, log) in enumerate(ranks):
            if code:
                print(log[-6000:], file=sys.stderr)
                print(f"dryrun: rank {r} exited with {code}", file=sys.stderr)
                return 1
        summary = check([dict(np.load(os.path.join(out, f"rank{r}.npz")))
                         for r in range(args.ranks)])
    finally:
        if args.out is None:
            shutil.rmtree(out, ignore_errors=True)
    print(json.dumps({"dryrun": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
