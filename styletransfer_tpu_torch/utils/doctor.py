"""Environment diagnostics: ``python -m styletransfer_tpu_torch doctor``.

The port of ``styletransfer_tpu/utils/doctor.py`` for a CUDA machine. It
probes the card in a subprocess with a timeout, so that a CUDA stack that hangs
cannot hang the doctor, and reports every dependency the port degrades
without: ``nvcc`` and the kernel build, pretrained VGG19, mp4 codecs, demo
assets and checkpoints, with the fallback in effect for each.

Statuses, as in the JAX package: ``ok`` (working), ``warn`` (degraded, a
documented fallback is in effect), ``fail`` (an actionable problem),
``info`` (context). The command exits non-zero only on ``fail``: warnings
are normal where nothing can be downloaded. A machine without a card fails
the card's probe (``--backend auto``); nothing reports the CPU in its place.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Callable, List, NamedTuple, Optional


class Check(NamedTuple):
    name: str
    status: str  # ok | warn | fail | info
    detail: str


# One process that imports the package, runs a one-element op on the
# device, times a second one's round trip and prints the result as JSON.
_PROBE = """
import json, sys, time
import torch
import styletransfer_tpu_torch
device = sys.argv[1]
out = {"torch": torch.__version__, "cuda": torch.version.cuda}
if device == "cuda":
    if not torch.cuda.is_available():
        print(json.dumps(dict(out, error="torch.cuda.is_available() is False")))
        sys.exit(0)
    out.update(name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
z = torch.zeros(1, device=device)
float((z + 1.0).sum())
t0 = time.perf_counter()
float((z + 1.0).sum())
out["rtt_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
print(json.dumps(out))
"""


def _probe(device: str, timeout: float) -> Check:
    """Ask a subprocess for a one-element op on ``device`` ("cuda": the
    card's name and count too) and its round trip."""
    name = "backend" if device == "cuda" else "backend (cpu)"
    # The package's parent directory first on the path, wherever this runs.
    parent = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (parent, os.environ.get("PYTHONPATH")) if p))
    try:
        proc = subprocess.run([sys.executable, "-c", _PROBE, device], capture_output=True,
                              text=True, timeout=timeout, env=env)
    except subprocess.TimeoutExpired:
        return Check(name, "fail", f"no answer in {timeout:.0f}s: the card or its CUDA stack "
                                   "hangs (a first CUDA init takes seconds, not minutes)")
    if proc.returncode != 0:
        tail = " ".join(proc.stderr.split())[-300:]
        return Check(name, "fail", f"probe failed: ...{tail}")
    # Libraries may print banners: take the last line, and report anything
    # else rather than crash on it.
    lines = [line for line in proc.stdout.splitlines() if line.strip()]
    try:
        out = json.loads(lines[-1])
    except (IndexError, ValueError):
        return Check(name, "fail", f"probe printed unexpected output: {proc.stdout!r:.300}")
    if "error" in out:
        return Check(name, "fail", f"no CUDA GPU: {out['error']} (torch {out['torch']}, "
                                   f"CUDA {out['cuda']}); pass --device cpu to run on the CPU")
    if device == "cuda":
        return Check(name, "ok", f"{out['name']}, {out['count']} device(s), dispatch rtt "
                                 f"{out['rtt_ms']} ms")
    return Check(name, "ok", f"cpu, dispatch rtt {out['rtt_ms']} ms")


def _kernel_checks() -> List[Check]:
    """``nvcc``, and which kernel sources have a library built for their
    current hash (``ops/cuda/_build.py``); a missing one is built at first
    use."""
    from styletransfer_tpu_torch.ops.cuda import _build

    checks = []
    try:
        checks.append(Check("nvcc", "ok", _build._nvcc()))
    except RuntimeError as exc:
        checks.append(Check("nvcc", "warn", f"{exc}; the kernels cannot be built here"))
    names = _build.sources()
    built = [n for n in names if os.path.isfile(_build._target(n))]
    missing = sorted(set(names) - set(built))
    if missing:
        checks.append(Check("kernel build", "warn",
                            f"{len(built)} of {len(names)} sources built in "
                            f"{_build.BUILD_DIR}; built at first use: {', '.join(missing)}"))
    else:
        checks.append(Check("kernel build", "ok",
                            f"all {len(names)} sources built in {_build.BUILD_DIR}"))
    return checks


def run_checks(
    backend: str = "auto",
    timeout: float = 120.0,
    progress: Optional[Callable[[Check], None]] = None,
) -> List[Check]:
    """Run every check. ``backend`` is ``auto`` (probe the card and the CPU
    path), ``cpu`` (the CPU path only) or ``none`` (no device probe)."""
    import torch

    from styletransfer_tpu_torch import constants

    checks: List[Check] = []

    def add(c: Check) -> None:
        checks.append(c)
        if progress is not None:
            progress(c)

    add(Check("versions", "info", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
                                  f"CUDA {torch.version.cuda}"))
    root = constants.PROJECT_ROOT_PATH
    writable = os.access(root, os.W_OK)
    add(Check("project root", "ok" if writable else "fail",
              f"{root} ({'writable' if writable else 'NOT writable'}"
              + (", STX_PROJECT_ROOT override" if os.environ.get("STX_PROJECT_ROOT") else "")
              + ")"))

    if backend == "auto":
        add(_probe("cuda", timeout))
    if backend in ("auto", "cpu"):
        add(_probe("cpu", timeout))

    for c in _kernel_checks():
        add(c)

    # Pretrained VGG19: optional (a deterministic seeded init stands in, but
    # stylization quality needs the real one).
    from styletransfer_tpu_torch.models import vgg

    w = vgg.find_weights()
    add(Check("vgg19 weights", "ok", w) if w else Check(
        "vgg19 weights", "warn",
        "not found: seeded-init fallback active (deterministic, but stylization quality "
        "needs pretrained weights); set STX_VGG19_WEIGHTS or put vgg19.pth in data/models/"))

    # mp4 codecs: optional; video output falls back to GIF (engines/video.py).
    import importlib.util

    have = [m for m in ("imageio_ffmpeg", "av") if importlib.util.find_spec(m)]
    if have and importlib.util.find_spec("imageio"):
        add(Check("mp4 codecs", "ok", f"imageio with {', '.join(have)}"))
    else:
        add(Check("mp4 codecs", "warn", "no imageio with ffmpeg or pyav: video output falls "
                                        "back to GIF (Pillow)"))

    # Demo assets and checkpoints: what can be driven right now.
    demo = os.path.join(root, "data", "demo_content.png")
    present = os.path.isfile(demo)
    add(Check("demo assets", "ok" if present else "info",
              "present" if present else "absent (utils/demo.ensure_demo_assets writes them)"))
    models_dir = os.path.join(root, "data", "models")
    if os.path.isdir(models_dir):
        from styletransfer_tpu_torch import ckpt

        names = [f for f in os.listdir(models_dir) if f.endswith((ckpt.CKPT_SUFFIX, ".pth"))]
        add(Check("checkpoints", "ok" if names else "info",
                  f"{len(names)} checkpoint(s) in {models_dir}"))
    else:
        add(Check("checkpoints", "info", f"{models_dir} absent (created by training)"))
    return checks


TAGS = {"ok": "[ OK ]", "warn": "[WARN]", "fail": "[FAIL]", "info": "[ -- ]"}


def format_checks(checks: List[Check]) -> str:
    width = max(len(c.name) for c in checks)
    return "\n".join(f"{TAGS[c.status]} {c.name.ljust(width)}  {c.detail}" for c in checks)
