"""One run of one cell: load, warm up, measure, check, print one line.

Everything is found by name. A cell is ``cells/<cell>.json`` (its
configuration, the name of its traffic mix, chips, why, the traffic
``kind``, the kind's parameters under ``mix``, and the limit of each number
that decides ``correct``); a configuration is ``configs/<config>.json``; a
traffic kind is the module ``traffic/<kind>.py`` that generates and drives
it; a per-layer metric is ``metrics/<metric>.py``. Adding one is adding
files.

A traffic kind (``UNITS``: its end-to-end metrics and their units;
``run(run: Run) -> Outcome``) builds the program's state,
warms every shape the mix uses, calls ``run.window_starts()``, drives the
window, and returns what it measured with a ``verify`` callable that holds
only the benchmark's own inputs and the program's outputs. The harness then
reads the device's memory peak, lets the program's state go, runs
``verify`` (the plain reference, ``reference/``) and prints each number
beside its limit.
"""

from __future__ import annotations

import gc
import glob
import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE_DIR = os.path.join(HERE, "cache")
# Top-level module names that no run may hold once its window has closed:
# the JAX stack and the JAX package (compared whole, so that the port,
# ``styletransfer_tpu_torch``, passes).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax", "styletransfer_tpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
SETUP_S = "setup_s"


def set_cache_dirs() -> None:
    """Point every build and compile cache of the program at fixed folders
    inside the checkout, before the program is imported."""
    os.environ["STX_COMPILE_CACHE_DIR"] = os.path.join(CACHE_DIR, "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE_DIR, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE_DIR, "triton")
    os.environ.pop("STX_NO_COMPILE_CACHE", None)


def load_json(folder: str, name: str) -> Dict[str, Any]:
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    path = os.path.join(HERE, folder, f"{name}.json")
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    name = "h100bench._loaded." + os.path.basename(path)[:-3].replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_modules() -> Dict[str, Any]:
    """Every per-layer metric, by name (``metrics/<name>.py``)."""
    out = {}
    for path in sorted(glob.glob(os.path.join(HERE, "metrics", "*.py"))):
        name = os.path.basename(path)[:-3]
        if name != "__init__":
            out[name] = load_module(path)
    return out


def kind_module(kind: str):
    if not NAME.match(kind) or "." in kind:
        raise ValueError(f"not a traffic kind: {kind!r}")
    return importlib.import_module(f"h100bench.traffic.{kind}")


@dataclass
class Run:
    """One run's inputs, and the end of its set-up."""

    seed: int
    seconds: float
    trace: bool
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    device: Any
    workdir: str
    t_window: Optional[float] = None

    def window_starts(self, at: Optional[float] = None) -> None:
        """Set-up ends here (or at ``at``, a ``time.monotonic()`` reading)."""
        self.t_window = time.monotonic() if at is None else at


@dataclass
class Outcome:
    """What a traffic kind measured. ``end_to_end`` holds the cell's
    metrics other than ``setup_s``; ``layer`` what the per-layer metrics
    read (a traced run's ``trace.Trace`` under ``"trace"``, counts, spans);
    ``verify()`` returns each number compared, by name."""

    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    verify: Callable[[], Dict[str, float]]
    layer: Dict[str, Any] = field(default_factory=dict)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def forbidden_loaded() -> List[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def compare(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each number beside its limit; a number without a limit, or a limit
    without a number, is a fault of the cell's files."""
    if set(numbers) != set(limits):
        raise ValueError(f"numbers {sorted(numbers)} and limits {sorted(limits)} differ")
    return {k: {"value": float(numbers[k]), "limit": float(limits[k])} for k in limits}


def is_correct(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] == c["value"] and c["value"] <= c["limit"] for c in checks.values())


def execute(cell_name: str, seed: int, seconds: float, trace: bool, device,
            t_start: float, traffic_overrides: Optional[Dict[str, Any]] = None,
            config_overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Run one cell once on ``device`` and return its result line (a dict),
    or raise. The overrides shrink a cell for the tests on the CPU."""
    import torch

    cell = load_json("cells", cell_name)
    config = {**load_json("configs", cell["config"]), **(config_overrides or {})}
    traffic = {**cell["mix"], **(traffic_overrides or {})}
    kind = kind_module(cell["kind"])
    cuda = torch.device(device).type == "cuda"
    if cuda:
        from styletransfer_tpu_torch.ops.cuda import _build

        built = _build.build_all()  # only a checkout's first run builds
        if built:
            print(f"h100bench: built {', '.join(built)}", file=sys.stderr, flush=True)
        torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="h100bench-") as workdir:
        run = Run(seed, seconds, trace, config, traffic, torch.device(device), workdir)
        outcome = kind.run(run)
        if run.t_window is None:
            raise RuntimeError(f"traffic kind {cell['kind']!r} never started its window")
        found = forbidden_loaded()
        if found:
            raise RuntimeError(f"modules of the JAX stack were loaded: {', '.join(found)}")
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        checks = compare(outcome.verify(), cell["limits"])
    metrics: Dict[str, Dict[str, Any]] = {}
    if trace:
        for name, m in metric_modules().items():
            if cell_name not in m.WORKLOADS:
                continue
            value = m.read(outcome.layer, config, traffic)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": m.UNIT}
    else:
        metrics[SETUP_S] = {"value": run.t_window - t_start, "unit": "s"}
        for name, value in outcome.end_to_end.items():
            metrics[name] = {"value": float(value), "unit": kind.UNITS[name]}
    dev: Dict[str, Any] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": torch.cuda.device_count() if cuda else 0,
        "memory_peak_bytes": int(peak),
    }
    line: Dict[str, Any] = {"correct": is_correct(checks), "attempted": outcome.attempted,
                            "failed": outcome.failed, "metrics": metrics, "device": dev}
    tr = outcome.layer.get("trace")
    if tr is not None:
        print(f"h100bench: traced {tr.kernels} device operations in {tr.window_s:.3f} s, "
              f"read in {tr.parse_s:.1f} s", file=sys.stderr, flush=True)
    if trace and tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        line["breakdown"] = {"device_ops": [list(x) for x in tr.device_ops],
                             "idle_gaps": [list(x) for x in tr.idle_gaps]}
    found = forbidden_loaded()
    if found:
        raise RuntimeError(f"modules of the JAX stack were loaded: {', '.join(found)}")
    line["checks"] = checks
    return line


def main(argv: Optional[List[str]] = None, t_start: Optional[float] = None) -> int:
    import argparse

    t_start = time.monotonic() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="python -m h100bench",
                                 description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True, help="the cell's name (cells/<name>.json)")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="length of the window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    set_cache_dirs()
    import torch

    cell = load_json("cells", args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"h100bench: the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    print(f"h100bench: {args.workload} seed {args.seed} on {card_line()}", file=sys.stderr)
    try:
        line = execute(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                       t_start)
    except Exception as exc:  # noqa: BLE001 - the run fails with no result line
        import traceback

        traceback.print_exc()
        print(f"h100bench: failed: {exc}", file=sys.stderr)
        return 1
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
