"""Build the CUDA sources in ``csrc/`` with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
loaded with :mod:`ctypes` (no PyTorch headers, so a build takes seconds).
Libraries go to ``build/kernels/`` beside the package (listed in
``.gitignore``; ``utils/cache.py::cache_dir``: ``STX_COMPILE_CACHE_DIR``
moves it, ``STX_NO_COMPILE_CACHE=1`` takes a new temporary directory for
each process), named by a hash of their source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt and an
unchanged one is reused. Each is written under a temporary name and renamed
into place.

``build_all()`` starts one ``nvcc`` per source, all at once, and waits for
them; ``library(name)`` builds what is missing and returns the loaded
library. Both raise on a failed build: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

from styletransfer_tpu_torch.utils import cache

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = cache.cache_dir()

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# The ptxas report (registers, shared memory, spills) of each build of this
# process, by source name.
build_logs: Dict[str, str] = {}


def sources() -> List[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(f[:-3] for f in os.listdir(SOURCE_DIR) if f.endswith(".cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
            "kernels are built on the machine with the GPU"
        )
    return path


def _target(name: str) -> str:
    # The shared headers (csrc/*.cuh) are part of every source's hash.
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(SOURCE_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(SOURCE_DIR, fname), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def _start(name: str, target: str) -> "tuple[subprocess.Popen, str]":
    tmp = f"{target}.tmp.{os.getpid()}.{threading.get_native_id()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(SOURCE_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, target: str, proc: subprocess.Popen, tmp: str) -> None:
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed to build csrc/{name}.cu:\n{log}")
    os.replace(tmp, target)


def build_all() -> List[str]:
    """Build every missing library, one ``nvcc`` per source in parallel.

    Returns the names that were compiled (empty when all were built)."""
    with _lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        todo = [(n, _target(n)) for n in sources()]
        todo = [(n, t) for n, t in todo if not os.path.exists(t)]
        procs = [(n, t, *_start(n, t)) for n, t in todo]
        errors = []
        for n, t, proc, tmp in procs:
            try:
                _finish(n, t, proc, tmp)
            except RuntimeError as exc:
                errors.append(str(exc))
        if errors:
            raise RuntimeError("\n".join(errors))
        return [n for n, _ in todo]


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        target = _target(name)
        if not os.path.exists(target):
            os.makedirs(BUILD_DIR, exist_ok=True)
            _finish(name, target, *_start(name, target))
        lib = ctypes.CDLL(target)
        _loaded[name] = lib
        return lib
