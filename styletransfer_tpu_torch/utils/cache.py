"""The build cache, platform and precision knobs of the package.

The port of ``styletransfer_tpu/utils/cache.py``. What persists between
processes here is the kernel build directory (``ops/cuda/_build.py``): one
shared library per CUDA source, named by a hash of its source, reused by
every later process. The knobs, each with no effect when unset:

- ``STX_COMPILE_CACHE_DIR``: the build directory (default ``build/kernels/``
  beside the package);
- ``STX_NO_COMPILE_CACHE=1``: build into a new temporary directory for each
  process (removed at its exit), so nothing built earlier is reused;
- ``STX_PLATFORM``: ``cpu`` makes the CPU the default device of every entry
  point and CLI (``constants.DEFAULT_DEVICE``); ``cuda`` or ``gpu`` keeps
  the GPU. This is the caller asking for the CPU: a CUDA device asked for
  without a GPU still raises;
- ``STX_MATMUL_PRECISION``: the precision of cuDNN's f32 convolutions and
  cuBLAS's f32 matmuls (:func:`apply_matmul_precision`).

The package applies the platform and the precision when it is imported
(:func:`enable_persistent_cache`, as the JAX package does).
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from typing import Optional

from styletransfer_tpu_torch import constants

_DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "kernels")

# This process's build directory under STX_NO_COMPILE_CACHE=1.
_temp_dir: Optional[str] = None


def cache_dir() -> str:
    """The kernel build directory in effect for this process."""
    global _temp_dir
    if os.environ.get("STX_NO_COMPILE_CACHE") == "1":
        if _temp_dir is None:
            _temp_dir = tempfile.mkdtemp(prefix="stx-kernels-")
            atexit.register(shutil.rmtree, _temp_dir, True)
        return _temp_dir
    return os.environ.get("STX_COMPILE_CACHE_DIR") or _DEFAULT_DIR


def _warn(msg: str, *args) -> None:
    from styletransfer_tpu_torch.utils.logging import get_logger

    get_logger().warning(msg, *args)


_PLATFORMS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}


def apply_platform() -> None:
    """Apply ``STX_PLATFORM`` to ``constants.DEFAULT_DEVICE``; any value but
    ``cpu``, ``cuda`` or ``gpu`` is ignored with a warning."""
    value = os.environ.get("STX_PLATFORM")
    if not value:
        return
    if value.lower() not in _PLATFORMS:
        _warn("STX_PLATFORM=%r is not one of %s; ignoring.", value, ", ".join(_PLATFORMS))
        return
    constants.DEFAULT_DEVICE = _PLATFORMS[value.lower()]


_VALID_PRECISIONS = ("default", "high", "highest", "bfloat16",
                     "bfloat16_3x", "tensorfloat32", "float32")
_warned: set = set()


def apply_matmul_precision() -> bool:
    """Apply ``STX_MATMUL_PRECISION`` to torch's f32 convolution and matmul
    flags; True when it was applied.

    - ``highest`` or ``float32``: TF32 off for cuDNN and cuBLAS (what the
      port does with the knob unset, ``ops/layers.py::disable_tf32``);
    - ``high``, ``tensorfloat32`` or ``default``: TF32 on for both;
    - ``bfloat16`` or ``bfloat16_3x``: ``torch.set_float32_matmul_precision
      ("medium")`` and TF32 on for cuDNN.

    Unset, it changes nothing; any other value is ignored with a warning
    (once per value), as JAX ignores it. The hand-written kernels
    (``csrc/``) compute f32 with FMAs on the CUDA cores, or bf16 on the
    tensor cores, whatever the knob says: it moves only the library calls.
    """
    value = os.environ.get("STX_MATMUL_PRECISION")
    if not value:
        return False
    if value not in _VALID_PRECISIONS:
        if value not in _warned:
            _warned.add(value)
            _warn("STX_MATMUL_PRECISION=%r is not one of %s; ignoring.",
                  value, ", ".join(_VALID_PRECISIONS))
        return False
    import torch

    if value in ("highest", "float32"):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif value in ("high", "tensorfloat32", "default"):
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    else:
        torch.set_float32_matmul_precision("medium")
        torch.backends.cudnn.allow_tf32 = True
    return True


def enable_persistent_cache() -> None:
    """Apply the platform and precision knobs (at package import). The
    kernel build cache needs no set-up: ``ops/cuda/_build.py`` builds into
    :func:`cache_dir` and reuses what it finds there."""
    apply_platform()
    apply_matmul_precision()
