"""Global constants and device selection.

The contract of ``styletransfer_tpu/constants.py`` for what the port uses:
ImageNet normalization statistics, the working resolution, the project root
(relocatable with ``STX_PROJECT_ROOT``), the checkpoint and TensorBoard
directories, the log file and the default device.
"""

from __future__ import annotations

import os

import torch

# ImageNet statistics used to normalize inputs / denormalize outputs.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# Working resolution: inputs are center-cropped square, then resized to
# IMSIZE x IMSIZE.
IMSIZE = 256

# Repository root (the directory containing this package). STX_PROJECT_ROOT
# relocates every derived path (data/, results/).
PROJECT_ROOT_PATH = os.environ.get("STX_PROJECT_ROOT") or os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))
)

# Default locations of model checkpoints, of TensorBoard runs and of the
# log file (``utils/logging.py``; truncated by each run).
MODELS_PATH = "data/models/"
RUNS_PATH = "runs/"
LOG_PATH = os.path.join(RUNS_PATH, "runtime.log")

# The device of every entry point that is given none; ``STX_PLATFORM=cpu``
# makes it the CPU (``utils/cache.py::apply_platform``, at package import).
DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """The ``torch.device`` an entry point runs on (None: ``DEFAULT_DEVICE``).

    A CUDA device without a GPU raises: the port never falls back to the CPU
    on its own. Pass ``device="cpu"`` to run there."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} was asked for but no CUDA GPU is available; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    return dev
