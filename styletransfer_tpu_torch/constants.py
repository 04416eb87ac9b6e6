"""Global constants and device selection.

The contract of ``styletransfer_tpu/constants.py`` for what the port uses:
ImageNet normalization statistics, the working resolution, the project root
(relocatable with ``STX_PROJECT_ROOT``), the checkpoint and TensorBoard
directories.
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

# Default locations of model checkpoints and of TensorBoard runs.
MODELS_PATH = "data/models/"
RUNS_PATH = "runs/"

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """The ``torch.device`` an entry point runs on.

    A CUDA device without a GPU raises: the port never falls back to the CPU
    on its own. Pass ``device="cpu"`` to run there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} was asked for but no CUDA GPU is available; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    return dev
