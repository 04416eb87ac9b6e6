"""Hand-written CUDA kernels for Hopper (``sm_90a``), one module per kernel.

Each module holds the wrapper, the plain PyTorch version of the same
function, and a ``launches`` counter. A wrapper computes the plain version
only when its tensors lie on the CPU; on CUDA tensors it launches the kernel
or raises.
"""

from __future__ import annotations

import torch


def check_cuda_inputs(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous, 16-byte aligned tensor on
    the first one's CUDA device (what the kernels' vector loads assume)."""
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"expected CUDA tensors, got one on {device}")
    for t in tensors:
        if t.device != device:
            raise ValueError(f"all tensors must be on {device}, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"tensors must be contiguous, got strides {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError("tensors must be 16-byte aligned")
