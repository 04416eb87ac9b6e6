"""Kernel-name groups, copied from the program's profiling module
(``styletransfer_tpu_torch/utils/profiling.py::_GROUPS`` / ``_group``).

First match wins. The IN kernel serves both the IN-pad of the serving
forward and the fused-IN forward of the training forward.
"""

from __future__ import annotations

GROUPS = (
    ("conv3x3_flat", ("conv3x3_flat_",)),
    ("conv3x3_im2col", ("conv3x3_im2col_",)),
    ("conv3x3_valid", ("conv3x3_", "tile_sums_kernel")),
    ("instance_norm", ("::in_kernel<",)),
    ("instance_norm_bwd", ("::inb_kernel<",)),
    ("conv_direct", ("::direct_kernel<",)),
    ("cudnn_conv", ("conv", "cudnn", "implicit", "winograd", "fft", "fprop", "dgrad",
                    "wgrad", "pointwise_mult_and_sum")),
    ("lbfgs_history", ("gemv", "trsm")),
    ("gemm", ("gemm", "cutlass")),
    ("adam", ("multi_tensor", "adam")),
)
OTHER = "other"


def group(kernel_name: str) -> str:
    """The group of a device kernel, by its name."""
    name = kernel_name.lower()
    for grp, keys in GROUPS:
        if any(k in name for k in keys):
            return grp
    return OTHER
