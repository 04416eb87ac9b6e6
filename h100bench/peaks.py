"""Published peaks of one NVIDIA H100 SXM and the roofline bound.

Copied from the repository's ``chip_smoke.py`` (``PEAK_FLOPS``,
``PEAK_BYTES_PER_S``, ``bound``), so that a change to the program never
moves the yardstick. Dense rates without sparsity, at the card's full 700 W;
every result line names the card and the harness prints its power limit.
"""

from __future__ import annotations

from typing import Tuple

# f32 outside the tensor cores (TF32 is off in every cell), bf16 on them.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, dtype: str = "float32") -> Tuple[float, str]:
    """Least time on the card in seconds for ``flops`` operations and
    ``nbytes`` bytes moved, and which of the two bounds it."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")
