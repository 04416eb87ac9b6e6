"""Readings shared by the per-layer metrics (``metrics/<name>.py``). Each
returns None where its run recorded nothing to read."""

from __future__ import annotations

from typing import Any, Dict, Optional

from h100bench import peaks

Layer = Dict[str, Any]


def idle_share(layer: Layer) -> Optional[float]:
    """Per cent of the traced stretch in which the card ran nothing."""
    tr = layer.get("trace")
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def mfu(layer: Layer) -> Optional[float]:
    """Per cent of the card's f32 peak that the model's operations reach
    over the untraced stretch of a traced run."""
    rate = layer.get("model_flops_per_s")
    if not rate:
        return None
    return 100.0 * rate / peaks.PEAK_FLOPS["float32"]


def roofline(layer: Layer, group: str, bound_s: float) -> Optional[float]:
    """Per cent of a kernel's bound (``bound_s`` for the calls the traced
    stretch made) over its device time there."""
    tr = layer.get("trace")
    if tr is None or bound_s <= 0:
        return None
    spent = tr.group_s(group)
    if spent <= 0:
        return None
    return 100.0 * bound_s / spent


def group_share(layer: Layer, group: str) -> Optional[float]:
    """Per cent of the kernels' device time spent in one group."""
    tr = layer.get("trace")
    if tr is None or tr.kernel_busy_s <= 0:
        return None
    return 100.0 * tr.group_s(group) / tr.kernel_busy_s
