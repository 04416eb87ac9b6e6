"""Device placement: the global batch of a training run, and the serving
paths' data parallelism over the devices of one process.

The port of ``styletransfer_tpu/parallel/mesh.py``. The JAX package builds a
1-D mesh and lets XLA place a sharded batch and replicated parameters; in
PyTorch the two halves are separate:

- training runs one process per GPU (``parallel/distributed.py``), so a
  single process trains on one device; on a host with more GPUs it says
  which stay idle and how to launch one process per device
  (:func:`warn_single_process_training`);
- serving keeps one replica of the parameters on each device of one
  process (:func:`serving_placement`): a batch is split evenly over the
  devices, each shard's forward is launched on its own device (CUDA
  launches return at once, so the devices run together), and the outputs
  are gathered on the host. With one device it is the single-device code
  path exactly.
"""

from __future__ import annotations

import copy
from typing import Callable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from styletransfer_tpu_torch import constants
from styletransfer_tpu_torch.parallel import prefetch
from styletransfer_tpu_torch.utils.logging import get_logger


def resolve_global_batch(batch_size: int, global_batch) -> int:
    """The training global batch from ``--global-batch``.

    - ``None`` or empty (the default): ``batch_size`` is the global batch
      (the reference's semantics);
    - ``"auto"``: ``batch_size`` is per device; the global batch is
      ``batch_size`` times the number of ranks (one device each);
    - an integer string: an explicit global batch.

    Adam's learning rate stays at the reference default (1e-3) whatever the
    global batch; scaling it is left to the caller."""
    from styletransfer_tpu_torch.parallel import distributed

    if global_batch in (None, ""):
        return batch_size
    n = distributed.process_info()[1]
    if str(global_batch).lower() == "auto":
        resolved = batch_size * n
        get_logger().info(
            "--global-batch auto: -b %d is per-chip; global batch = %d over %d device(s). "
            "Adam lr stays at the reference default (1e-3) — consider the linear/sqrt "
            "lr-scaling rule for large global batches.", batch_size, resolved, n)
        return resolved
    resolved = int(global_batch)
    if resolved < 1:
        raise ValueError(f"--global-batch must be >= 1, got {resolved}")
    get_logger().info("--global-batch %d (explicit): overrides -b %d; %d device(s) available.",
                      resolved, batch_size, n)
    return resolved


def default_devices(device=constants.DEFAULT_DEVICE) -> List[torch.device]:
    """The devices a caller's ``device`` stands for: ``"cuda"`` (no index)
    is every visible GPU; any other device is itself alone."""
    dev = constants.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def auto_devices(batch_size: int, devices: Optional[Sequence] = None) -> List[torch.device]:
    """The most of ``devices`` (default: every visible GPU) that divide
    ``batch_size`` evenly, with a warning naming the idle ones."""
    devices = [torch.device(d) for d in devices] if devices is not None else \
        default_devices()
    n = len(devices)
    while n > 1 and batch_size % n:
        n -= 1
    if n < len(devices):
        get_logger().warning(
            "auto_mesh: batch size %d does not divide the %d available devices; using a "
            "%d-device mesh (%d device(s) idle). Pick a batch size divisible by the device "
            "count to use every chip.", batch_size, len(devices), n, len(devices) - n)
    return devices[:n]


def warn_single_process_training(device: torch.device, world: int) -> None:
    """One process trains on one device: on a host with more GPUs, say how
    many stay idle and how to use them."""
    count = torch.cuda.device_count() if device.type == "cuda" else 1
    if world == 1 and count > 1:
        get_logger().warning(
            "auto_mesh: training in one process uses 1 of the %d visible GPUs (%d device(s) "
            "idle). Launch one process per device to use every chip: torchrun "
            "--nproc-per-node %d -m styletransfer_tpu_torch <command> --distributed.",
            count, count - 1, count)


def shard_bounds(n: int, parts: int) -> List[Tuple[int, int]]:
    """``parts`` contiguous ``[start, stop)`` ranges of ``n`` rows, sizes
    differing by at most one (the first ones larger), empty ones left out."""
    base, extra = divmod(n, parts)
    bounds, start = [], 0
    for i in range(parts):
        stop = start + base + (i < extra)
        if stop > start:
            bounds.append((start, stop))
        start = stop
    return bounds


def _to(x, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
    return t.to(device)


def _take(x, axis: int, start: int, stop: int):
    index = (slice(None),) * axis + (slice(start, stop),)
    return x[index]


def shard_batch(batch, devices: Sequence[torch.device], axis: int = 0) -> List[torch.Tensor]:
    """``batch`` (a numpy array or a tensor) split on ``axis`` over
    ``devices`` by :func:`shard_bounds`, each part on its device; a device
    left without rows gets no part."""
    return [_to(_take(batch, axis, a, b), d)
            for d, (a, b) in zip(devices, shard_bounds(batch.shape[axis], len(devices)))]


def shard_frames(chunk, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """A ``[T, B, ...]`` frame chunk split on axis 1 (the lanes)."""
    return shard_batch(chunk, devices, axis=1)


def _device_of(params) -> torch.device:
    if isinstance(params, torch.nn.Module):
        return next(params.parameters()).device
    if isinstance(params, Mapping):
        return _device_of(next(iter(params.values())))
    return params.device


def _moved(params, device: torch.device):
    if isinstance(params, torch.nn.Module):
        return copy.deepcopy(params).to(device)
    if isinstance(params, Mapping):
        return {k: _moved(v, device) for k, v in params.items()}
    return params.to(device)


def replicate(params, devices: Sequence[torch.device]) -> list:
    """One copy of ``params`` (a module, or nested mappings of tensors such
    as VGG's) per device; devices that hold it already (or repeat in the
    list) share one object."""
    copies = {_device_of(params): params}
    out = []
    for d in devices:
        if d not in copies:
            copies[d] = _moved(params, d)
        out.append(copies[d])
    return out


class Gathered:
    """The per-device outputs of one :meth:`Placement.run`; ``cpu()`` waits
    for each device and concatenates the parts on the host, in order."""

    def __init__(self, parts: List[torch.Tensor]):
        self.parts = parts

    def cpu(self) -> torch.Tensor:
        return self.to(torch.device("cpu"))

    def to(self, device) -> torch.Tensor:
        """The parts concatenated on ``device``."""
        return torch.cat([p.to(device) for p in self.parts])


class Placement:
    """Parameters replicated on ``devices`` and batches split over them.

    ``params`` is the first device's replica; :meth:`place_params` replaces
    every replica (a daemon's ``RELOAD``)."""

    def __init__(self, devices: Sequence, params):
        # "cuda" is the current GPU: one device, whichever way it is named.
        self.devices = [prefetch.resolve_index(d) for d in devices]
        self.place_params(params)

    def place_params(self, params):
        self.replicas = replicate(params, self.devices)
        return self.replicas[0]

    @property
    def params(self):
        return self.replicas[0]

    def split(self, *arrays) -> List[tuple]:
        """``(replica, *parts)`` of each device that has a share of
        ``arrays`` (numpy arrays or tensors with a leading batch axis, each
        split by :func:`shard_batch`), in the devices' order."""
        return list(zip(self.replicas, *(shard_batch(a, self.devices) for a in arrays)))

    def run(self, fn: Callable, *arrays):
        """``fn(replica, *parts)`` on every device's share of ``arrays``,
        launched device after device; returns the output with one device,
        else a :class:`Gathered` of the parts."""
        if len(self.devices) == 1:
            return fn(self.replicas[0], *(_to(a, self.devices[0]) for a in arrays))
        return Gathered([fn(*share) for share in self.split(*arrays)])


def serving_placement(batch_size: int, params,
                      devices: Optional[Sequence] = None,
                      device=constants.DEFAULT_DEVICE) -> Placement:
    """The placement of every batched serving path: ``params`` replicated
    over :func:`auto_devices` of ``batch_size`` (``devices``, or those that
    ``device`` stands for), batches split over them. A serial path (batch 1)
    stays on the first device without the idle-devices warning."""
    if devices is None:
        devices = default_devices(device)
    devices = [torch.device(d) for d in devices]
    if batch_size > 1:
        devices = auto_devices(batch_size, devices)
    return Placement(devices[:1] if batch_size <= 1 else devices, params)
