"""Serving executables, and the training step's gradients, on CUDA graphs.

The port of ``styletransfer_tpu/utils/aot.py``. JAX's ``cached_compile``
gives the serving commands one compiled program per fixed input shape. The
port's counterpart is a CUDA graph of the serving forward: captured once for
each ``(device, shapes, dtypes)`` of the tensor arguments, then replayed, so a
call costs the host one graph launch instead of one launch per kernel (about
forty for the transform net's forward).

As in JAX it is off unless ``STX_AOT_CACHE=1``, and :func:`cached_compile`
returns ``fn`` itself when it is off or when the example arguments are not
on CUDA (the CPU runs ``fn`` as it is). A capture that fails logs a WARNING
with the error and leaves that shape to ``fn``, as JAX falls back to
``jit``: the eager path runs the same kernels on the same card.

What is captured:

- ``fn`` runs ``WARMUP`` times on a side stream first, which builds and loads
  the kernels, lets cuDNN choose its algorithms, and allocates the kernels'
  workspaces kept per (device, stream) (``ops/cuda``), then once under
  capture on the same stream. Set the TF32 flags before (``make_serve_fn``
  does): the captured cuDNN calls keep the flags of their capture.
- The tensor arguments are copied into static buffers before each replay
  (the bf16 conv kernel's TMA descriptors hold raw addresses); other
  arguments, such as an ``nn.Module`` of parameters, are captured by
  address and are part of the key by identity. Their storage must stay
  where it is while the callable is used: load the parameters once, as
  ``process_image`` and ``process_dir`` do, and update them in place if at
  all.
- The output is the graph's static buffer, cloned for the caller.
- The kernels' launch counters (``ops/cuda``) move during the warm-up and
  the capture, not at a replay; :data:`captures` and :data:`replays` count
  the graphs.

:class:`GradGraphs` is the training step's counterpart (the JAX package
runs its step as one ``jit`` program): ``engines/fast.py::make_step``
replays the forward, loss and backward from one graph per key, on by
default, and runs Adam eagerly after it. :data:`train_captures` and
:data:`train_replays` count those graphs.

Nothing is written to disk: a graph holds device addresses and cannot
outlive its process. What persists between processes is the kernel build
cache (``utils/cache.py``), so JAX's ``STX_AOT_CACHE_DIR``, its pickled
entries and their digests have no counterpart here.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from styletransfer_tpu_torch.utils.logging import get_logger

# Eager runs of ``fn`` on the capture stream before the capture.
WARMUP = 2

# Graphs captured and replays run in this process.
captures = 0
replays = 0
# The same of the training steps' graphs (GradGraphs).
train_captures = 0
train_replays = 0


def _enabled() -> bool:
    return os.environ.get("STX_AOT_CACHE") == "1"


def _devices(args: Sequence[Any]) -> set:
    """The devices of the tensors and modules among ``args``."""
    devices = set()
    for a in args:
        if isinstance(a, torch.Tensor):
            devices.add(a.device)
        elif isinstance(a, torch.nn.Module):
            devices.update(p.device for p in a.parameters())
    return devices


def _on_cuda(args: Sequence[Any]) -> bool:
    devices = _devices(args)
    return bool(devices) and all(d.type == "cuda" for d in devices)


def _key(args: Sequence[Any]) -> Tuple:
    return tuple((a.device, tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor)
                 else ("id", id(a)) for a in args)


def _device_context(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _capture(fn: Callable, static_args: Sequence[Any], device: torch.device):
    """Warm ``fn`` up on a side stream, then capture one call of it there.
    Returns the graph, its output and the stream (kept alive with the graph,
    since the kernels' workspaces are keyed by the stream's handle)."""
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        for _ in range(WARMUP):
            fn(*static_args)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
        out = fn(*static_args)
    return graph, out, stream


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    return type(out)(_clone(o) for o in out)


class _Graphed:
    """``fn`` replayed from one CUDA graph per key of its arguments."""

    def __init__(self, fn: Callable, name: str):
        self.fn = fn
        self.name = name
        # key -> (graph, static args, static output, keep-alive), or None
        # where the capture failed and ``fn`` runs eagerly.
        self._graphs: Dict[Tuple, Any] = {}

    def _record(self, key: Tuple, args: Sequence[Any], device: torch.device):
        global captures
        static = [torch.empty_like(a).copy_(a) if isinstance(a, torch.Tensor) else a
                  for a in args]
        try:
            graph, out, keep = _capture(self.fn, static, device)
        except Exception as exc:  # noqa: BLE001 - serving goes on eagerly
            get_logger().warning("AOT cache: capturing %s at %s failed (%s); running it "
                                 "eagerly", self.name, key, exc)
            self._graphs[key] = None
            return None
        captures += 1
        get_logger().info("AOT cache: captured %s at %s", self.name, key)
        self._graphs[key] = entry = (graph, static, out, keep)
        return entry

    def __call__(self, *args):
        global replays
        key = _key(args)
        device = next(iter(_devices(args)))
        with _device_context(device):
            entry = self._graphs[key] if key in self._graphs else self._record(key, args,
                                                                               device)
            if entry is None:
                return self.fn(*args)
            graph, static, out, _ = entry
            for s, a in zip(static, args):
                if isinstance(a, torch.Tensor):
                    s.copy_(a)
            graph.replay()
            replays += 1
            return _clone(out)


class GradGraphs:
    """``grad_fn(params, *inputs) -> metrics``, a forward and backward that
    leaves every gradient in ``p.grad`` and returns a dict of 0-d tensors,
    replayed from one CUDA graph per key: the device, shape and dtype of
    each input and the identity of ``params`` (an ``nn.Module``).

    ``grad_fn`` must set the gradients to None before its backward, so that
    the captured backward allocates them in the graph's pool: a replay
    rewrites them there, and each replay points ``p.grad`` at them again
    (an eager step in between may have set them to None). The warm-ups on
    the capture stream only write gradients, which the replay overwrites.
    A capture that fails logs a WARNING and leaves its key to the eager
    step; every key is captured once, so a ragged last batch costs one
    capture in a run, not one an epoch."""

    def __init__(self, grad_fn: Callable, name: str):
        self.grad_fn = grad_fn
        self.name = name
        # key -> (graph, static inputs, static metrics, [(param, grad)],
        # keep-alive), or None where the capture failed.
        self._graphs: Dict[Tuple, Any] = {}

    def _record(self, key: Tuple, params: torch.nn.Module, inputs: Sequence[torch.Tensor]):
        global train_captures
        static = [torch.empty_like(a).copy_(a) for a in inputs]
        try:
            graph, out, keep = _capture(self.grad_fn, [params, *static], inputs[0].device)
        except Exception as exc:  # noqa: BLE001 - training goes on eagerly
            get_logger().warning("CUDA graph: capturing %s at %s failed (%s); running it "
                                 "eagerly", self.name, key, exc)
            self._graphs[key] = None
            return None
        grads = [(p, p.grad) for p in params.parameters() if p.grad is not None]
        train_captures += 1
        get_logger().info("CUDA graph: captured %s at %s", self.name, key)
        self._graphs[key] = entry = (graph, static, out, grads, keep)
        return entry

    def __call__(self, params: torch.nn.Module, *inputs) -> Optional[Dict[str, torch.Tensor]]:
        """One replay's metrics, cloned (a caller may keep them past the next
        replay), with every gradient in ``p.grad``; None where the step is
        to run eagerly: an input that is not a CUDA tensor, or a key whose
        capture failed."""
        global train_replays
        if not all(isinstance(a, torch.Tensor) and a.is_cuda for a in inputs):
            return None
        key = _key((params, *inputs))
        with torch.cuda.device(inputs[0].device):
            entry = (self._graphs[key] if key in self._graphs
                     else self._record(key, params, inputs))
            if entry is None:
                return None
            graph, static, out, grads, _ = entry
            for s, a in zip(static, inputs):
                s.copy_(a)
            graph.replay()
            train_replays += 1
            for p, g in grads:
                p.grad = g
            return {k: v.clone() for k, v in out.items()}


def cached_compile(fn: Callable, example_args: Sequence[Any], name: str) -> Callable:
    """``fn`` on CUDA graphs under ``STX_AOT_CACHE=1``, else ``fn`` itself.

    ``example_args`` are arguments of a first call (or the parameters alone,
    one module per device that will be served): the graphs are used when
    every tensor and module among them is on CUDA. The returned callable
    takes ``fn``'s positional arguments and captures a graph at the first
    call of each key: the device, shape and dtype of each tensor argument,
    and the identity of each other one (see the module docstring for what
    must hold between calls)."""
    if not _enabled() or not _on_cuda(example_args):
        return fn
    return _Graphed(fn, name)
