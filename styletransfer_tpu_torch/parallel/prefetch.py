"""Host -> device prefetch: keep the card fed while the host decodes.

The port of ``styletransfer_tpu/parallel/prefetch.py`` for one device. A
producer thread pulls batches from the (already thread-decoded) loader,
copies each into pinned host memory and starts a ``non_blocking`` copy to
the device, up to ``size`` batches ahead of the consumer. ``"cuda"`` is
the consumer's current device (a distributed rank's GPU), resolved before
the producer thread starts: a thread's current device is its own.

Spans (``utils/profiling.py``): the producer's ``data.load`` (the next
host batch) and ``data.copy`` (its copy to the device), the consumer's
``data.wait`` (blocked on the queue).

The generator cleans up after itself: if the consumer stops early
(``break``, an exception, ``max_steps_per_epoch``), the producer is told to
stop, the queued batches are dropped and the thread is joined.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from styletransfer_tpu_torch.utils import profiling

_SENTINEL = object()


def to_device(batch, device: torch.device) -> torch.Tensor:
    """One host batch (numpy array or tensor) as a tensor on ``device``;
    through pinned memory and an asynchronous copy on a CUDA device."""
    t = torch.from_numpy(np.ascontiguousarray(batch)) if isinstance(batch, np.ndarray) else batch
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def resolve_index(device) -> torch.device:
    """``device`` with the calling thread's current GPU filled in where a
    CUDA device names none."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def prefetch_to_device(iterable: Iterable, device, size: int = 2) -> Iterator[torch.Tensor]:
    """Wrap a host batch iterator with a device-prefetch queue of ``size``.

    Each yielded tensor lies on ``device``; on a CUDA device its copy was
    issued on the producer thread's stream after an event on it, and the
    consumer's stream waits for that event. Errors in the producer are
    raised on the consumer's side."""
    device = resolve_index(device)
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()
    err: list = []
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def _put(item) -> bool:
        """Blocking put that gives up when the consumer has stopped."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer() -> None:
        try:
            batches = iter(iterable)
            while True:
                with profiling.span("data.load"):
                    batch = next(batches, _SENTINEL)
                if batch is _SENTINEL:
                    break
                with profiling.span("data.copy"):
                    if stream is None:
                        item = (to_device(batch, device), None)
                    else:
                        with torch.cuda.stream(stream):
                            t = to_device(batch, device)
                            ready = torch.cuda.Event()
                            ready.record(stream)
                        item = (t, ready)
                if not _put(item):
                    return
        except Exception as exc:  # noqa: BLE001 - raised again on the consumer side
            err.append(exc)
        finally:
            _put(_SENTINEL)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            with profiling.span("data.wait"):
                item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            t, ready = item
            if ready is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(ready)
                # The tensor was made on the producer's stream; tell the
                # allocator that the consumer's stream now uses it.
                t.record_stream(current)
            yield t
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        thread.join(timeout=5)
