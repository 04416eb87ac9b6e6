"""Multi-process data-parallel training on ``torch.distributed``.

The port of ``styletransfer_tpu/parallel/distributed.py``. One process per
GPU, as ``torchrun`` launches them: parameters and Adam state are
replicated (every rank holds the same values), each rank decodes a disjoint
strided shard of the corpus (``DataLoader(shard_index, shard_count)``) and
trains on its slice of the global batch, and after the backward one
all-reduce of a flat buffer (every gradient, then the step's metrics)
averages the ranks, as XLA's one psum does in the JAX trainers
(:meth:`GlobalBatch.average`). The net is not wrapped in
``DistributedDataParallel``: the objective runs ``apply_stacked`` on the
parameter module, not its ``forward``, whose hooks DDP relies on.

Each rank's objective is built so that the mean over the ranks is the
global batch's loss, as the JAX step computes it on the global array: the
batch means (style, content) are the rank's own; a sum over the batch
(total variation) counts ``world`` times its rank's share; a loss that is
not a sum over images (the temporal loss's norms, the eval's squared feature
MSE) reduces its partial sums over the group inside the forward
(:meth:`GlobalBatch.sum`) and is the same on every rank.

Configuration comes from the arguments or the environment, one process per
device:

- ``STX_COORDINATOR_ADDRESS`` (or ``torchrun``'s ``MASTER_ADDR`` and
  ``MASTER_PORT``): ``host:port`` of rank 0's store;
- ``STX_NUM_PROCESSES`` (or ``WORLD_SIZE``): the number of ranks;
- ``STX_PROCESS_ID`` (or ``RANK``): this rank;
- ``LOCAL_RANK`` (``torchrun``): this rank's GPU on its host; without it,
  the rank modulo the visible GPUs.

Unlike the JAX ``initialize``, a group that cannot be formed raises: there
is no fall back from NCCL to gloo, or from the card to the CPU. gloo runs on
CUDA tensors only when the caller names it (two ranks sharing one card).
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import tempfile
import time
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from styletransfer_tpu_torch import constants
from styletransfer_tpu_torch.utils.logging import get_logger

# torchrun's name for each STX variable.
_TORCHRUN = {"NUM_PROCESSES": "WORLD_SIZE", "PROCESS_ID": "RANK"}


def _env(name: str) -> Optional[str]:
    value = os.environ.get(f"STX_{name}")
    if value:
        return value
    if name == "COORDINATOR_ADDRESS":
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        return f"{addr}:{port}" if addr and port else None
    return os.environ.get(_TORCHRUN.get(name, "")) or None


def is_configured() -> bool:
    """True when the environment asks for a multi-process run."""
    return bool(_env("COORDINATOR_ADDRESS") or os.environ.get("STX_DISTRIBUTED"))


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=constants.DEFAULT_DEVICE,
    backend: Optional[str] = None,
    timeout_s: Optional[float] = None,
) -> Tuple[int, int]:
    """Join the process group from the arguments or the environment and
    return ``(rank, world)``.

    Idempotent: with a group already formed it returns its rank and size,
    and with nothing asking for distribution it returns ``(0, 1)`` and forms
    no group, so trainers can call it unconditionally. On a CUDA ``device``
    the rank's GPU becomes the current device before anything touches CUDA
    (``"cuda"`` then means that GPU, for the kernels' builds and launches
    and the prefetch stream alike). The backend is NCCL on CUDA and gloo on
    the CPU; ``backend="gloo"`` on CUDA must be asked for. A group that
    cannot be formed raises (``ValueError`` for a missing or malformed
    setting, torch's error for a coordinator that does not answer within
    ``timeout_s``)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    coordinator_address = coordinator_address or _env("COORDINATOR_ADDRESS")
    if not (coordinator_address or os.environ.get("STX_DISTRIBUTED")):
        return 0, 1
    if num_processes is None and _env("NUM_PROCESSES"):
        num_processes = int(_env("NUM_PROCESSES"))
    if process_id is None and _env("PROCESS_ID"):
        process_id = int(_env("PROCESS_ID"))
    missing = [name for name, v in (("STX_COORDINATOR_ADDRESS", coordinator_address),
                                     ("STX_NUM_PROCESSES", num_processes),
                                     ("STX_PROCESS_ID", process_id)) if v is None]
    if missing:
        raise ValueError(f"a distributed run needs {', '.join(missing)} (or torchrun's "
                         "MASTER_ADDR/MASTER_PORT, WORLD_SIZE and RANK)")
    host, _, port = coordinator_address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator address must be host:port, got {coordinator_address!r}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not in [0, {num_processes})")

    dev = constants.resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    if dev.type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        index = dev.index if dev.index is not None else (
            int(local) if local else process_id % torch.cuda.device_count())
        torch.cuda.set_device(index)
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **kwargs)
    get_logger().info(
        "torch.distributed initialized: rank %d/%d on %s (%s)", dist.get_rank(),
        dist.get_world_size(),
        f"cuda:{torch.cuda.current_device()}" if dev.type == "cuda" else dev, backend)
    return dist.get_rank(), dist.get_world_size()


def shutdown() -> None:
    """Leave the process group, if one was formed."""
    global _control
    _control = None
    if dist.is_initialized():
        dist.destroy_process_group()


def process_info() -> Tuple[int, int]:
    """``(rank, world)`` of the running group; ``(0, 1)`` without one.
    Engines pass it to their loaders' ``shard_index`` / ``shard_count``."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_batch_size(global_batch_size: int) -> int:
    """This rank's slice of a global batch, which must divide evenly over
    the ranks: the mean of the ranks' batch means is the global mean only
    when every rank holds as many images."""
    count = process_info()[1]
    if global_batch_size % count:
        raise ValueError(f"global batch size {global_batch_size} must be divisible by "
                         f"the process count {count}")
    return global_batch_size // count


# The gloo group of the control collectives when the default group is NCCL.
_control: Optional[dist.ProcessGroup] = None


def _control_group() -> Optional[dist.ProcessGroup]:
    """The group of the small host collectives (lockstep, resume positions,
    the eval's mean), which run on CPU tensors: the default group under
    gloo, and under NCCL a gloo group of the same ranks. NCCL would need
    them on the GPU, and reading the result back would wait for every step
    queued before it, so the host could never run a step ahead. The group
    is made at the first control collective, which every rank reaches in
    the same order."""
    global _control
    if dist.get_backend() != "nccl":
        return None
    if _control is None:
        _control = dist.new_group(backend="gloo")
    return _control


def _all_gather_ints(values: Sequence[int]) -> np.ndarray:
    """Every rank's integer tuple, ``[world, len(values)]``."""
    local = torch.tensor(list(values), dtype=torch.int64)
    out = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(out, local, group=_control_group())
    return torch.stack(out).numpy()


def positions_agree(*values: int) -> bool:
    """True iff every rank computed the same integer tuple (trivially true
    in one process). Resume positions (epoch, iteration, batch and chunk
    offsets) must be the same on every rank: a rank that started elsewhere
    would join a different number of collectives and hang the group."""
    if not dist.is_initialized():
        return True
    gathered = _all_gather_ints(values)
    return bool((gathered == gathered[0]).all())


def agree_min(value: int) -> int:
    """The least of the ranks' values (``value`` in one process)."""
    if not dist.is_initialized():
        return int(value)
    return int(_all_gather_ints([int(value)]).min())


def agree_resume_state(state, extra_keys: Tuple[str, ...] = ("batch_in_epoch",)):
    """Check a loaded step state's resume position across the ranks.

    ``(present, epoch, iteration, *extras)`` is gathered from every rank
    (:func:`positions_agree`): if any rank loaded another position (its
    step-state file missing or stale), every rank returns ``None`` together
    and resumes at epoch level. Returns ``state`` when all agree."""
    if positions_agree(
        0 if state is None else 1,
        0 if state is None else int(state["epoch"]),
        0 if state is None else int(state["iteration"]),
        *(0 if state is None else int(state["extra"].get(k, 0)) for k in extra_keys),
    ):
        return state
    get_logger().warning(
        "Step-state resume positions differ across processes (this process: %s); "
        "ALL processes fall back to epoch-level resume.",
        "none" if state is None else f"epoch={state['epoch']} iter={state['iteration']}")
    return None


_EXHAUSTED = object()


def lockstep(iterable: Iterable):
    """Yield while every rank has an item; when any rank's source runs out,
    all stop together (the others drop their remainder).

    Each yielded item drives collectives (the train step's all-reduce, the
    eval's), and every rank must join them as often as its peers. The
    ranks' work counts are not equal by themselves: corpus shards differ by
    up to one image, and a video batch's chunks end at each rank's shortest
    local clip. One tiny all-gather per item buys the agreement; a process
    without a group iterates untouched."""
    if not dist.is_initialized():
        yield from iterable
        return
    it = iter(iterable)
    while True:
        item = next(it, _EXHAUSTED)
        have = item is not _EXHAUSTED
        if _all_gather_ints([int(have)]).min() != 1:
            if have:
                get_logger().info("lockstep: a peer process exhausted its shard; "
                                  "dropping this host's remaining items")
            return
        yield item


class _GlobalSum(torch.autograd.Function):
    """All-reduce (sum) of per-rank partial sums. The backward scales by the
    world size: every rank computes the same global value, and the ranks'
    gradients are averaged after the backward, so each rank's own share
    must count ``world`` times."""

    @staticmethod
    def forward(ctx, x, world):
        out = x.detach().clone()
        dist.all_reduce(out)
        ctx.world = world
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.world, None


class GlobalBatch:
    """A global batch split evenly over the ``world`` ranks of the default
    process group: what an objective needs to give the global batch's loss
    as the mean of the ranks' objectives, and the step's one all-reduce."""

    def __init__(self, world: int):
        self.world = world

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of ``x`` (a partial sum over this rank's
        images), the same on every rank; differentiable."""
        return _GlobalSum.apply(x, self.world)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the ranks of ``x`` (a mean over this rank's
        images): the global batch's mean."""
        return self.sum(x) / self.world

    def average(self, params: torch.nn.Module,
                metrics: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Replace every gradient of ``params`` by its mean over the ranks,
        in one all-reduce of a flat buffer that also carries ``metrics``
        (0-d tensors); returns the averaged metrics. A parameter without a
        gradient has none on every rank (the same graph) and stays so."""
        grads = [p.grad for p in params.parameters() if p.grad is not None]
        keys = list(metrics)
        flat = torch.cat([g.reshape(-1) for g in grads]
                         + [metrics[k].detach().float().reshape(1).to(grads[0].device)
                            for k in keys])
        dist.all_reduce(flat)
        flat.div_(self.world)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        return {k: flat[offset + i] for i, k in enumerate(keys)}

    def mean_float(self, value: float) -> float:
        """The mean over the ranks of a host number."""
        t = torch.tensor([value], dtype=torch.float64)
        dist.all_reduce(t, group=_control_group())
        return float(t.item()) / self.world


def global_batch() -> Optional[GlobalBatch]:
    """The :class:`GlobalBatch` of the running group (at any size: a group
    of one runs the collectives too), or None without a group, where the
    trainers run their single-process code exactly."""
    return GlobalBatch(dist.get_world_size()) if dist.is_initialized() else None


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local(cmd: Sequence[str], world: int, timeout_s: float,
                 env: Optional[Mapping[str, str]] = None,
                 cwd: Optional[str] = None) -> List[Tuple[int, str]]:
    """Run ``cmd`` as ``world`` ranks on this host (``STX_COORDINATOR_ADDRESS``
    on a free localhost port, ``STX_NUM_PROCESSES``, ``STX_PROCESS_ID``) and
    return each rank's ``(exit code, output)``.

    A group whose rank fails leaves its peers blocked in a collective, so
    the first failure kills the others; so does ``timeout_s`` (then
    ``TimeoutError``, with every rank's output). Every process started here
    has ended when this returns."""
    base = dict(os.environ if env is None else env)
    base.update(STX_COORDINATOR_ADDRESS=f"127.0.0.1:{free_port()}",
                STX_NUM_PROCESSES=str(world))
    procs, logs = [], []
    try:
        for rank in range(world):
            log = tempfile.TemporaryFile()
            logs.append(log)
            procs.append(subprocess.Popen(list(cmd), cwd=cwd, stdout=log,
                                          stderr=subprocess.STDOUT,
                                          env={**base, "STX_PROCESS_ID": str(rank)}))
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        timed_out = any(p.poll() is None for p in procs) and time.monotonic() > deadline
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outputs = []
    for p, log in zip(procs, logs):
        log.seek(0)
        outputs.append((p.returncode, log.read().decode(errors="replace")))
        log.close()
    if timed_out:
        raise TimeoutError(f"{world} ranks of {' '.join(cmd)} did not end within "
                           f"{timeout_s:.0f} s:\n" + "\n".join(
                               f"--- rank {r} ---\n{out[-4000:]}"
                               for r, (_, out) in enumerate(outputs)))
    return outputs
