"""Checkpoint save / load, with the JAX package's file format and naming.

The port of what fast_st training and inference need from
``styletransfer_tpu/ckpt.py``: per-epoch files
``{model}_{style}_epoch{e}.msgpack`` under ``data/models/`` with the
epoch-skip resume checks, "latest" discovery sorted numerically by epoch,
mid-epoch step states (params, Adam state, position) for exact resume, and
the flax ``.msgpack`` format, read and written with ``msgpack`` alone so that
one trained model, and one step state, runs in both packages.

A step state keeps the optimizer as optax Adam's state tree
(``{"0": {"count", "mu", "nu"}, "1": {}}``, the moments shaped like the
parameter tree); :func:`adam_state_to_tree` and :func:`adam_state_from_tree`
convert to and from ``torch.optim.Adam`` (``step``, ``exp_avg``,
``exp_avg_sq``), whose update is optax's arithmetically.

The flax format is a msgpack map of nested string-keyed maps whose array
leaves are ExtType code 1 holding ``msgpack((shape, dtype name, raw C-order
bytes))`` (code 3 is a numpy scalar in the same encoding).

``STX_CKPT_BACKEND`` (``msgpack``, the default, or ``orbax``; any other value
raises ValueError) names the format of new epoch checkpoints, as in the JAX
package: under ``orbax`` they are Orbax OCDBT directories
(``..._epoch{e}.orbax/``), read and written by :mod:`ckpt_orbax` without JAX,
so either package serves or resumes the other's epochs. :func:`save` and
:func:`load` pick the format by suffix; :func:`existing_checkpoint_path`
prefers the active backend's format when an epoch exists in both, and
:func:`find_latest` prefers ``.msgpack``, then ``.orbax``, then a reference
``.pth`` at equal epochs. Step states and carry sidecars stay ``.msgpack``
under either backend. A ``.pth`` (a state dict that the original reference
wrote with ``torch.save``) loads through
``transformer.import_torch_state_dict``.

A distributed video run keeps each rank's recurrent carry (its local batch
rows) in a sidecar per rank, ``{model}_{style}_step_carry_p{rank}of{world}``
(:func:`save_carry_shards`), stamped with the step state's iteration.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from styletransfer_tpu_torch import constants
from styletransfer_tpu_torch.utils.logging import get_logger

_EPOCH_RE = re.compile(r"epoch(\d+)")

CKPT_SUFFIX = ".msgpack"
ORBAX_SUFFIX = ".orbax"

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _ckpt_backend() -> str:
    backend = os.environ.get("STX_CKPT_BACKEND", "msgpack")
    if backend not in ("msgpack", "orbax"):
        raise ValueError(f"STX_CKPT_BACKEND must be 'msgpack' or 'orbax', got {backend!r}")
    return backend


def _models_dir(models_path: Optional[str] = None) -> str:
    path = models_path or constants.MODELS_PATH
    if not os.path.isabs(path):
        path = os.path.join(constants.PROJECT_ROOT_PATH, path)
    return path


def checkpoint_path(
    model_name: str, style_name: str, epoch: int, models_path: Optional[str] = None
) -> str:
    """``data/models/{model}_{style}_epoch{e}.msgpack``; ``.orbax`` under
    ``STX_CKPT_BACKEND=orbax``."""
    suffix = ORBAX_SUFFIX if _ckpt_backend() == "orbax" else CKPT_SUFFIX
    return os.path.join(
        _models_dir(models_path), f"{model_name}_{style_name}_epoch{epoch}{suffix}"
    )


def save_epoch(
    params: Any,
    model_name: str,
    style_name: str,
    epoch: int,
    models_path: Optional[str] = None,
) -> str:
    path = checkpoint_path(model_name, style_name, epoch, models_path)
    save(params, path)
    return path


def existing_checkpoint_path(
    model_name: str, style_name: str, epoch: int, models_path: Optional[str] = None
) -> Optional[str]:
    """The epoch's checkpoint in whichever format exists (the active
    backend's first), or None. A resume loads through this: after a switch
    of ``STX_CKPT_BACKEND`` the epoch the other backend wrote still counts."""
    base = os.path.join(_models_dir(models_path), f"{model_name}_{style_name}_epoch{epoch}")
    candidates = [(base + CKPT_SUFFIX, os.path.isfile), (base + ORBAX_SUFFIX, os.path.isdir)]
    if _ckpt_backend() == "orbax":
        candidates.reverse()
    return next((path for path, exists in candidates if exists(path)), None)


def epoch_checkpoint_exists(
    model_name: str, style_name: str, epoch: int, models_path: Optional[str] = None
) -> bool:
    """Resume-skip check: an epoch saved in either format counts."""
    return existing_checkpoint_path(model_name, style_name, epoch, models_path) is not None


def _array_from_ext(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    name = dtype_name.decode()
    if name == "bfloat16":
        # numpy has no bfloat16: widen exactly to float32.
        bits = torch.frombuffer(bytearray(buffer), dtype=torch.bfloat16)
        return bits.float().numpy().reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape)


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code == _EXT_NDARRAY:
        return _array_from_ext(data)
    if code == _EXT_NPSCALAR:
        return _array_from_ext(data)[()]
    return msgpack.ExtType(code, data)


def _ext_default(obj):
    import msgpack

    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        payload = msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")),
                                use_bin_type=True)
        code = _EXT_NDARRAY if isinstance(obj, np.ndarray) else _EXT_NPSCALAR
        return msgpack.ExtType(code, payload)
    raise TypeError(f"cannot serialize {type(obj).__name__}")


def _as_tree(params: Any) -> Any:
    if isinstance(params, nn.Module):
        from styletransfer_tpu_torch.models import transformer

        return transformer.params_to_tree(params)
    if isinstance(params, Mapping):
        return {str(k): _as_tree(v) for k, v in params.items()}
    return params


def save(params: Any, path: str) -> None:
    """Write ``params`` (an ``nn.Module`` or a nested mapping of arrays /
    tensors) as a flax-format ``.msgpack`` file, or as an Orbax directory
    when ``path`` ends in ``.orbax``; atomically either way: written under
    a temporary name, renamed into place, and removed if the write fails."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(ORBAX_SUFFIX):
        from styletransfer_tpu_torch import ckpt_orbax

        ckpt_orbax.save(_as_tree(params), path)
        return
    import msgpack

    data = msgpack.packb(_as_tree(params), default=_ext_default, strict_types=True)
    # pid and thread id: two writers of one path never share a temp file.
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_native_id()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    finally:
        # A failed write or rename leaves no temporary file behind (the JAX
        # ``_atomic_write`` does); the error still reaches the caller.
        if os.path.exists(tmp):
            os.remove(tmp)


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Read a torch ``.pth`` state dict into numpy arrays (CPU)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def load(path: str) -> Dict[str, Any]:
    """Read a ``.msgpack`` checkpoint, an ``.orbax`` directory, or a
    reference ``.pth`` state dict of the transform net, into nested dicts of
    numpy arrays (the JAX parameter tree's layout)."""
    if path.endswith(".pth"):
        from styletransfer_tpu_torch.models import transformer

        return transformer.import_torch_state_dict(load_torch_state_dict(path))
    if path.endswith(ORBAX_SUFFIX):
        from styletransfer_tpu_torch import ckpt_orbax

        return ckpt_orbax.load(path)
    import msgpack

    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)


def _epoch_of(filename: str) -> int:
    m = _EPOCH_RE.search(filename)
    return int(m.group(1)) if m else -1


def find_latest(
    model_name: str, style_name: str, models_path: Optional[str] = None
) -> Tuple[str, int]:
    """Find the newest checkpoint for (model, style): names that start with
    the model and hold the style after it, sorted numerically by epoch, the
    native formats first among equal epochs. Returns ``(path, epoch)``;
    raises ``FileNotFoundError`` if there is none."""
    directory = _models_dir(models_path)
    try:
        names = [
            x
            for x in os.listdir(directory)
            if x.startswith(model_name)
            and style_name in os.path.splitext(x)[0][len(model_name):]
            and (x.endswith(CKPT_SUFFIX) or x.endswith(".pth")
                 or (x.endswith(ORBAX_SUFFIX)
                     and os.path.isdir(os.path.join(directory, x))))
            and "_step_state" not in x
            and "_step_carry_" not in x
        ]
    except FileNotFoundError:
        names = []
    if not names:
        get_logger().critical(
            "There are no weights for the specified model name (%s) and style "
            "(%s). In the specified path: %s",
            model_name, style_name, directory,
        )
        raise FileNotFoundError(
            f"No weights for model {model_name!r} and style {style_name!r} in {directory}"
        )
    names.sort(key=lambda n: (_epoch_of(n), n.endswith(CKPT_SUFFIX),
                              n.endswith(ORBAX_SUFFIX)))
    chosen = names[-1]
    return os.path.join(directory, chosen), _epoch_of(chosen)


def load_latest_transformer(
    model_name: str,
    style_name: str,
    models_path: Optional[str] = None,
    device=constants.DEFAULT_DEVICE,
    template: Optional[Any] = None,
):
    """Load the latest transform-net weights for (model, style) onto
    ``device``, from a ``.msgpack``, an ``.orbax`` or a reference ``.pth``. Returns
    ``(TransformerNet, epoch)``. With a ``template`` (a TransformerNet, e.g.
    a multi-style one with [S, C] affines) the checkpoint must hold its
    parameter names and shapes, else ValueError."""
    from styletransfer_tpu_torch.models import transformer

    path, epoch = find_latest(model_name, style_name, models_path)
    params = transformer.params_from_jax(load(path), device=device)
    if template is not None:
        want = {k: tuple(v.shape) for k, v in template.state_dict().items()}
        got = {k: tuple(v.shape) for k, v in params.state_dict().items()}
        if got != want:
            diff = sorted(k for k in want.keys() | got.keys() if want.get(k) != got.get(k))
            raise ValueError(f"{path} does not match the template at {diff[0]}: "
                             f"{got.get(diff[0])} in the file, {want.get(diff[0])} wanted")
    get_logger().info("Loaded %s (epoch %d)", path, epoch)
    return params, epoch


def step_state_path(model_name: str, style_name: str,
                    models_path: Optional[str] = None) -> str:
    return os.path.join(
        _models_dir(models_path), f"{model_name}_{style_name}_step_state{CKPT_SUFFIX}"
    )


def save_step_state(
    params: Any,
    opt_state: Mapping[str, Any],
    epoch: int,
    iteration: int,
    model_name: str,
    style_name: str,
    models_path: Optional[str] = None,
    extra: Optional[Dict[str, int]] = None,
    arrays: Optional[Mapping[str, Any]] = None,
) -> str:
    """Atomically save mid-training state: ``params`` (module or tree),
    ``opt_state`` (an optax-layout tree, :func:`adam_state_to_tree`), the
    position, ``extra`` integer run flags (e.g. ``batch_in_epoch``) and
    ``arrays`` (e.g. the video trainer's recurrent carry frames; tensors or
    numpy arrays). The layout is the JAX package's, so either package
    resumes it."""
    state = {
        "params": _as_tree(params),
        "opt_state": opt_state,
        "epoch": np.int64(epoch),
        "iteration": np.int64(iteration),
        "extra": {k: np.int64(v) for k, v in (extra or {}).items()},
        "arrays": dict(arrays or {}),
    }
    path = step_state_path(model_name, style_name, models_path)
    save(state, path)
    return path


def load_step_state(
    model_name: str,
    style_name: str,
    models_path: Optional[str] = None,
    extra_keys: Tuple[str, ...] = (),
    array_keys: Tuple[str, ...] = (),
) -> Optional[Dict[str, Any]]:
    """The saved step state, or None when there is none.

    Returns ``{"params", "opt_state"}`` as trees of numpy arrays, ``epoch``
    and ``iteration`` as ints, ``extra`` with every key of ``extra_keys``
    (0 where the file lacks it: a state written before the key existed) and
    ``arrays``: the stored entries named in ``array_keys`` (empty ones
    dropped; {} for a state that predates the field)."""
    path = step_state_path(model_name, style_name, models_path)
    if not os.path.isfile(path):
        return None
    raw = load(path)
    state = {
        "params": raw["params"],
        "opt_state": raw["opt_state"],
        "epoch": int(raw["epoch"]),
        "iteration": int(raw["iteration"]),
        "extra": {**{k: 0 for k in extra_keys},
                  **{k: int(v) for k, v in raw.get("extra", {}).items()}},
        "arrays": {k: v for k, v in raw.get("arrays", {}).items()
                   if k in array_keys and np.size(v)},
    }
    get_logger().info("Restored step state from %s (epoch %d, iteration %d)",
                      path, state["epoch"], state["iteration"])
    return state


def carry_shard_path(model_name: str, style_name: str,
                     models_path: Optional[str] = None) -> str:
    """This rank's carry sidecar; the name holds the rank and the world
    size, so a restart with another world size never reads a mismatched
    shard."""
    from styletransfer_tpu_torch.parallel import distributed

    rank, world = distributed.process_info()
    return os.path.join(_models_dir(models_path),
                        f"{model_name}_{style_name}_step_carry_p{rank}of{world}{CKPT_SUFFIX}")


def save_carry_shards(arrays: Mapping[str, Any], iteration: int, model_name: str,
                      style_name: str, models_path: Optional[str] = None) -> str:
    """Save this rank's carry ``arrays`` (its local batch rows; tensors or
    numpy arrays), stamped with ``iteration`` so that a resume can tell a
    sidecar older than the step state (a stop between the two writes).
    Atomic, like every save."""
    state = {"iteration": np.int64(iteration),
             "arrays": {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                        else np.asarray(v) for k, v in arrays.items()}}
    path = carry_shard_path(model_name, style_name, models_path)
    save(state, path)
    return path


def load_carry_shards(iteration: int, model_name: str, style_name: str,
                      models_path: Optional[str] = None,
                      array_keys: Tuple[str, ...] = ()) -> Optional[Dict[str, np.ndarray]]:
    """This rank's carry arrays, or None when the sidecar is absent,
    unreadable, stamped with another iteration or missing a key of
    ``array_keys``: the caller then resumes from the start of the video
    batch (with every rank, see ``engines/video.py``)."""
    path = carry_shard_path(model_name, style_name, models_path)
    if not os.path.isfile(path):
        return None
    try:
        state = load(path)
        stamp, arrays = int(state["iteration"]), state["arrays"]
    except Exception:  # noqa: BLE001 - an unreadable sidecar means batch-level resume
        return None
    if stamp != int(iteration):
        get_logger().warning(
            "Carry sidecar %s is at iteration %d but the step state is at %d; ignoring it "
            "(batch-level resume).", path, stamp, int(iteration))
        return None
    if any(np.size(arrays.get(k, ())) == 0 for k in array_keys):
        return None
    return arrays


def _tree_get(tree: Mapping[str, Any], path: Sequence[str]) -> Any:
    for part in path:
        tree = tree[part]
    return tree


def _tree_set(tree: Dict[str, Any], path: Sequence[str], value: Any) -> None:
    for part in path[:-1]:
        tree = tree.setdefault(part, {})
    tree[path[-1]] = value


def adam_state_to_tree(params: nn.Module, optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """``optimizer``'s Adam state as optax ``adam``'s state tree:
    ``{"0": {"count": int32, "mu": tree, "nu": tree}, "1": {}}``, the moments
    keyed like ``params``' tree. Parameters without state yet (no step taken)
    get zero moments and count 0."""
    mu: Dict[str, Any] = {}
    nu: Dict[str, Any] = {}
    count = 0
    for name, p in params.named_parameters():
        st = optimizer.state.get(p, {})
        path = name.split(".")
        zeros = np.zeros(tuple(p.shape), np.float32)
        if st:
            count = int(st["step"])
            _tree_set(mu, path, st["exp_avg"].detach().cpu().float().numpy())
            _tree_set(nu, path, st["exp_avg_sq"].detach().cpu().float().numpy())
        else:
            _tree_set(mu, path, zeros)
            _tree_set(nu, path, zeros)
    return {"0": {"count": np.asarray(count, np.int32), "mu": mu, "nu": nu}, "1": {}}


def adam_state_from_tree(
    params: nn.Module, optimizer: torch.optim.Optimizer, tree: Mapping[str, Any]
) -> None:
    """Load an optax Adam state tree (as :func:`adam_state_to_tree` writes
    it, or the JAX package's trainer saves it) into ``optimizer``, whose
    parameters are ``params``'."""
    adam = tree["0"]
    count = int(np.asarray(adam["count"]))
    for name, p in params.named_parameters():
        path = name.split(".")
        if count == 0:
            optimizer.state.pop(p, None)
            continue

        def moment(key):
            arr = np.asarray(_tree_get(adam[key], path), np.float32)
            if arr.shape != tuple(p.shape):
                raise ValueError(f"{key} of {name} has shape {arr.shape}, want {tuple(p.shape)}")
            return torch.from_numpy(arr.copy()).to(device=p.device, dtype=p.dtype)

        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": moment("mu"),
            "exp_avg_sq": moment("nu"),
        }
