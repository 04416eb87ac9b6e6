"""Orbax checkpoints (``STX_CKPT_BACKEND=orbax``), read and written without
JAX, orbax or tensorstore.

An ``.orbax`` epoch is the directory that orbax's ``StandardCheckpointer``
writes: ``_CHECKPOINT_METADATA`` and ``_METADATA`` (JSON), and an OCDBT
key-value database (``manifest.ocdbt``, B-tree nodes and data files under
``d/``, and under ``ocdbt.process_<i>/d/`` for the per-process databases that
the root refers into). Each array is a zarr v2 array under its dotted
parameter path: ``<path>/.zarray`` (JSON) and its chunks (``<path>/0.0.0.0``,
``<path>/0`` for a 1-D or 0-D array), each chunk zstd-compressed or raw.

OCDBT files (the manifest and every B-tree node) share one envelope: a
big-endian u32 magic (``0x0cdb3a2a`` manifest, ``0x0cdb20de`` node), the
file's length as a u64 LE, varints for the format version (0) and the
compression (0 none, 1 zstd), the body, and a u32 LE CRC-32C of everything
before it. Bodies are varints in columns: a data-file table of
prefix-compressed relative paths, then the manifest's configuration and
version list (the newest generation names the root node as data file,
offset and length), or a node's entries (keys prefix-compressed against the
previous key; an interior node's children each drop their common key
prefix; a leaf's values inline or at an offset in a data file).

:func:`load` returns nested dicts of numpy arrays, rebuilt from
``_METADATA``'s key paths, as ``ckpt.load`` returns a ``.msgpack`` tree.
:func:`save` writes the simplest layout that orbax restores: one
uncompressed leaf node and one data file in the root database, and zarr
chunks without a compressor. Only float32 arrays, the dtype of every epoch
tree, are read or written; any other dtype raises, naming it.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import threading
import time
import uuid
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from styletransfer_tpu_torch import native

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MANIFEST_NAME = "manifest.ocdbt"
METADATA_NAME = "_METADATA"
CHECKPOINT_METADATA_NAME = "_CHECKPOINT_METADATA"
HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
DICT_KEY = 2  # orbax key_type of a mapping key
DTYPE = "<f4"


class _Body:
    """A cursor over one decoded body; every read is bounds-checked and a
    short read raises ValueError naming the file."""

    def __init__(self, data: bytes, name: str):
        self.data, self.name, self.pos = data, name, 0

    def _need(self, n: int) -> None:
        if n < 0 or self.pos + n > len(self.data):
            raise ValueError(f"{self.name}: truncated at byte {self.pos} of {len(self.data)}")

    def byte(self) -> int:
        self._need(1)
        self.pos += 1
        return self.data[self.pos - 1]

    def take(self, n: int) -> bytes:
        self._need(n)
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.name}: varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def done(self) -> None:
        if self.pos != len(self.data):
            raise ValueError(f"{self.name}: {len(self.data) - self.pos} bytes after the last field")


def _unwrap(raw: bytes, magic: int, name: str) -> _Body:
    """The body of an OCDBT manifest or node file, after its magic, length,
    version and CRC-32C are checked."""
    if len(raw) < 18:
        raise ValueError(f"{name}: {len(raw)} bytes, too short for an OCDBT file")
    got_magic, length = struct.unpack(">I", raw[:4])[0], struct.unpack("<Q", raw[4:12])[0]
    if got_magic != magic:
        raise ValueError(f"{name}: magic 0x{got_magic:08x}, expected 0x{magic:08x}")
    if length != len(raw):
        raise ValueError(f"{name}: header says {length} bytes, the file holds {len(raw)}")
    stored = struct.unpack("<I", raw[-4:])[0]
    computed = native.crc32c(raw[:-4])
    if stored != computed:
        raise ValueError(f"{name}: CRC-32C mismatch (stored 0x{stored:08x}, "
                         f"computed 0x{computed:08x})")
    head = _Body(raw[:-4], name)
    head.pos = 12
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise ValueError(f"{name}: OCDBT format version {version}, only 0 is known")
    body = raw[head.pos:-4]
    if compression == 1:
        try:
            body = native.zstd_decompress(body)
        except ValueError as exc:
            raise ValueError(f"{name}: {exc}") from None
    elif compression != 0:
        raise ValueError(f"{name}: unknown compression {compression}")
    return _Body(body, name)


def _wrap(magic: int, body: bytes) -> bytes:
    """An uncompressed OCDBT file around ``body``."""
    length = 4 + 8 + 2 + len(body) + 4
    head = struct.pack(">I", magic) + struct.pack("<Q", length) + bytes([0, 0])
    return head + body + struct.pack("<I", native.crc32c(head + body))


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(values: Sequence[int]) -> bytes:
    return b"".join(_varint(v) for v in values)


def _read_lengths(b: _Body, n: int) -> Tuple[List[int], List[int]]:
    """The lengths of ``n`` prefix-compressed strings: the bytes each shares
    with the one before (none for the first), and the bytes it adds."""
    return b.varints(max(n - 1, 0)), b.varints(n)


def _join(b: _Body, prefix: List[int], suffix: List[int]) -> List[bytes]:
    """The strings whose lengths :func:`_read_lengths` read, from their
    added bytes, which follow in the body."""
    out, prev = [], b""
    for i, s in enumerate(suffix):
        keep = prefix[i - 1] if i else 0
        if keep > len(prev):
            raise ValueError(f"{b.name}: string {i} shares {keep} bytes with a shorter one")
        prev = prev[:keep] + b.take(s)
        out.append(prev)
    return out


def _prefixed(items: Sequence[bytes]) -> Tuple[bytes, bytes, bytes]:
    """``items`` prefix-compressed: the shared lengths, the added lengths
    and the added bytes, each encoded."""
    prefix = [len(os.path.commonprefix([items[i - 1], items[i]])) for i in range(1, len(items))]
    keep = [0] + prefix
    return (_varints(prefix), _varints([len(x) - k for x, k in zip(items, keep)]),
            b"".join(x[k:] for x, k in zip(items, keep)))


def _read_table(b: _Body) -> List[str]:
    """A data-file table: paths prefix-compressed against the one before,
    each with the length of its base path; base and relative path together
    are the path under the database root."""
    n = b.varint()
    prefix, suffix = _read_lengths(b, n)
    b.varints(n)  # base path lengths
    return [p.decode() for p in _join(b, prefix, suffix)]


def _table(paths: Sequence[str]) -> bytes:
    prefix, suffix, tail = _prefixed([p.encode() for p in paths])
    return _varint(len(paths)) + prefix + suffix + _varints([0] * len(paths)) + tail


class _Files:
    """Data files of one database, each read once."""

    def __init__(self, root: str):
        self.root, self._cache = root, {}

    def read(self, rel: str, offset: int, length: int) -> bytes:
        if rel not in self._cache:
            path = os.path.normpath(os.path.join(self.root, rel))
            if os.path.commonpath([path, self.root]) != self.root:
                raise ValueError(f"data file {rel!r} lies outside {self.root}")
            with open(path, "rb") as f:
                self._cache[rel] = f.read()
        data = self._cache[rel]
        if offset + length > len(data):
            raise ValueError(f"{rel}: bytes {offset}..{offset + length} past its end ({len(data)})")
        return data[offset:offset + length]


def _latest_root(root: str) -> Tuple[List[str], int, int, int, int]:
    """``(data files, height, file id, offset, length)`` of the newest
    generation's root node, from the manifest."""
    name = MANIFEST_NAME
    with open(os.path.join(root, name), "rb") as f:
        b = _unwrap(f.read(), MANIFEST_MAGIC, name)
    b.take(16)  # database uuid
    kind = b.varint()
    if kind != 0:
        raise ValueError(f"{name}: manifest kind {kind}; only single-file manifests are read")
    b.varint()  # max_inline_value_bytes
    b.varint()  # max_decoded_node_bytes
    b.byte()  # version_tree_arity_log2
    compression = b.varint()
    if compression == 1:
        b.take(4)  # zstd level, int32 LE
    elif compression != 0:
        raise ValueError(f"{name}: unknown compression {compression}")
    files = _read_table(b)
    n = b.varint()
    if n == 0:
        raise ValueError(f"{name}: the database has no version")
    gen, height, fid, offset, length = (b.varints(n) for _ in range(5))
    for _ in range(3):  # num_keys, num_tree_bytes, num_indirect_value_bytes
        b.varints(n)
    for _ in range(n):  # commit times
        b.u64()
    # Older generations follow in version-tree nodes; the newest is inline.
    latest = max(range(n), key=gen.__getitem__)
    if fid[latest] >= len(files):
        raise ValueError(f"{name}: root node in data file {fid[latest]} of {len(files)}")
    return files, height[latest], fid[latest], offset[latest], length[latest]


def _walk(files: _Files, table: List[str], fid: int, offset: int, length: int, height: int,
          prefix: bytes, out: Dict[bytes, bytes]) -> None:
    if fid >= len(table):
        raise ValueError(f"a node refers to data file {fid} of {len(table)}")
    name = f"{table[fid]}@{offset}"
    b = _unwrap(files.read(table[fid], offset, length), NODE_MAGIC, name)
    got = b.byte()
    if got != height:
        raise ValueError(f"{name}: node of height {got} where {height} was expected")
    node_table = _read_table(b)
    n = b.varint()
    key_prefix, key_suffix = _read_lengths(b, n)
    if height == 0:
        keys = _join(b, key_prefix, key_suffix)
        lengths, kinds = b.varints(n), b.varints(n)
        if any(k not in (0, 1) for k in kinds):
            raise ValueError(f"{name}: unknown value kind")
        indirect = sum(kinds)
        ids, offsets = b.varints(indirect), b.varints(indirect)
        j = 0
        for key, size, kind in zip(keys, lengths, kinds):
            if kind == 0:
                out[prefix + key] = b.take(size)
                continue
            if ids[j] >= len(node_table):
                raise ValueError(f"{name}: value in data file {ids[j]} of {len(node_table)}")
            out[prefix + key] = files.read(node_table[ids[j]], offsets[j], size)
            j += 1
    else:
        common = b.varints(n)
        keys = _join(b, key_prefix, key_suffix)
        ids, offsets, lengths = b.varints(n), b.varints(n), b.varints(n)
        for _ in range(3):  # num_keys, num_tree_bytes, num_indirect_value_bytes
            b.varints(n)
        b.done()
        for key, keep, i, off, size in zip(keys, common, ids, offsets, lengths):
            if keep > len(key):
                raise ValueError(f"{name}: common prefix longer than its key")
            _walk(files, node_table, i, off, size, height - 1, prefix + key[:keep], out)
        return
    b.done()


def read_kvstore(root: str) -> Dict[bytes, bytes]:
    """Every key of the OCDBT database at ``root`` (newest generation) and
    its value, in key order."""
    root = os.path.abspath(root)
    table, height, fid, offset, length = _latest_root(root)
    out: Dict[bytes, bytes] = {}
    _walk(_Files(root), table, fid, offset, length, height, b"", out)
    return dict(sorted(out.items()))


def _decode_array(name: str, kv: Mapping[bytes, bytes]) -> np.ndarray:
    meta_key = f"{name}/.zarray".encode()
    if meta_key not in kv:
        raise ValueError(f"{name}: no .zarray in the checkpoint")
    meta = json.loads(kv[meta_key])
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr format {meta.get('zarr_format')}, only 2 is read")
    if meta.get("dtype") != DTYPE:
        raise ValueError(f"{name}: dtype {meta.get('dtype')!r}; epoch checkpoints hold "
                         f"float32 ({DTYPE!r}) only")
    if meta.get("order", "C") != "C" or meta.get("filters"):
        raise ValueError(f"{name}: only C-order arrays without filters are read")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {compressor.get('id')!r}; zstd or none is read")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if chunks != shape:  # orbax writes each array as one chunk
        raise ValueError(f"{name}: chunks {list(chunks)} of shape {list(shape)}; only "
                         "arrays of one chunk are read")
    key = f"{name}/{meta.get('dimension_separator', '.').join('0' for _ in shape) or '0'}"
    if key.encode() not in kv:
        raise ValueError(f"{name}: chunk {key} missing")
    data = kv[key.encode()]
    if compressor is not None:
        try:
            data = native.zstd_decompress(data)
        except ValueError as exc:
            raise ValueError(f"{key}: {exc}") from None
    dtype = np.dtype(DTYPE)
    want = int(np.prod(shape)) * dtype.itemsize
    if len(data) != want:
        raise ValueError(f"{key}: {len(data)} bytes, the array holds {want}")
    return np.frombuffer(data, dtype).reshape(shape)


def _tree_paths(metadata: Mapping[str, Any], name: str) -> List[Tuple[str, ...]]:
    paths = []
    for entry in metadata.get("tree_metadata", {}).values():
        keys = []
        for k in entry["key_metadata"]:
            if k.get("key_type") != DICT_KEY:
                raise ValueError(f"{name}: key {k.get('key')!r} of type {k.get('key_type')}; "
                                 "only mapping keys are read")
            keys.append(str(k["key"]))
        paths.append(tuple(keys))
    return paths


def load(path: str) -> Dict[str, Any]:
    """The parameter tree of the ``.orbax`` checkpoint at ``path``: nested
    dicts of float32 numpy arrays, keyed as ``_METADATA`` says."""
    with open(os.path.join(path, METADATA_NAME)) as f:
        metadata = json.load(f)
    kv = read_kvstore(path)
    tree: Dict[str, Any] = {}
    for keys in _tree_paths(metadata, os.path.join(path, METADATA_NAME)):
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = _decode_array(".".join(keys), kv)
    return tree


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k in sorted(tree, key=str):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _as_array(keys: Tuple[str, ...], value: Any) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    arr = np.asarray(value)
    if arr.dtype != np.float32:
        raise ValueError(f"{'.'.join(keys)}: dtype {arr.dtype}; .orbax epoch checkpoints "
                         "hold float32 only")
    return arr  # tobytes("C") orders it; ascontiguousarray would make a 0-D array 1-D


def _zarray(shape: Tuple[int, ...]) -> bytes:
    meta = {"chunks": list(shape), "compressor": None, "dimension_separator": ".",
            "dtype": DTYPE, "fill_value": None, "filters": None, "order": "C",
            "shape": list(shape), "zarr_format": 2}
    return json.dumps(meta, separators=(",", ":"), sort_keys=True).encode()


def _leaf_node(entries: Sequence[Tuple[bytes, bytes]], data_file: str) -> Tuple[bytes, bytes, int]:
    """``(data file bytes, node bytes, indirect bytes)``: values over the
    inline limit go to the data file, in key order, and the node follows
    them there."""
    prefix, suffix, tail = _prefixed([k for k, _ in entries])
    kinds = [int(len(v) > MAX_INLINE_VALUE_BYTES) for _, v in entries]
    data, offsets = bytearray(), []
    for (_, v), kind in zip(entries, kinds):
        if kind:
            offsets.append(len(data))
            data += v
    body = (bytes([0]) + _table([data_file] if offsets else []) + _varint(len(entries))
            + prefix + suffix + tail
            + _varints([len(v) for _, v in entries]) + _varints(kinds)
            + _varints([0] * len(offsets)) + _varints(offsets)
            + b"".join(v for (_, v), kind in zip(entries, kinds) if not kind))
    if len(body) > MAX_DECODED_NODE_BYTES:
        raise ValueError(f"the checkpoint's node would hold {len(body)} bytes, above "
                         f"{MAX_DECODED_NODE_BYTES}")
    return bytes(data), _wrap(NODE_MAGIC, body), len(data)


def _manifest(data_file: str, node_offset: int, node_length: int, num_keys: int,
              indirect: int, commit_ns: int) -> bytes:
    body = (uuid.uuid4().bytes + _varint(0) + _varint(MAX_INLINE_VALUE_BYTES)
            + _varint(MAX_DECODED_NODE_BYTES) + bytes([VERSION_TREE_ARITY_LOG2]) + _varint(0)
            + _table([data_file])
            + _varint(1)  # one version: generation 1
            + _varints([1, 0, 0, node_offset, node_length, num_keys, node_length, indirect])
            + struct.pack("<Q", commit_ns)
            + _varint(0))  # no version-tree nodes
    return _wrap(MANIFEST_MAGIC, body)


def save(tree: Mapping[str, Any], path: str) -> None:
    """Write ``tree`` (nested mappings of float32 arrays or tensors) as an
    ``.orbax`` checkpoint directory at ``path``, replacing one that exists.
    It is built in a temporary directory beside ``path`` and renamed into
    place; a failed write leaves no temporary directory behind. Replacing
    an existing epoch takes two renames (the old directory aside, the new
    one in), so a concurrent reader (a daemon's RELOAD, ``find_latest``)
    may find the path missing between them, as under orbax's ``force=True``;
    a ``.msgpack`` epoch is replaced by one atomic rename."""
    start_ns = time.time_ns()
    leaves = [(keys, _as_array(keys, v)) for keys, v in _leaves(tree)]
    entries: List[Tuple[bytes, bytes]] = []
    tree_metadata = {}
    for keys, arr in leaves:
        name = ".".join(keys)
        entries.append((f"{name}/.zarray".encode(), _zarray(arr.shape)))
        chunk = ".".join("0" for _ in arr.shape) or "0"
        entries.append((f"{name}/{chunk}".encode(), arr.astype("<f4", copy=False).tobytes("C")))
        tree_metadata[repr(keys)] = {
            "key_metadata": [{"key": k, "key_type": DICT_KEY} for k in keys],
            "value_metadata": {"value_type": "np.ndarray", "skip_deserialize": False}}
    entries.sort()
    data_file = f"d/{uuid.uuid4().hex}"
    data, node, indirect = _leaf_node(entries, data_file)
    metadata = {"tree_metadata": tree_metadata, "use_ocdbt": True, "use_zarr3": False,
                "store_array_data_equal_to_fill_value": True, "custom_metadata": None}

    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    suffix = f"{os.getpid()}.{threading.get_native_id()}"
    tmp, old = f"{path}.tmp.{suffix}", f"{path}.old.{suffix}"
    moved = False
    try:
        os.makedirs(os.path.join(tmp, "d"))
        with open(os.path.join(tmp, data_file), "wb") as f:
            f.write(data + node)
        commit_ns = time.time_ns()
        with open(os.path.join(tmp, MANIFEST_NAME), "wb") as f:
            f.write(_manifest(data_file, len(data), len(node), len(entries), indirect, commit_ns))
        with open(os.path.join(tmp, METADATA_NAME), "w") as f:
            json.dump(metadata, f)
        with open(os.path.join(tmp, CHECKPOINT_METADATA_NAME), "w") as f:
            json.dump({"item_handlers": HANDLER, "metrics": {}, "performance_metrics": {},
                       "init_timestamp_nsecs": start_ns, "commit_timestamp_nsecs": commit_ns,
                       "custom_metadata": {}}, f)
        if os.path.lexists(path):
            os.rename(path, old)
            moved = True
        os.rename(tmp, path)
    except BaseException:
        if moved and not os.path.lexists(path):
            os.rename(old, path)  # the epoch that was there stays
        raise
    finally:
        # Whatever failed, no temporary directory stays behind; the error
        # still reaches the caller.
        for leftover in (tmp, old):
            if os.path.isdir(leftover) and not os.path.islink(leftover):
                shutil.rmtree(leftover, ignore_errors=True)
            elif os.path.lexists(leftover):
                os.remove(leftover)
