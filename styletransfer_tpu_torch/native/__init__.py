"""Native (C) host helpers, built at first use.

The port of ``styletransfer_tpu/native``, with its own copy of the C source
(``crc32c.c``), and a Zstandard decoder (``zstd.c``) for the chunks and
B-tree nodes of ``.orbax`` checkpoints (``ckpt_orbax.py``). Each library is
compiled with the system C compiler (``cc``,
``gcc`` or ``clang``) into ``build/native/`` beside the package (listed in
``.gitignore``), named by a hash of its source as ``ops/cuda/_build.py``
names the kernels, so an edited source is rebuilt and an unchanged one is
reused. It is written under a name unique to the process and renamed into
place, so two processes never load a half-written library.

When no compiler is found, or the library cannot be loaded, :func:`crc32c`
logs one warning and computes in Python (``utils/tb.py``'s table).
:func:`zstd_decompress` has no such fallback (a decoder in Python would take
seconds per checkpoint): without a compiler it raises, naming the compilers
it tried, and only reading a compressed ``.orbax`` checkpoint needs it. This
is host code, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Callable, Optional

from styletransfer_tpu_torch.utils.logging import get_logger

SRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(SRC_DIR)), "build", "native")
CC_FLAGS = ["-O3", "-shared", "-fPIC"]
COMPILERS = ("cc", "gcc", "clang")

_lock = threading.Lock()
_crc32c_fn: Optional[Callable[[bytes], int]] = None
_zstd_lib: Optional[ctypes.CDLL] = None


def _target(src_name: str) -> str:
    """The library of ``src_name``, named by a hash of its source and flags."""
    h = hashlib.sha256(" ".join(CC_FLAGS).encode())
    with open(os.path.join(SRC_DIR, src_name), "rb") as f:
        h.update(f.read())
    stem = os.path.splitext(src_name)[0]
    return os.path.join(BUILD_DIR, f"libstx{stem}_{h.hexdigest()[:16]}.so")


def _build(src_name: str) -> Optional[str]:
    """Compile ``src_name`` unless its library exists; its path, or None when
    no compiler could build it."""
    lib = _target(src_name)
    if os.path.isfile(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.tmp.{os.getpid()}.{threading.get_native_id()}"
    for cc in COMPILERS:
        try:
            subprocess.run([cc, *CC_FLAGS, "-o", tmp, os.path.join(SRC_DIR, src_name)],
                           check=True, capture_output=True, timeout=60)
            os.replace(tmp, lib)
            return lib
        except (OSError, subprocess.SubprocessError):
            if os.path.exists(tmp):
                os.remove(tmp)
    return None


def _load_crc32c() -> Callable[[bytes], int]:
    """The native CRC32C, or the Python one with a warning saying why."""
    try:
        path = _build("crc32c.c")
        if path is None:
            reason = f"no C compiler ({', '.join(COMPILERS)}) could build native/crc32c.c"
        else:
            lib = ctypes.CDLL(path)
            lib.crc32c.restype = ctypes.c_uint32
            lib.crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
            return lambda d: lib.crc32c(d, len(d))
    except OSError as exc:
        reason = f"the native CRC32C library could not be loaded ({exc})"
    get_logger().warning("%s; computing CRC32C in Python", reason)
    from styletransfer_tpu_torch.utils import tb

    return tb._crc32c_py


def crc32c(data: bytes) -> int:
    """CRC32C (Castagnoli) of ``data``: native when the library builds,
    else in Python."""
    global _crc32c_fn
    if _crc32c_fn is None:
        with _lock:
            if _crc32c_fn is None:
                _crc32c_fn = _load_crc32c()
    return _crc32c_fn(bytes(data))


def _load_zstd() -> ctypes.CDLL:
    path = _build("zstd.c")
    if path is None:
        raise RuntimeError(
            f"no C compiler ({', '.join(COMPILERS)}) could build native/zstd.c, the zstd "
            "decoder that reading an .orbax checkpoint needs")
    lib = ctypes.CDLL(path)
    lib.stx_zstd_decompress.restype = ctypes.c_int
    lib.stx_zstd_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p, ctypes.c_size_t]
    lib.stx_zstd_free.restype = None
    lib.stx_zstd_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    return lib


def zstd_decompress(data: bytes) -> bytes:
    """The content of the zstd frames in ``data`` (one or more, back to
    back; skippable frames pass). ValueError naming the fault on malformed
    input or a frame that needs a dictionary; RuntimeError when no C
    compiler builds the decoder."""
    global _zstd_lib
    if _zstd_lib is None:
        with _lock:
            if _zstd_lib is None:
                _zstd_lib = _load_zstd()
    data = bytes(data)
    out = ctypes.POINTER(ctypes.c_uint8)()
    size = ctypes.c_size_t()
    err = ctypes.create_string_buffer(256)
    if _zstd_lib.stx_zstd_decompress(data, len(data), ctypes.byref(out), ctypes.byref(size),
                                     err, len(err)):
        raise ValueError(f"zstd: {err.value.decode(errors='replace')}")
    try:
        return ctypes.string_at(out, size.value)
    finally:
        _zstd_lib.stx_zstd_free(out)
