"""Minimal TensorBoard event writer with no dependency beyond numpy and PIL.

The port's own copy of ``styletransfer_tpu/utils/tb.py``: scalar curves and
side-by-side image logs with the reference's tags (``data/fst_train_loss``,
``data/fst_test_loss``, ``data/fst_images``) and its "wipe the run directory,
then recreate it" semantics (:func:`get_tensorboard_writer`).

Event files are TFRecord-framed protobuf ``Event`` messages, written by hand
(protobuf wire format and CRC32C record framing, the CRC in pure Python);
they load in stock TensorBoard.
"""

from __future__ import annotations

import io
import os
import shutil
import socket
import struct
import time
from typing import Optional

import numpy as np

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), required by the TFRecord framing.
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _build_table() -> None:
    poly = 0x82F63B78
    for n in range(256):
        crc = n
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_table()


def _crc32c(data: bytes) -> int:
    """CRC32C of ``data``, table-driven in Python."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Protobuf wire-format encoding helpers.
# ---------------------------------------------------------------------------


def _varint(value: int) -> bytes:
    out = bytearray()
    value &= 0xFFFFFFFFFFFFFFFF
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _f_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _f_varint(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


def _f_bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def _encode_scalar_value(tag: str, value: float) -> bytes:
    # Summary.Value { tag = 1; simple_value = 2; }
    return _f_bytes(1, tag.encode()) + _f_float(2, value)


def _encode_image_value(tag: str, png_bytes: bytes, h: int, w: int, c: int) -> bytes:
    # Summary.Image { height=1; width=2; colorspace=3; encoded_image_string=4 }
    img = (
        _f_varint(1, h) + _f_varint(2, w) + _f_varint(3, c) + _f_bytes(4, png_bytes)
    )
    # Summary.Value { tag = 1; image = 4; }
    return _f_bytes(1, tag.encode()) + _f_bytes(4, img)


def _encode_event(
    step: int,
    wall_time: float,
    summary_value: Optional[bytes] = None,
    file_version: Optional[str] = None,
) -> bytes:
    # Event { wall_time=1 (double); step=2 (int64); file_version=3; summary=5 }
    out = _f_double(1, wall_time) + _f_varint(2, step)
    if file_version is not None:
        out += _f_bytes(3, file_version.encode())
    if summary_value is not None:
        out += _f_bytes(5, _f_bytes(1, summary_value))  # Summary { value = 1 }
    return out


class SummaryWriter:
    """Append-only TensorBoard event-file writer.

    API mirrors the tensorboardX subset the reference uses:
    ``add_scalar(tag, value, step)`` and ``add_image(tag, img, step)``.
    """

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self._path = os.path.join(logdir, fname)
        self._file = open(self._path, "ab")
        self._write_record(_encode_event(0, time.time(), file_version="brain.Event:2"))

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._file.write(header)
        self._file.write(struct.pack("<I", _masked_crc(header)))
        self._file.write(data)
        self._file.write(struct.pack("<I", _masked_crc(data)))
        self._file.flush()

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._write_record(
            _encode_event(step, time.time(), _encode_scalar_value(tag, float(value)))
        )

    def add_image(self, tag: str, image: np.ndarray, step: int) -> None:
        """Log an HWC (or NHWC batch-1) uint8 or [0,1]-float image."""
        from PIL import Image

        arr = np.asarray(image)
        if arr.ndim == 4:
            arr = arr[0]
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
        h, w = arr.shape[:2]
        c = arr.shape[2] if arr.ndim == 3 else 1
        if arr.ndim == 3 and arr.shape[2] == 1:
            # PIL rejects (H, W, 1) uint8 ("cannot handle this data
            # type"); grayscale encodes from the 2-D view, c stays 1.
            arr = arr[:, :, 0]
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        self._write_record(
            _encode_event(
                step, time.time(), _encode_image_value(tag, buf.getvalue(), h, w, c)
            )
        )

    def close(self) -> None:
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def get_tensorboard_writer(path: str) -> SummaryWriter:
    """Delete-and-recreate writer, per the reference (network.py:25-35)."""
    shutil.rmtree(path, ignore_errors=True)
    return SummaryWriter(path)
