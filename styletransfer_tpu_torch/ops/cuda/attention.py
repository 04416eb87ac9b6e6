"""Fused single-head attention, ``softmax(q k^T) v`` over the keys, f32:
SANet's style attention (``models/sanet.py``).

Not the port of a TPU kernel: the JAX package has no attention.
``csrc/attention.cu`` keeps the [Nq, Nk] score matrix out of device memory
(an online max and sum over tiles of keys, the output accumulated in
registers); its header says what bounds it on the card and how its tiles
fit. There is no scale on the scores (SANet takes none), no mask and one
head.

:func:`attention` launches the kernel on CUDA tensors and computes
:func:`attention_plain` on CPU tensors. ``launches`` counts the kernel's
launches: two per SANet forward (``models/sanet.py::apply``: relu4_1's
block and relu5_1's), none on any other path.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from styletransfer_tpu_torch.ops.cuda import _build, check_cuda_inputs

# Kernel launches since the counter was last set to 0.
launches = 0

# The width the kernel is built for: SANet's 512 channels at relu4_1 and
# relu5_1.
WIDTH = 512


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the [B, Nq, Nk] scores, their softmax over the
    keys, and its product with ``v`` (a key batch of one serves every
    query image)."""
    return torch.softmax(q @ k.transpose(1, 2), dim=-1) @ v


def _check(q, k, v) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"q, k and v must be [B, N, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, nq, d = q.shape
    if d % 32:
        raise ValueError(f"the width must be a multiple of 32, got {d}")
    if k.shape != v.shape or k.shape[2] != d or k.shape[0] not in (1, B):
        raise ValueError(f"k and v must both be [{B} or 1, Nk, {d}], got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if nq < 1 or k.shape[1] < 1:
        raise ValueError(f"no queries or no keys: q {tuple(q.shape)}, k {tuple(k.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``q`` [B, Nq, D], ``k`` and ``v`` [B or 1, Nk, D] f32 -> [B, Nq, D]
    f32: ``softmax(q k^T) v``, the softmax over the keys, no scale. Any Nq
    and Nk; the kernel takes D = 512 and raises on another width. Forward
    only."""
    _check(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("attention has no backward; call it without gradients")
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    global launches
    check_cuda_inputs(q, k, v)
    B, nq, d = q.shape
    if d != WIDTH:
        raise ValueError(f"the attention kernel is built for D = {WIDTH}, got {d}")
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):  # the library launches on the current device
        err = lib.stx_attention_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                    B, nq, k.shape[1], d, k.shape[0],
                                    torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"attention kernel launch failed for q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}: {lib.stx_attention_error_string(err).decode()}")
    launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.library("attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.stx_attention_f32.argtypes = [p] * 4 + [i] * 5 + [p]
    lib.stx_attention_f32.restype = i
    lib.stx_attention_error_string.argtypes = [i]
    lib.stx_attention_error_string.restype = ctypes.c_char_p
    return lib
