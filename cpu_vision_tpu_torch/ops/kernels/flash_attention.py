"""Fused multi-head attention (CUDA, ``csrc/attention.cu``) and its plain
PyTorch twin: ``softmax(q kᵀ · scale) v`` per head, scores never in device
memory.

Counterpart of the JAX package's ``ops/pallas/flash_attention.py``.  ``q``,
``k`` and ``v`` arrive as the QKV projection leaves them, (N, S, H, hd), and
the output is (N, H, S, hd), in ``q``'s dtype (float32 or bfloat16).  Scores
and softmax are float32; the probabilities are cast to ``q``'s dtype before
the product with ``v``, which sums in float32.  ``flash_mha`` given CUDA
tensors launches the hand-written kernel, adds one to its ``launches`` count
and raises if the launch fails; given CPU tensors it runs the twin.  Nothing
falls back from one to the other.  It is differentiable: the backward
differentiates the twin, recomputed from the saved ``q``, ``k``, ``v``
(``_grad``; the JAX package writes the same softmax backward out by hand).

The kernel streams key tiles with an online softmax and divides by the row
sum at the end; the twin normalises before the cast, as the Pallas kernel
does.  In float32 the two differ by the order of sums; in bfloat16 also by
where the probabilities are rounded (before or after the division), both
within the bfloat16 step.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..._dtype import float32_products
from . import _build, _grad

__all__ = ["flash_mha", "flash_mha_plain", "HEAD_DIMS"]

HEAD_DIMS = (16, 64, 80)  # instantiations in csrc/attention.cuh
DTYPES = (torch.float32, torch.bfloat16)

_c_lib: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _c_lib
    if _c_lib is None:
        lib = _build.load("attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cvt_flash_mha.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_float, i, p]
        lib.cvt_flash_mha.restype = ctypes.c_int
        _c_lib = lib
    return _c_lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or min(q.shape) < 1:
        raise ValueError(f"expects non-empty (N, S, H, hd) tensors, got {tuple(q.shape)}")
    for t in (k, v):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k and v must share shape, dtype and device")
    if q.dtype not in DTYPES:
        raise TypeError(f"expects float32 or bfloat16 tensors, got {q.dtype}")


def flash_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Twin of ``cvt_flash_mha``: float32 scores and softmax, probabilities
    cast to ``q``'s dtype, float32 sums; (N, S, H, hd) → (N, H, S, hd)."""
    _check(q, k, v)
    with float32_products(q.dtype):
        scores = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float()) * scale
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        return torch.einsum("nhqk,nkhd->nhqd", probs.float(), v.float()).to(q.dtype)


def _kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """One launch of ``cvt_flash_mha`` on CUDA tensors, the twin on CPU tensors."""
    if not _build.on_card(q):
        return flash_mha_plain(q, k, v, scale)
    n, s, h, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"the kernel has head dims {HEAD_DIMS}, got {hd}")
    if n > 65535 or h > 65535:
        raise ValueError(f"at most 65535 images and heads a launch, got {n} and {h}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    out = torch.empty((n, h, s, hd), dtype=q.dtype, device=q.device)
    _build.launch(_lib(), "cvt_flash_mha", q, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  n, s, h, hd, float(scale), int(q.dtype == torch.bfloat16))
    _build.count_launch(flash_mha, q)
    return out


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """``softmax(q kᵀ · scale) v`` per head: (N, S, H, hd) in, (N, H, S, hd)
    out in ``q``'s dtype.  On the card the head dim must be one of
    ``HEAD_DIMS`` and the tensors contiguous."""
    _check(q, k, v)
    return _grad.recompute_backward(_kernel, flash_mha_plain, q, k, v, scale, dtype=q.dtype)


_build.reset_count(flash_mha)
