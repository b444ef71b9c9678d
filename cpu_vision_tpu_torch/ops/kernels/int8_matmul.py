"""The int8 product with a requantising epilogue (CUDA, ``csrc/int8_matmul.cu``)
and its plain PyTorch twin.

Counterpart of the JAX package's ``ops/pallas/int8_matmul.py``:
``int8_matmul_requant(qx, qw, scale, bias, out_scale=None, relu=False)`` is
``clip(rint(relu(qx @ qw * scale + bias) * (1 / out_scale)), -127, 127)`` as
int8 for ``qx`` (M, K) and ``qw`` (K, N) int8, ``scale`` and ``bias`` (N,)
float32; with ``out_scale=None`` the float32 ``relu(qx @ qw * scale + bias)``.
The product sums exactly in int32; the epilogue is float32, in that order,
multiplying by ``1 / out_scale`` (computed once in float32), never dividing.
The JAX function's ``block_m``, ``block_n`` and ``interpret`` arguments have
no counterpart here.

A wrapper given CUDA tensors launches the hand-written kernel, one launch of
the s8 product of ``csrc/int8_gemm.cuh`` on the int8 tensor cores (``wgmma``,
int32 sums), adds one to its ``launches`` count and raises if the launch fails
or the kernel does not take the arguments (K a multiple of ``K_STEP``, rows
16-byte aligned; any M: past 65,535 row tiles of 128 the launcher launches
again on the rows that follow); given CPU tensors it runs the twin.
The kernel reads the weight transposed, (N, K): a ``qw`` that is the
transposed view of a contiguous (N, K) tensor costs no copy.  The twin
multiplies with ``int_mm``, exact in int32 on either device.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["int8_matmul_requant", "int8_matmul_requant_plain", "int_mm", "quantize_i8", "kernel_takes", "recording",
           "K_STEP"]

K_STEP = 16  # the kernel's K is a multiple of this (one 16-byte chunk of a row)

_c_lib: Optional[ctypes.CDLL] = None
_recorders: List[list] = []


def _lib() -> ctypes.CDLL:
    global _c_lib
    if _c_lib is None:
        lib = _build.load("int8_matmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cvt_int8_matmul_requant.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        lib.cvt_int8_matmul_requant.restype = ctypes.c_int
        _c_lib = lib
    return _c_lib


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of int8 ``a`` (M, K) and ``b`` (K, N) by
    ``torch._int_mm`` (cuBLASLt on the card), with zero rows and columns added
    where the card's shape rules ask for them (M > 16, K and N multiples of 8),
    and ``b`` laid out column-major there, the one layout cuBLASLt's int8
    product takes."""
    if a.device.type != "cuda":
        return torch._int_mm(a.contiguous(), b.contiguous())
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp, np_) != (m, k, n):
        a, b = F.pad(a, (0, kp - k, 0, mp - m)), F.pad(b, (0, np_ - n, 0, kp - k))
    return torch._int_mm(a.contiguous(), b.t().contiguous().t())[:m, :n]


@contextlib.contextmanager
def recording() -> Iterator[List[Tuple]]:
    """Within the block, each launch of the kernel appends ``(qx, qw, scale,
    bias, out_scale, relu, out)`` to the yielded list: the tensors it was given
    and the one it returned (references, not copies)."""
    calls: List[Tuple] = []
    _recorders.append(calls)
    try:
        yield calls
    finally:
        _recorders.remove(calls)


def quantize_i8(f: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """``clip(rint(f * inv), -127, 127)`` as int8 (round half to even)."""
    return torch.clamp(torch.round(f * inv), -127, 127).to(torch.int8)


def kernel_takes(k: int) -> bool:
    """Whether the kernel takes a product over ``k``."""
    return k >= K_STEP and k % K_STEP == 0


def _check(qx, qw, scale, bias) -> None:
    if qx.dtype != torch.int8 or qw.dtype != torch.int8:
        raise TypeError(f"expects int8 qx and qw, got {qx.dtype} and {qw.dtype}")
    if qx.ndim != 2 or qw.ndim != 2 or qx.shape[1] != qw.shape[0] or min(*qx.shape, qw.shape[1]) < 1:
        raise ValueError(f"expects non-empty qx (M, K) and qw (K, N), got {tuple(qx.shape)} and {tuple(qw.shape)}")
    n = qw.shape[1]
    if tuple(scale.shape) != (n,) or tuple(bias.shape) != (n,):
        raise ValueError(f"expects scale and bias ({n},), got {tuple(scale.shape)} and {tuple(bias.shape)}")
    if not (scale.dtype.is_floating_point and bias.dtype.is_floating_point):
        raise TypeError("expects floating-point scale and bias")
    if len({t.device for t in (qx, qw, scale, bias)}) != 1:
        raise ValueError("all tensors must lie on one device")


def _inverse(out_scale, device) -> Optional[torch.Tensor]:
    """``1 / out_scale`` in float32 as a 0-d tensor on ``device``, or None."""
    if out_scale is None:
        return None
    return 1.0 / torch.as_tensor(out_scale, dtype=torch.float32, device=device).reshape(())


def int8_matmul_requant_plain(qx, qw, scale, bias, out_scale=None, relu: bool = False) -> torch.Tensor:
    """Twin of ``cvt_int8_matmul_requant``: the same math in plain PyTorch operators."""
    _check(qx, qw, scale, bias)
    f = int_mm(qx, qw).float() * scale.float() + bias.float()
    if relu:
        f = torch.clamp_min(f, 0.0)
    inv = _inverse(out_scale, f.device)
    return f if inv is None else quantize_i8(f, inv)


def int8_matmul_requant(qx, qw, scale, bias, out_scale=None, relu: bool = False) -> torch.Tensor:
    """``clip(rint(relu(qx @ qw * scale + bias) / out_scale))`` as int8 (float32
    when ``out_scale`` is None), in one kernel on the card."""
    _check(qx, qw, scale, bias)
    if not _build.on_card(qx):
        return int8_matmul_requant_plain(qx, qw, scale, bias, out_scale, relu)
    m, k = qx.shape
    n = qw.shape[1]
    if not kernel_takes(k):
        raise ValueError(f"the kernel takes K a multiple of {K_STEP}, got {k}")
    qwt = qw.t().contiguous()
    if not qx.is_contiguous() or qx.data_ptr() % 16 or qwt.data_ptr() % 16:
        raise ValueError("qx must be contiguous, and qx and qw must start 16-byte aligned")
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    inv = _inverse(out_scale, qx.device)
    out = torch.empty((m, n), dtype=torch.float32 if inv is None else torch.int8, device=qx.device)
    _build.launch(_lib(), "cvt_int8_matmul_requant", qx, qx.data_ptr(), qwt.data_ptr(), scale.data_ptr(),
                  bias.data_ptr(), None if inv is None else inv.data_ptr(), out.data_ptr(), m, k, n, int(bool(relu)))
    _build.count_launch(int8_matmul_requant, qx)
    for calls in _recorders:
        calls.append((qx, qw, scale, bias, out_scale, relu, out))
    return out


_build.reset_count(int8_matmul_requant)
