"""Depthwise K×K convolution, stride 1, zero SAME padding, NHWC (CUDA,
``csrc/depthwise.cu``) and its plain PyTorch twin.

Counterpart of the JAX package's ``ops/pallas/depthwise.py``: ConvNeXt's 7×7
depthwise convolution.  ``x`` is (N, H, W, C), ``kernel`` (kh, kw, C) per-channel
taps of ``x``'s dtype (float32 or bfloat16), ``bias`` (C,) of any float dtype;
the output has ``x``'s shape and dtype.  The taps are summed in float32 in
(i, j) order, the bias is added last, the sum is rounded once.

``depthwise_conv2d`` given CUDA tensors launches the hand-written kernel, adds
one to its ``launches`` count, and raises if the launch fails or the kernel
does not take the arguments (it takes square kernels of ``KERNEL_SIZES``);
given CPU tensors it runs the twin.  Nothing falls back from one to the
other.  The kernel sums with fused multiply-adds and the twin with separate
products and sums, so float32 agrees within ``1e-5 + 1e-5·|twin|``, bfloat16
within one rounding step of the output.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .flash_attention import DTYPES

__all__ = ["depthwise_conv2d", "depthwise_conv2d_plain", "KERNEL_SIZES"]

KERNEL_SIZES = (3, 5, 7)  # instantiations in csrc/depthwise.cu

_c_lib: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _c_lib
    if _c_lib is None:
        lib = _build.load("depthwise")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cvt_depthwise_conv2d.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.cvt_depthwise_conv2d.restype = ctypes.c_int
        _c_lib = lib
    return _c_lib


def _check(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    if x.ndim != 4 or min(x.shape) < 1:
        raise ValueError(f"expects non-empty NHWC input, got {tuple(x.shape)}")
    if kernel.ndim != 3 or kernel.shape[2] != x.shape[3]:
        raise ValueError(f"expects (kh, kw, C) taps matching the input's {x.shape[3]} channels, "
                         f"got {tuple(kernel.shape)}")
    if kernel.shape[0] % 2 == 0 or kernel.shape[1] % 2 == 0:
        raise ValueError(f"kernel sizes must be odd, got {tuple(kernel.shape[:2])}")
    if bias is not None and bias.shape != (x.shape[3],):
        raise ValueError(f"bias must have shape ({x.shape[3]},), got {tuple(bias.shape)}")
    for t in (x, kernel) if bias is None else (x, kernel, bias):
        if not t.dtype.is_floating_point:
            raise TypeError(f"expects floating-point tensors, got {t.dtype}")
        if t.device != x.device:
            raise ValueError("x, kernel and bias must lie on one device")


def depthwise_conv2d_plain(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
                           use_bias: bool = True) -> torch.Tensor:
    """Twin of ``cvt_depthwise_conv2d``: shifted slices of the zero-padded
    input times their taps, summed in float32 in (i, j) order."""
    bias = bias if use_bias else None
    _check(x, kernel, bias)
    n, h, w, c = x.shape
    kh, kw = kernel.shape[:2]
    padded = F.pad(x.float(), (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    k32 = kernel.float()
    acc = torch.zeros((n, h, w, c), dtype=torch.float32, device=x.device)
    for i in range(kh):
        for j in range(kw):
            acc += padded[:, i : i + h, j : j + w, :] * k32[i, j]
    if bias is not None:
        acc += bias.float()
    return acc.to(x.dtype)


def depthwise_conv2d(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
                     use_bias: bool = True) -> torch.Tensor:
    """Depthwise convolution, stride 1, SAME, odd K×K, in one pass over ``x``
    with no padded copy.  ``bias`` is ignored with ``use_bias=False``."""
    bias = bias if use_bias else None
    _check(x, kernel, bias)
    if not _build.on_card(x):
        return depthwise_conv2d_plain(x, kernel, bias)
    n, h, w, c = x.shape
    kh, kw = kernel.shape[:2]
    if kh != kw or kh not in KERNEL_SIZES:
        raise ValueError(f"the kernel takes square taps of sizes {KERNEL_SIZES}, got {(kh, kw)}")
    if x.dtype not in DTYPES or kernel.dtype != x.dtype:
        raise TypeError(f"the kernel takes x and the taps in float32 or bfloat16 alike, got {x.dtype} and "
                        f"{kernel.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    kernel = kernel.contiguous()
    bias = None if bias is None else bias.float().contiguous()
    out = torch.empty_like(x)
    _build.launch(_lib(), "cvt_depthwise_conv2d", x, x.data_ptr(), kernel.data_ptr(),
                  None if bias is None else bias.data_ptr(), out.data_ptr(), n, h, w, c, kh,
                  int(x.dtype == torch.bfloat16))
    _build.count_launch(depthwise_conv2d, x)
    return out


_build.reset_count(depthwise_conv2d)
