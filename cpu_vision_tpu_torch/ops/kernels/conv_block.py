"""Fused conv3x3 → bias → ReLU → maxpool2x2 (CUDA, ``csrc/conv_block.cu``)
and its plain PyTorch twin.

Counterpart of the JAX package's ``ops/pallas/conv_block.py``: the fused
stage of the small CNN (``ops.cnn``).  ``x`` is (N, H, W, Cin) float32 NHWC,
``w`` (3, 3, Cin, Cout) HWIO, ``b`` (Cout,); the output is
(N, H/2, W/2, Cout).  ``fused_conv3x3_relu_pool`` given CUDA tensors launches
the hand-written kernel, adds one to its ``launches`` count, and raises if
the launch fails; given CPU tensors it runs the twin.  Nothing falls back
from one to the other.  It is differentiable: the backward recomputes the
twin from the saved ``(x, w, b)`` and differentiates it (``_grad``), as the
JAX package's kernels do.

The twin sums nine per-tap (N·H·W, Cin) × (Cin, Cout) products of the
zero-padded input in (dy, dx) order, as the Pallas kernel does; the CUDA
kernel is an implicit GEMM on the tensor cores by split TF32 (four tf32
products a product, float32 sums), which sums over (dy, dx, ci) in stages of
32 k.  The two agree within ``1e-5 + 1e-5·|twin|``, not bit for bit.  The
kernel takes any batch, any Cin and any Cout: it stages at most 32 input
channels of its window at a time.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ..._dtype import full_float32
from . import _build, _grad

__all__ = ["fused_conv3x3_relu_pool", "fused_conv3x3_relu_pool_plain", "conv3x3_relu_pool"]

_c_lib: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _c_lib
    if _c_lib is None:
        lib = _build.load("conv_block")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cvt_conv3x3_relu_pool.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.cvt_conv3x3_relu_pool.restype = ctypes.c_int
        _c_lib = lib
    return _c_lib


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if x.ndim != 4 or w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[3]):
        raise ValueError("expects NHWC input and 3x3 HWIO kernels matching the input channels")
    if b.shape != (w.shape[3],):
        raise ValueError(f"bias must have shape ({w.shape[3]},), got {tuple(b.shape)}")
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError("H and W must be even for the fused 2x2 pool")
    if min(x.shape) < 1:
        raise ValueError(f"empty input {tuple(x.shape)}")
    for t in (x, w, b):
        if t.dtype != torch.float32:
            raise TypeError(f"expects float32 tensors, got {t.dtype}")
        if t.device != x.device:
            raise ValueError("x, w and b must lie on one device")


def fused_conv3x3_relu_pool_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Twin of ``cvt_conv3x3_relu_pool``: nine per-tap matrix products of the
    zero-padded input summed in (dy, dx) order, bias, ReLU, 2x2 max."""
    _check(x, w, b)
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    padded = F.pad(x, (0, 0, 1, 1, 1, 1))
    acts = None
    with full_float32():
        for dy in range(3):
            for dx in range(3):
                term = padded[:, dy : dy + h, dx : dx + wd, :].reshape(n * h * wd, cin) @ w[dy, dx]
                acts = term if acts is None else acts.add_(term)
    acts = torch.relu_(acts.add_(b))
    return acts.reshape(n, h // 2, 2, wd // 2, 2, cout).amax(dim=(2, 4))


def _kernel(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One launch of ``cvt_conv3x3_relu_pool`` on CUDA tensors, the twin on CPU tensors."""
    if not _build.on_card(x):
        return fused_conv3x3_relu_pool_plain(x, w, b)
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    x, b = x.contiguous(), b.contiguous()
    # the weights as a (9 Cin, ldw) matrix whose rows the kernel copies 16 bytes at a time: ldw a multiple of 4
    wm = w.reshape(9 * cin, cout)
    if cout % 4:
        wm = F.pad(wm, (0, 4 - cout % 4))
    elif not wm.is_contiguous() or wm.data_ptr() % 16:
        wm = wm.clone(memory_format=torch.contiguous_format)
    out = torch.empty((n, h // 2, wd // 2, cout), dtype=torch.float32, device=x.device)
    _build.launch(_lib(), "cvt_conv3x3_relu_pool", x, x.data_ptr(), wm.data_ptr(), b.data_ptr(),
                  out.data_ptr(), n, h, wd, cin, cout, wm.shape[1])
    _build.count_launch(fused_conv3x3_relu_pool, x)
    return out


def fused_conv3x3_relu_pool(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SAME conv3x3 + bias + ReLU + maxpool2x2 in one pass: x (N,H,W,Cin)
    f32 → (N,H/2,W/2,Cout).  H and W must be even (pad first otherwise).
    Gradients reach ``x``, ``w`` and ``b`` through the twin's recompute."""
    _check(x, w, b)
    return _grad.recompute_backward(_kernel, fused_conv3x3_relu_pool_plain, x, w, b, dtype=torch.float32)


_build.reset_count(fused_conv3x3_relu_pool)


def _stock(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The same stage from stock operators in full float32 (no TF32); floors
    odd sizes as VALID pooling does."""
    with full_float32():
        y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b, padding=1)
    return F.max_pool2d(torch.relu_(y), 2).permute(0, 2, 3, 1)


def conv3x3_relu_pool(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      backend: Optional[str] = None) -> torch.Tensor:
    """Fused conv3x3(SAME) + bias + ReLU + maxpool2x2.

    ``backend``: "kernel" (``fused_conv3x3_relu_pool``), "plain" (its twin),
    "stock" (``conv2d`` + ``relu`` + ``max_pool2d``), or None: "kernel" for a
    CUDA tensor, "plain" for a CPU tensor.
    """
    if backend is None:
        backend = "kernel" if _build.on_card(x) else "plain"
    if backend == "kernel":
        return fused_conv3x3_relu_pool(x, w, b)
    if backend == "plain":
        return fused_conv3x3_relu_pool_plain(x, w, b)
    if backend == "stock":
        return _stock(x, w, b)
    raise ValueError(f"unknown backend {backend!r}")
