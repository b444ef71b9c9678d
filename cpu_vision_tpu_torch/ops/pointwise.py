"""Pointwise (1x1) convolution whose weight gradient runs the hand-written
``wgrad_matmul`` kernel.

Counterpart of the JAX package's ``ops/pointwise.py``.  ``conv1x1(x, kernel,
stride)`` takes NHWC ``x`` and the flax kernel (1, 1, Cin, Cout) of the same
dtype; it is differentiable:

* forward: the strided slice and one matrix product (the JAX package leaves
  this to XLA, outside Pallas; here ``torch.matmul``);
* ``dx = dy·Wᵀ`` at the sampled positions, zero elsewhere (``torch.matmul``);
* ``dW = xᵀ·dy`` summed in float32: on the card through
  ``kernels.wgrad_matmul`` from ``MIN_ROWS_FOR_KERNEL`` rows up (where the JAX
  package takes its Pallas kernel on the TPU), through its twin below that and
  on the CPU.

``PointwiseConv`` holds ``torch.nn.Conv2d``'s ``weight`` (Cout, Cin, 1, 1), no
bias, and takes NHWC input.  As in the JAX package, no model uses it: the
ResNets keep the stock convolution for their 1x1s.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .._dtype import full_float32
from .kernels.wgrad_matmul import wgrad_matmul, wgrad_matmul_plain

__all__ = ["conv1x1", "PointwiseConv", "MIN_ROWS_FOR_KERNEL"]

# below this many rows the JAX package leaves the weight gradient to XLA's dot
# (``_MIN_ROWS_FOR_PALLAS``); the port takes the twin there
MIN_ROWS_FOR_KERNEL = 16384


def _sampled(x: torch.Tensor, stride: int) -> torch.Tensor:
    return x[:, ::stride, ::stride, :] if stride > 1 else x


class _Conv1x1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, stride):
        ctx.stride = stride
        ctx.save_for_backward(x, kernel)
        xs = _sampled(x, stride)
        cin, cout = kernel.shape[2], kernel.shape[3]
        with full_float32():
            y = xs.reshape(-1, cin) @ kernel.reshape(cin, cout)
        return y.reshape(*xs.shape[:3], cout)

    @staticmethod
    def backward(ctx, dy):
        x, kernel = ctx.saved_tensors
        stride = ctx.stride
        cin, cout = kernel.shape[2], kernel.shape[3]
        xs = _sampled(x, stride)
        dy2 = dy.reshape(-1, cout).to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            with full_float32():
                dxs = (dy2 @ kernel.reshape(cin, cout).t()).reshape(xs.shape)
            if stride > 1:
                dx = torch.zeros_like(x)
                dx[:, ::stride, ::stride, :] = dxs
            else:
                dx = dxs
        if ctx.needs_input_grad[1]:
            xf = xs.reshape(-1, cin)
            dw = wgrad_matmul(xf, dy2) if xf.shape[0] >= MIN_ROWS_FOR_KERNEL else wgrad_matmul_plain(xf, dy2)
            dw = dw.to(kernel.dtype).reshape(kernel.shape)
        return dx, dw, None


def conv1x1(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """1x1 convolution with stride ``stride`` and no padding of NHWC ``x``
    (N, H, W, Cin) by ``kernel`` (1, 1, Cin, Cout), both of one dtype: exactly
    a strided slice and a matrix product.  Returns (N, ⌈H/s⌉, ⌈W/s⌉, Cout)."""
    if x.ndim != 4 or kernel.shape[:3] != (1, 1, x.shape[3]) or kernel.ndim != 4:
        raise ValueError(f"expects NHWC x and a (1, 1, Cin, Cout) kernel, got {tuple(x.shape)} and "
                         f"{tuple(kernel.shape)}")
    if x.dtype != kernel.dtype:
        raise TypeError(f"x and kernel must share a dtype, got {x.dtype} and {kernel.dtype}")
    if stride < 1:
        raise ValueError(f"stride must be at least 1, got {stride}")
    return _Conv1x1.apply(x, kernel, int(stride))


class PointwiseConv(nn.Module):
    """``nn.Conv2d(in_channels, features, 1, strides, bias=False)`` on NHWC
    input, computed by ``conv1x1`` in ``dtype`` (float32 or bfloat16); the
    weight (features, in_channels, 1, 1) is float32 and drawn as the JAX
    module's (variance-scaling normal, 1 / Cin) from ``generator``."""

    def __init__(self, in_channels: int, features: int, strides: int = 1, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.strides, self.dtype = strides, dtype
        draw_on = generator.device if generator is not None else "cpu"
        draw = torch.randn((features, in_channels, 1, 1), generator=generator, device=draw_on)
        self.weight = nn.Parameter(draw.cpu() * (1.0 / in_channels) ** 0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1x1(x.to(self.dtype), self.weight.to(self.dtype).permute(2, 3, 1, 0), self.strides)
