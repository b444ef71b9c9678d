"""Reusable building blocks of the models (``torch.nn``, NHWC).

Counterpart of the JAX package's ``models/layers.py``, as far as the ported
models use it, with ``MaskedLayerNorm`` of its ``models/swin.py`` and the
``Packed`` cache of kernel-layout weights that the models share.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.depthwise import depthwise_conv2d

__all__ = ["PatchifyDense", "DepthwiseConv", "StochasticDepth", "MaskedLayerNorm", "Packed", "dropout", "layer_norm",
           "lecun_normal_"]

DEPTHWISE_BACKENDS = ("kernel", "stock")


class Packed:
    """Tensors derived from parameters (transposed copies in the compute
    dtype, gathered tables).  Serving rebuilds them only when a parameter was
    written or moved, not at every call.  Under training (grad mode, and a
    parameter that requires a gradient) they are built inside the graph at
    every call, so that gradients reach the parameters; an optimizer's step
    writes the parameters in place between calls anyway."""

    def __init__(self):
        self._key = None
        self._value: Tuple = ()

    def get(self, build: Callable[[], Tuple], dtype: torch.dtype, *params: torch.Tensor) -> Tuple:
        """``build()``'s tuple: in the graph under training; otherwise cached
        for as long as ``dtype`` and the storage and version of every tensor of
        ``params`` stay the same."""
        if torch.is_grad_enabled() and any(p.requires_grad for p in params):
            return tuple(build())
        key = (dtype, *((p.data_ptr(), p._version) for p in params))
        if key != self._key:
            with torch.no_grad():
                self._value = tuple(build())
            self._key = key
        return self._value

    def transposed(self, dtype: torch.dtype, *params: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """(in, out) copies of (out, in) ``params`` in ``dtype``."""
        return self.get(lambda: (p.to(dtype).t().contiguous() for p in params), dtype, *params)


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Zero each element of ``x`` with probability ``p`` and scale the rest by
    1 / (1 - p), with the mask drawn from ``generator`` (on ``x``'s device;
    the default generator without one).  ``F.dropout`` takes no generator."""
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout probability lies in [0, 1), got {p}")
    if p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep.to(x.dtype) * (1.0 / (1.0 - p))


def lecun_normal_(tensor: torch.Tensor, fan_in: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Fill ``tensor`` with normal draws of variance 1 / fan_in.  The values
    are drawn on the generator's device (the CPU without one), so a seed gives
    the same parameters wherever they end up."""
    draw_on = generator.device if generator is not None else "cpu"
    draw = torch.randn(tensor.shape, generator=generator, dtype=torch.float32, device=draw_on)
    with torch.no_grad():
        return tensor.copy_(draw * math.sqrt(1.0 / fan_in))


class PatchifyDense(nn.Module):
    """Non-overlapping patchify convolution (stride == kernel) as
    space-to-depth and one matrix product.

    Each input element is read exactly once, so the convolution is a dense
    product over flattened patches.  The parameter keeps the convolution's
    shape, ``weight`` (features, C, *patch) as ``torch.nn.Conv2d`` has it, so
    checkpoints of the convolution load unchanged; the (prod(patch)·C,
    features) matrix in the (p1, ..., pk, C) order of the flattened patches is
    derived from it at each call.  Input (N, *spatial, C), output the patch
    grid (N, *spatial // patch, features) in ``dtype``.
    """

    def __init__(self, in_channels: int, features: int, patch: Sequence[int], dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch = tuple(patch)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_channels, *self.patch))
        self.bias = nn.Parameter(torch.zeros(features))
        lecun_normal_(self.weight, in_channels * math.prod(self.patch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ps = self.patch
        k = len(ps)
        n, c = x.shape[0], x.shape[-1]
        spatial = tuple(x.shape[1:-1])
        if len(spatial) != k:
            raise ValueError(f"patch {ps} does not match spatial dims {spatial}")
        if any(s % p for s, p in zip(spatial, ps)):
            raise ValueError(f"spatial dims {spatial} not divisible by patch {ps}")
        shape = [n]
        for s, p in zip(spatial, ps):
            shape += [s // p, p]
        x = x.reshape(*shape, c)
        # (n, g1, p1, ..., gk, pk, c) -> (n, g1, ..., gk, p1, ..., pk, c)
        perm = [0] + [1 + 2 * i for i in range(k)] + [2 + 2 * i for i in range(k)] + [2 * k + 1]
        grid = tuple(s // p for s, p in zip(spatial, ps))
        x = x.permute(perm).reshape(n, *grid, math.prod(ps) * c)
        # (F, C, p1..pk) -> (p1..pk, C, F) -> (prod(p)·C, F)
        w = self.weight.permute(*range(2, 2 + k), 1, 0).reshape(-1, self.weight.shape[0])
        return x.to(self.dtype) @ w.to(self.dtype) + self.bias.to(self.dtype)


class StochasticDepth(nn.Module):
    """Drops the residual branch of whole rows with probability ``p`` while
    training (reference ``torchvision/ops/stochastic_depth.py``); the identity
    when serving, which is all the port does so far."""

    def __init__(self, p: float, mode: str = "row"):
        super().__init__()
        if not 0.0 <= p <= 1.0 or mode not in ("row", "batch"):
            raise ValueError(f"p lies in [0, 1] and mode is 'row' or 'batch', got {p} and {mode!r}")
        self.p, self.mode = p, mode

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train and self.p > 0.0:
            raise NotImplementedError("serving only: stochastic depth lands with Swin and ConvNeXt training "
                                      "(ROADMAP queue 1 item 3)")
        return x


class MaskedLayerNorm(nn.Module):
    """LayerNorm whose statistics cover only the first ``count`` real channels
    of a zero-padded row (the channel-padded Swin): padded channels hold
    zeros, so sums over all channels equal sums over the real ones, and
    zero-padded ``weight``/``bias`` keep the padded outputs at zero.
    Statistics are float32; the output has the input's dtype."""

    def __init__(self, channels: int, count: int, eps: float = 1e-5):
        super().__init__()
        if not 0 < count <= channels:
            raise ValueError(f"count must lie in 1..{channels}, got {count}")
        self.count, self.eps = count, eps
        self.normalized_shape = (channels,)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        m = x32.sum(dim=-1, keepdim=True) / self.count
        v = (x32 * x32).sum(dim=-1, keepdim=True) / self.count - m * m
        y = (x32 - m) * torch.rsqrt(v + self.eps)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, ln: nn.Module, dtype: torch.dtype) -> torch.Tensor:
    """``ln`` (``nn.LayerNorm`` or ``MaskedLayerNorm``) of ``x`` in float32, cast to ``dtype``."""
    if isinstance(ln, MaskedLayerNorm):
        return ln(x.float()).to(dtype)
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps).to(dtype)


class DepthwiseConv(nn.Module):
    """Depthwise K×K convolution on NHWC maps.  Parameters have
    ``torch.nn.Conv2d``'s shapes for ``groups == channels``: ``weight``
    (C, 1, kh, kw) and ``bias`` (C,).

    ``backend="kernel"`` runs ``kernels.depthwise_conv2d``, which takes
    stride 1, no dilation, odd K and symmetric SAME padding: any other
    geometry raises at construction.  ``"stock"`` runs ``F.conv2d(groups=C)``;
    ``None`` follows the JAX package's rule, where the kernel is opt-in (its
    ``CVT_DW_PALLAS`` switch, off by default): stock.
    """

    def __init__(self, features: int, kernel_size: Tuple[int, int], strides: Tuple[int, int] = (1, 1),
                 padding: Union[str, Sequence[Tuple[int, int]]] = "SAME", kernel_dilation: Tuple[int, int] = (1, 1),
                 use_bias: bool = True, dtype: torch.dtype = torch.float32, backend: Optional[str] = None):
        super().__init__()
        if backend not in (None, *DEPTHWISE_BACKENDS):
            raise ValueError(f"backend is None or one of {DEPTHWISE_BACKENDS}, got {backend!r}")
        kh, kw = kernel_size
        dy, dx = kernel_dilation
        ekh, ekw = (kh - 1) * dy + 1, (kw - 1) * dx + 1  # effective extent
        if padding == "SAME":
            pads = [((ekh - 1) // 2, ekh // 2), ((ekw - 1) // 2, ekw // 2)]
        elif padding == "VALID":
            pads = [(0, 0), (0, 0)]
        else:
            pads = [tuple(p) for p in padding]
        self.features, self.kernel_size, self.strides, self.pads = features, (kh, kw), tuple(strides), pads
        self.kernel_dilation, self.dtype, self.backend = (dy, dx), dtype, backend
        self.weight = nn.Parameter(torch.empty(features, 1, kh, kw))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        lecun_normal_(self.weight, kh * kw)
        self._packed = Packed()
        if backend == "kernel" and not self.kernel_applies():
            raise ValueError(f'backend="kernel" takes stride 1, no dilation, odd kernel sizes and symmetric SAME '
                             f"padding; got kernel {self.kernel_size}, strides {self.strides}, dilation "
                             f'{self.kernel_dilation}, padding {pads} (use backend="stock")')

    def kernel_applies(self) -> bool:
        kh, kw = self.kernel_size
        return (self.strides == (1, 1) and self.kernel_dilation == (1, 1) and kh % 2 == 1 and kw % 2 == 1
                and self.pads == [(kh // 2, kh // 2), (kw // 2, kw // 2)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.features:
            raise ValueError(f"DepthwiseConv needs in_channels == features, got {x.shape[-1]} vs {self.features}")
        x = x.to(self.dtype)
        if self.backend == "kernel":
            (taps,) = self._packed.get(lambda: (self.weight[:, 0].permute(1, 2, 0).to(self.dtype).contiguous(),),
                                       self.dtype, self.weight)
            return depthwise_conv2d(x.contiguous(), taps, self.bias, self.bias is not None)
        (top, bottom), (left, right) = self.pads
        if (top, left) != (bottom, right):
            x = F.pad(x, (0, 0, left, right, top, bottom))
            top = left = 0
        bias = None if self.bias is None else self.bias.to(self.dtype)
        out = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(self.dtype), bias, self.strides, (top, left),
                       self.kernel_dilation, groups=self.features)
        return out.permute(0, 2, 3, 1)
