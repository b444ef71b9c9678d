"""Reusable building blocks of the models (``torch.nn``, NHWC).

Counterpart of the JAX package's ``models/layers.py``; so far the one block
the ported models use.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

__all__ = ["PatchifyDense", "lecun_normal_"]


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
