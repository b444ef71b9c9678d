"""Stochastic regularisers: stochastic depth and DropBlock (PyTorch).

Counterpart of the JAX package's ``ops/regularizers.py`` (the reference's
``ops/stochastic_depth.py`` and ``ops/drop_block.py``), on its layouts: NHWC
for ``drop_block2d``, NDHWC for ``drop_block3d``.  Where the JAX functions
take a ``jax.random`` key, these take a ``torch.Generator`` on the input's
device; without one they draw from torch's default generator, where the JAX
functions raise for a missing key.  The two packages draw different numbers
from the same seed.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["stochastic_depth", "drop_block2d", "drop_block3d"]


def _check_p(p: float) -> None:
    if p < 0.0 or p > 1.0:
        raise ValueError(f"p must be in [0, 1], got {p}")


def _bernoulli(shape, rate: float, dtype: torch.dtype, device, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Ones with probability ``rate``, zeros elsewhere, drawn from ``generator``."""
    return (torch.rand(shape, generator=generator, device=device) < rate).to(dtype)


def stochastic_depth(x: torch.Tensor, p: float, mode: str, training: bool,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Zero whole residual branches with probability ``p`` and scale the rest by
    1 / (1 - p): ``mode`` "row" draws one keep bit per sample (the leading
    dim), "batch" one for the whole tensor (JAX ``stochastic_depth``)."""
    _check_p(p)
    if mode not in ("batch", "row"):
        raise ValueError(f"mode must be 'batch' or 'row', got {mode}")
    if not training or p == 0.0:
        return x
    survival_rate = 1.0 - p
    size = (x.shape[0],) + (1,) * (x.ndim - 1) if mode == "row" else (1,) * x.ndim
    noise = _bernoulli(size, survival_rate, x.dtype, x.device, generator)
    if survival_rate > 0.0:
        noise = noise / survival_rate
    return x * noise


def _drop_block(x: torch.Tensor, p: float, block_size: int, eps: float, generator) -> torch.Tensor:
    """DropBlock over the spatial dims of channels-last ``x``: seeds at rate
    gamma on the valid positions, padded and max-pooled into blocks of
    ``block_size`` (the JAX "SAME" window over the padded seeds), then the
    kept elements scaled by numel / (eps + Σ mask)."""
    spatial = x.shape[1:-1]
    k = len(spatial)
    block_size = min(block_size, *spatial)
    valid = [s - block_size + 1 for s in spatial]
    gamma = p * x[0, ..., 0].numel() / (block_size ** k * torch.Size(valid).numel())
    noise = _bernoulli((x.shape[0], *valid, x.shape[-1]), gamma, x.dtype, x.device, generator)
    lo = block_size // 2
    hi = block_size - 1 - lo
    noise = noise.movedim(-1, 1)  # channels first for padding and pooling
    noise = F.pad(noise, (lo, hi) * k)
    # "SAME" max-pool over the padded map of size s + block_size - 1: pad (b-1)//2 before, b//2 after, with
    # zeros, which the max over zeros and ones leaves unchanged
    noise = F.pad(noise, ((block_size - 1) // 2, block_size // 2) * k)
    pool = F.max_pool2d if k == 2 else F.max_pool3d
    noise = pool(noise, block_size, stride=1).movedim(1, -1)
    mask = 1.0 - noise
    return x * mask * (mask.numel() / (eps + mask.sum()))


def drop_block2d(x: torch.Tensor, p: float, block_size: int, inplace: bool = False, eps: float = 1e-06,
                 training: bool = True, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """DropBlock2d on NHWC input (JAX ``drop_block2d``).  ``inplace`` is
    accepted for the reference's signature and ignored, as in JAX."""
    _check_p(p)
    if x.ndim != 4:
        raise ValueError(f"expected NHWC input, got ndim {x.ndim}")
    if not training or p == 0.0:
        return x
    return _drop_block(x, p, block_size, eps, generator)


def drop_block3d(x: torch.Tensor, p: float, block_size: int, inplace: bool = False, eps: float = 1e-06,
                 training: bool = True, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """DropBlock3d on NDHWC input (JAX ``drop_block3d``)."""
    _check_p(p)
    if x.ndim != 5:
        raise ValueError(f"expected NDHWC input, got ndim {x.ndim}")
    if not training or p == 0.0:
        return x
    return _drop_block(x, p, block_size, eps, generator)
