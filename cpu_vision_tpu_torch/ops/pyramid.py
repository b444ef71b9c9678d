"""Gaussian / Laplacian image pyramids (OpenCV-style 5-tap kernel), PyTorch.

Counterpart of the JAX package's ``ops/pyramid.py`` on the port's own
``filters.separable_filter2d`` (same taps, same order of sums).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .._dtype import cast_back, cast_to_float
from .._layout import as_tensor, ensure_nhwc
from .filters import separable_filter2d

__all__ = [
    "pyr_down",
    "pyr_up",
    "gaussian_pyramid",
    "laplacian_pyramid",
    "reconstruct_from_laplacian",
]

# OpenCV pyrDown/pyrUp binomial kernel
_PYR_KERNEL = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _pyr_blur(nhwc: torch.Tensor) -> torch.Tensor:
    return separable_filter2d(nhwc, _PYR_KERNEL, _PYR_KERNEL, mode="reflect")


def pyr_down(image) -> torch.Tensor:
    """Blur with the 5-tap binomial kernel, then subsample by 2 (even rows
    and columns) — OpenCV ``pyrDown`` semantics."""
    fimg, orig = cast_to_float(as_tensor(image))
    nhwc, restore = ensure_nhwc(fimg)
    blurred = _pyr_blur(nhwc)
    return cast_back(restore(blurred[:, ::2, ::2, :]), orig)


def pyr_up(image, size: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Upsample by 2 (zero-stuffing + 4x-gain binomial blur) — OpenCV
    ``pyrUp`` semantics.  ``size`` overrides the output (h, w) to allow
    odd-sized reconstruction."""
    fimg, orig = cast_to_float(as_tensor(image))
    nhwc, restore = ensure_nhwc(fimg)
    n, h, w, c = nhwc.shape
    oh, ow = (2 * h, 2 * w) if size is None else (int(size[0]), int(size[1]))
    up = torch.zeros((n, oh, ow, c), dtype=nhwc.dtype, device=nhwc.device)
    # the stuffed rows end at the output's edge, the source rows at the input's
    up[:, : 2 * h : 2, : 2 * w : 2, :] = nhwc[:, : (oh + 1) // 2, : (ow + 1) // 2, :]
    blurred = _pyr_blur(up) * 4.0
    return cast_back(restore(blurred), orig)


def gaussian_pyramid(image, levels: int = 4) -> List[torch.Tensor]:
    """[level0 = input, level1 = pyr_down(level0), ...] with ``levels`` entries."""
    out = [as_tensor(image)]
    for _ in range(levels - 1):
        out.append(pyr_down(out[-1]))
    return out


def laplacian_pyramid(image, levels: int = 4) -> List[torch.Tensor]:
    """Band-pass pyramid: ``lap[i] = gauss[i] - pyr_up(gauss[i+1])``; the last
    entry is the coarsest Gaussian level.  Float output (band-pass values are
    signed)."""
    fimg, _ = cast_to_float(as_tensor(image))
    gauss = gaussian_pyramid(fimg, levels)
    laps = []
    for i in range(levels - 1):
        nhwc, restore = ensure_nhwc(gauss[i])
        up_n, _ = ensure_nhwc(pyr_up(gauss[i + 1], size=nhwc.shape[1:3]))
        laps.append(restore(nhwc - up_n))
    laps.append(gauss[-1])
    return laps


def reconstruct_from_laplacian(pyramid: Sequence) -> torch.Tensor:
    """Invert ``laplacian_pyramid``."""
    out = as_tensor(pyramid[-1])
    for lap in reversed(pyramid[:-1]):
        nhwc, restore = ensure_nhwc(as_tensor(lap))
        up_n, _ = ensure_nhwc(pyr_up(out, size=nhwc.shape[1:3]))
        out = restore(nhwc + up_n)
    return out
