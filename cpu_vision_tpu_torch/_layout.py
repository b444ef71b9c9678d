"""Tensor layout helpers.

Everything in this package is channels-last (NHWC), as in the JAX package.
Public ops accept ``HW``, ``HWC`` or ``NHWC`` images; these helpers normalise
to NHWC and restore the caller's rank on the way out.  A 3-D image is read
as HWC, never as NHW.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

__all__ = ["as_tensor", "ensure_nhwc", "num_channels", "spatial_size"]


def as_tensor(image) -> torch.Tensor:
    """``image`` as a tensor.  A tensor stays on its own device; anything
    else (a numpy array, a list) is copied to the first CUDA card.  A caller
    who wants the CPU passes a CPU tensor."""
    if isinstance(image, torch.Tensor):
        return image
    arr = np.asarray(image)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to("cuda")


def ensure_nhwc(image: torch.Tensor) -> Tuple[torch.Tensor, Callable[[torch.Tensor], torch.Tensor]]:
    """Return ``(nhwc, restore)`` where ``restore`` maps back to the input rank."""
    image = as_tensor(image)
    if image.ndim == 2:  # HW -> 1HW1
        return image[None, :, :, None], lambda x: x[0, :, :, 0]
    if image.ndim == 3:  # HWC -> 1HWC
        return image[None], lambda x: x[0]
    if image.ndim == 4:
        return image, lambda x: x
    raise ValueError(f"expected HW, HWC or NHWC array, got shape {tuple(image.shape)}")


def num_channels(image: torch.Tensor) -> int:
    if image.ndim == 2:
        return 1
    return image.shape[-1]


def spatial_size(image: torch.Tensor) -> Tuple[int, int]:
    """(height, width) of an HW / HWC / NHWC image."""
    if image.ndim == 2:
        return image.shape[0], image.shape[1]
    return image.shape[-3], image.shape[-2]
