"""Color ops (PyTorch): grayscale conversion.

Counterpart of ``rgb_to_grayscale`` / ``grayscale_to_rgb`` in the JAX
package's ``ops/color.py`` (reference: torchvision
``transforms/_functional_tensor.py:151-168``).  Channels-last.
"""

from __future__ import annotations

import torch

from .._dtype import cast_back, cast_to_float
from .._layout import as_tensor, num_channels

__all__ = ["rgb_to_grayscale", "grayscale_to_rgb"]


def rgb_to_grayscale(image, num_output_channels: int = 1) -> torch.Tensor:
    """ITU-R 601-2 luma; integer results are rounded via the cast-back
    protocol.  A one-channel image passes through (an HW image gains its
    channel axis)."""
    image = as_tensor(image)
    if num_channels(image) == 1:
        l_img = image[..., None] if image.ndim == 2 else image
    else:
        fimg, orig = cast_to_float(image)
        r, g, b = fimg[..., 0], fimg[..., 1], fimg[..., 2]
        l_img = cast_back(0.2989 * r + 0.587 * g + 0.114 * b, orig)[..., None]
    if num_output_channels == 3:
        l_img = l_img.repeat_interleave(3, dim=-1)
    return l_img


def grayscale_to_rgb(image) -> torch.Tensor:
    image = as_tensor(image)
    if image.ndim == 2:
        image = image[..., None]
    return image.repeat_interleave(3, dim=-1) if image.shape[-1] == 1 else image
