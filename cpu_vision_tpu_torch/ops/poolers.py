"""Multi-scale RoI pooling over FPN levels.

Counterpart of the JAX package's ``ops/poolers.py`` (reference
``torchvision/ops/poolers.py``: ``LevelMapper`` :47, ``_multiscale_roi_align``
:147, ``MultiScaleRoIAlign`` :230).  Each roi is pooled once, at its own
level, by ``roi_align_pyramid``; ``all_levels=True`` pools every roi at every
level and selects, the formulation the JAX package keeps behind its
``CVT_ROI_ALLLEVEL`` environment switch (the port reads no environment).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from .roi import roi_align, roi_align_pyramid

__all__ = ["LevelMapper", "multiscale_roi_align", "MultiScaleRoIAlign"]


class LevelMapper:
    """Map each roi to an FPN level by its scale (reference ``LevelMapper``,
    ``ops/poolers.py:47-85``: ``floor(lvl0 + log2(sqrt(area)/224))``)."""

    def __init__(self, k_min: int, k_max: int, canonical_scale: int = 224, canonical_level: int = 4,
                 eps: float = 1e-6):
        self.k_min = k_min
        self.k_max = k_max
        self.s0 = canonical_scale
        self.lvl0 = canonical_level
        self.eps = eps

    def __call__(self, boxes: torch.Tensor) -> torch.Tensor:
        """boxes (K, 4) xyxy -> int64 level index in [0, k_max - k_min]."""
        scales = torch.sqrt((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]))
        target = torch.floor(self.lvl0 + torch.log2(scales / self.s0 + self.eps))
        target = target.clamp(self.k_min, self.k_max)
        return (target - self.k_min).to(torch.int64)


def multiscale_roi_align(
    features: Sequence[torch.Tensor],
    rois: torch.Tensor,
    output_size: Tuple[int, int],
    scales: Sequence[float],
    sampling_ratio: int = 2,
    canonical_scale: int = 224,
    canonical_level: int = 4,
    all_levels: bool = False,
) -> torch.Tensor:
    """Pool (K, 5) rois from the right FPN level -> (K, PH, PW, C).

    ``features``: list of (N, H_l, W_l, C) maps; ``scales``: feature stride
    reciprocals per level (e.g. 1/4, 1/8, 1/16, 1/32).  With a positive
    ``sampling_ratio`` and ``all_levels=False`` every roi is pooled once, at
    its own level; otherwise at every level, and its own level's result
    selected (the same numbers).
    """
    k_min = -int(math.log2(scales[0]))
    k_max = -int(math.log2(scales[-1]))
    levels = LevelMapper(k_min, k_max, canonical_scale, canonical_level)(rois[:, 1:])
    if sampling_ratio > 0 and not all_levels:
        return roi_align_pyramid(features, rois, levels, output_size, scales, sampling_ratio=sampling_ratio)
    pooled = torch.stack([roi_align(f, rois, output_size, spatial_scale=s, sampling_ratio=sampling_ratio)
                          for f, s in zip(features, scales)])  # (L, K, PH, PW, C)
    onehot = F.one_hot(levels, len(features)).T.to(pooled.dtype)  # (L, K)
    return (pooled * onehot[:, :, None, None, None]).sum(dim=0)


class MultiScaleRoIAlign:
    """Stateful wrapper mirroring the reference module
    (``MultiScaleRoIAlign``, ``ops/poolers.py:230``)."""

    def __init__(self, output_size, sampling_ratio: int = 2, canonical_scale: int = 224,
                 canonical_level: int = 4):
        self.output_size = (output_size, output_size) if isinstance(output_size, int) else tuple(output_size)
        self.sampling_ratio = sampling_ratio
        self.canonical_scale = canonical_scale
        self.canonical_level = canonical_level

    def __call__(self, features: Sequence[torch.Tensor], rois: torch.Tensor,
                 image_size: Tuple[int, int]) -> torch.Tensor:
        # snap to powers of two like the reference's infer_scale
        scales = [2.0 ** round(math.log2(f.shape[1] / image_size[0])) for f in features]
        return multiscale_roi_align(features, rois, self.output_size, scales, self.sampling_ratio,
                                    self.canonical_scale, self.canonical_level)
