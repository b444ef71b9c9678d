"""Anchor generation (counterpart of the JAX package's
``models/detection/anchor_utils.py``; reference ``AnchorGenerator``,
``torchvision/models/detection/anchor_utils.py:10-150``): per-level base
anchors from (sizes, aspect ratios), tiled over the feature grid at the
level's stride.  Built in numpy as there (integer strides, ``np.round``,
half to even) and handed over as tensors at the end."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["AnchorGenerator"]


class AnchorGenerator:
    def __init__(self, sizes: Sequence[Sequence[float]] = ((128, 256, 512),),
                 aspect_ratios: Sequence[Sequence[float]] = ((0.5, 1.0, 2.0),)):
        if len(sizes) != len(aspect_ratios):
            raise ValueError("sizes and aspect_ratios must have the same length")
        self.sizes = [tuple(s) for s in sizes]
        self.aspect_ratios = [tuple(a) for a in aspect_ratios]
        self._cache: Dict[tuple, List[torch.Tensor]] = {}

    def num_anchors_per_location(self) -> List[int]:
        return [len(s) * len(a) for s, a in zip(self.sizes, self.aspect_ratios)]

    @staticmethod
    def _base_anchors(scales, ratios) -> np.ndarray:
        """Zero-centred (A, 4) anchors (reference ``generate_anchors``,
        ``anchor_utils.py:63-79``)."""
        scales = np.asarray(scales, np.float32)
        ratios = np.asarray(ratios, np.float32)
        h_ratios = np.sqrt(ratios)
        w_ratios = 1.0 / h_ratios
        ws = (w_ratios[:, None] * scales[None, :]).reshape(-1)
        hs = (h_ratios[:, None] * scales[None, :]).reshape(-1)
        base = np.stack([-ws, -hs, ws, hs], axis=1) / 2.0
        return np.round(base)

    def __call__(self, image_size: Tuple[int, int], feature_shapes: Sequence[Tuple[int, int]],
                 device=None) -> List[torch.Tensor]:
        """Anchors per level: a list of (H_l * W_l * A_l, 4) float32 xyxy
        tensors in image coordinates, on ``device`` (built once a setting)."""
        key = (tuple(image_size), tuple(map(tuple, feature_shapes)), str(device))
        if key not in self._cache:
            ih, iw = image_size
            out = []
            for (fh, fw), sizes, ratios in zip(feature_shapes, self.sizes, self.aspect_ratios):
                stride_h, stride_w = ih // fh, iw // fw
                base = self._base_anchors(sizes, ratios)  # (A, 4)
                shifts_x = np.arange(fw, dtype=np.float32) * stride_w
                shifts_y = np.arange(fh, dtype=np.float32) * stride_h
                sy, sx = np.meshgrid(shifts_y, shifts_x, indexing="ij")
                shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
                anchors = (shifts + base[None]).reshape(-1, 4).astype(np.float32)
                out.append(torch.from_numpy(anchors).to(device))
            self._cache[key] = out
        return self._cache[key]
