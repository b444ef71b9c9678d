"""Box coding for the detectors.

Counterpart of the JAX package's ``models/detection/_utils.py`` (reference
``torchvision/models/detection/_utils.py``: ``BoxCoder`` :122).  ``Matcher``
and ``BalancedPositiveNegativeSampler`` serve training and are not ported yet.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

__all__ = ["BoxCoder"]


class BoxCoder:
    """Encode boxes as center/size deltas with respect to reference boxes, and
    decode them (reference ``BoxCoder``, ``detection/_utils.py:122-219``).
    Dtypes follow the JAX package's: bfloat16 deltas on float32 anchors decode
    to float32 boxes."""

    def __init__(self, weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0),
                 bbox_xform_clip: float = math.log(1000.0 / 16)):
        self.weights = weights
        self.bbox_xform_clip = bbox_xform_clip

    def encode(self, reference_boxes: torch.Tensor, proposals: torch.Tensor) -> torch.Tensor:
        """Deltas such that ``decode(deltas, proposals) == reference_boxes``.
        Widths and heights are clamped to 1e-6, as in the JAX package, so a
        degenerate padded row stays finite."""
        wx, wy, ww, wh = self.weights
        eps = 1e-6
        ex_w = (proposals[..., 2] - proposals[..., 0]).clamp_min(eps)
        ex_h = (proposals[..., 3] - proposals[..., 1]).clamp_min(eps)
        ex_cx = proposals[..., 0] + 0.5 * ex_w
        ex_cy = proposals[..., 1] + 0.5 * ex_h
        gt_w = (reference_boxes[..., 2] - reference_boxes[..., 0]).clamp_min(eps)
        gt_h = (reference_boxes[..., 3] - reference_boxes[..., 1]).clamp_min(eps)
        gt_cx = reference_boxes[..., 0] + 0.5 * gt_w
        gt_cy = reference_boxes[..., 1] + 0.5 * gt_h
        dx = wx * (gt_cx - ex_cx) / ex_w
        dy = wy * (gt_cy - ex_cy) / ex_h
        dw = ww * torch.log(gt_w / ex_w)
        dh = wh * torch.log(gt_h / ex_h)
        return torch.stack([dx, dy, dw, dh], dim=-1)

    def decode(self, deltas: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """Apply ``deltas`` (..., 4) to ``boxes`` (..., 4, broadcast) -> xyxy;
        the size deltas are clipped at ``bbox_xform_clip`` before ``exp``."""
        wx, wy, ww, wh = self.weights
        widths = boxes[..., 2] - boxes[..., 0]
        heights = boxes[..., 3] - boxes[..., 1]
        cx = boxes[..., 0] + 0.5 * widths
        cy = boxes[..., 1] + 0.5 * heights
        dx = deltas[..., 0] / wx
        dy = deltas[..., 1] / wy
        dw = (deltas[..., 2] / ww).clamp(max=self.bbox_xform_clip)
        dh = (deltas[..., 3] / wh).clamp(max=self.bbox_xform_clip)
        pred_cx = dx * widths + cx
        pred_cy = dy * heights + cy
        pred_w = torch.exp(dw) * widths
        pred_h = torch.exp(dh) * heights
        return torch.stack([pred_cx - 0.5 * pred_w, pred_cy - 0.5 * pred_h,
                            pred_cx + 0.5 * pred_w, pred_cy + 0.5 * pred_h], dim=-1)
