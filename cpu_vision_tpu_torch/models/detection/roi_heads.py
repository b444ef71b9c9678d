"""RoI heads, serving: box heads, predictor, pooling and the postprocess
(counterpart of the JAX package's ``models/detection/roi_heads.py``;
reference ``torchvision/models/detection/roi_heads.py:492-850`` and
``faster_rcnn.py``'s ``TwoMLPHead``, ``FastRCNNConvFCHead`` and
``FastRCNNPredictor``), under torchvision's ``state_dict`` names.

The box heads flatten the pooled (K, 7, 7, C) RoIs in CHW order, as
torchvision's ``fc6`` expects; the JAX package flattens HWC and its converter
permutes ``fc6`` between the two (``torch_weights._linear_from_chw``).
Inference emits ``max_detections`` padded detections an image, as there.
``select_training_samples``, ``compute_loss`` and ``paste_masks_in_image``
are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.boxes import batched_nms, clip_boxes_to_image, top_k
from ...ops.poolers import multiscale_roi_align
from ..resnet import BN_EPS
from ._utils import BoxCoder
from .backbone_utils import conv_block_nhwc

__all__ = ["TwoMLPHead", "FastRCNNConvFCHead", "FastRCNNPredictor", "RoIHeads"]


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def _flatten_chw(x: torch.Tensor) -> torch.Tensor:
    """(K, H, W, C) -> (K, C*H*W) in torchvision's order."""
    return x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)


class TwoMLPHead(nn.Module):
    """Flatten + 2x FC (reference ``TwoMLPHead``, ``faster_rcnn.py:288``)."""

    def __init__(self, in_channels: int, representation_size: int = 1024):
        super().__init__()
        self.fc6 = nn.Linear(in_channels, representation_size)
        self.fc7 = nn.Linear(representation_size, representation_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(_linear(_flatten_chw(x), self.fc6))
        return torch.relu(_linear(x, self.fc7))


class FastRCNNConvFCHead(nn.Sequential):
    """4x (3x3 conv + batch norm + ReLU), flatten, FC + ReLU: the v2 recipe's
    box head (reference ``FastRCNNConvFCHead``, ``faster_rcnn.py:322``); keys
    ``{i}.0``, ``{i}.1`` and ``5`` as torchvision's."""

    def __init__(self, channels: int = 256, pooled: int = 7, conv_layers: int = 4, representation_size: int = 1024):
        blocks = [nn.Sequential(nn.Conv2d(channels, channels, 3, padding=1, bias=False),
                                nn.BatchNorm2d(channels, eps=BN_EPS), nn.ReLU()) for _ in range(conv_layers)]
        super().__init__(*blocks, nn.Flatten(), nn.Linear(channels * pooled * pooled, representation_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layers = list(self)
        for block in layers[:-2]:
            x = conv_block_nhwc(x, block)
        return torch.relu(_linear(_flatten_chw(x), layers[-1]))


class FastRCNNPredictor(nn.Module):
    """Class scores + per-class box deltas (reference ``FastRCNNPredictor``,
    ``faster_rcnn.py:308``)."""

    def __init__(self, in_channels: int, num_classes: int):
        super().__init__()
        self.cls_score = nn.Linear(in_channels, num_classes)
        self.bbox_pred = nn.Linear(in_channels, num_classes * 4)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return _linear(x, self.cls_score), _linear(x, self.bbox_pred)


class RoIHeads(nn.Module):
    """(reference ``RoIHeads``, ``roi_heads.py:492``).  ``box_head_type``
    "mlp" (v1) or "convfc" (v2); ``nms`` is the route of the postprocess's
    class-aware NMS (``ops.boxes.nms``'s ``backend``), set by
    ``FasterRCNN.set_nms``."""

    def __init__(self, num_classes: int = 91, channels: int = 256, pooled_size: int = 7,
                 score_thresh: float = 0.05, nms_thresh: float = 0.5, max_detections: int = 100,
                 pre_nms_detections: int = 4096, box_head_type: str = "mlp"):
        super().__init__()
        if box_head_type not in ("mlp", "convfc"):
            raise ValueError(f"box_head_type is 'mlp' or 'convfc', got {box_head_type!r}")
        self.num_classes = num_classes
        self.pooled_size = pooled_size
        self.score_thresh = score_thresh
        self.nms_thresh = nms_thresh
        self.max_detections = max_detections
        # the static NMS candidate bound of the JAX package (roi_heads.py:323-327 there)
        self.pre_nms_detections = pre_nms_detections
        self.nms: Optional[str] = None
        self.coder = BoxCoder(weights=(10.0, 10.0, 5.0, 5.0))
        if box_head_type == "convfc":
            self.box_head = FastRCNNConvFCHead(channels, pooled_size)
        else:
            self.box_head = TwoMLPHead(channels * pooled_size * pooled_size)
        self.box_predictor = FastRCNNPredictor(1024, num_classes)

    def forward(self, features: Sequence[torch.Tensor], proposals: torch.Tensor, image_size: Tuple[int, int]):
        """features: FPN levels (P2..P5) NHWC; proposals (N, P, 4).  Returns
        (class_logits (N, P, C), box_deltas (N, P, C, 4))."""
        n, p, _ = proposals.shape
        batch_idx = torch.arange(n, dtype=proposals.dtype, device=proposals.device).repeat_interleave(p)
        rois = torch.cat([batch_idx[:, None], proposals.reshape(-1, 4)], dim=1)
        scales = [2.0 ** round(math.log2(f.shape[1] / image_size[0])) for f in features]
        pooled = multiscale_roi_align(features, rois, (self.pooled_size, self.pooled_size), scales=scales)
        scores, deltas = self.box_predictor(self.box_head(pooled))
        return scores.reshape(n, p, self.num_classes), deltas.reshape(n, p, self.num_classes, 4)

    def postprocess(self, class_logits: torch.Tensor, box_deltas: torch.Tensor, proposals: torch.Tensor,
                    image_size: Tuple[int, int]):
        """Per-class decode, score threshold, the top ``pre_nms_detections``
        candidates, class-aware NMS (all images in one call) and the top
        ``max_detections`` -> dict of ``boxes`` (N, D, 4), ``scores`` (N, D),
        ``labels`` (N, D) (-1 where invalid) and ``valid`` (N, D) (reference
        ``postprocess_detections``, ``roi_heads.py:668``)."""
        n, p = class_logits.shape[:2]
        num_fg = self.num_classes - 1
        scores = torch.softmax(class_logits, dim=-1)[..., 1:]  # drop the background
        boxes = self.coder.decode(box_deltas[:, :, 1:, :], proposals[:, :, None, :])  # (N, P, C-1, 4)
        boxes = clip_boxes_to_image(boxes, image_size)
        flat_scores = scores.reshape(n, -1)
        flat_boxes = boxes.reshape(n, -1, 4)
        cls_ids = torch.arange(num_fg, device=class_logits.device).repeat(p)
        zero = torch.zeros((), dtype=flat_scores.dtype, device=flat_scores.device)
        nms_scores = torch.where(flat_scores > self.score_thresh, flat_scores, zero)
        k = min(max(self.pre_nms_detections, 4 * self.max_detections), flat_scores.shape[1])
        top_s, top_i = top_k(nms_scores, k)
        cand_boxes = torch.take_along_dim(flat_boxes, top_i[..., None], dim=1)
        cand_ids = cls_ids[top_i]
        keep = batched_nms(cand_boxes, top_s, cand_ids, self.nms_thresh, self.nms)
        final = torch.where(keep, top_s, torch.full((), -1.0, dtype=top_s.dtype, device=top_s.device))
        sel_s, sel = top_k(final, min(self.max_detections, k))
        valid = sel_s > 0
        return {
            "boxes": torch.take_along_dim(cand_boxes, sel[..., None], dim=1),
            "scores": torch.where(valid, sel_s, zero),
            "labels": torch.where(valid, torch.take_along_dim(cand_ids, sel, dim=1) + 1, -1),
            "valid": valid,
        }
