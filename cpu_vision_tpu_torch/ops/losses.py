"""Detection losses (PyTorch).

Counterpart of the JAX package's ``ops/losses.py`` (the reference's
``torchvision/ops/*loss*.py``), elementwise over aligned pairs, with a
``reduction`` in {"none", "mean", "sum"}.
"""

from __future__ import annotations

import math

import torch

__all__ = ["sigmoid_focal_loss", "generalized_box_iou_loss", "distance_box_iou_loss", "complete_box_iou_loss"]


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "none":
        return loss
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    raise ValueError(f"invalid reduction {reduction!r}")


def sigmoid_focal_loss(inputs: torch.Tensor, targets: torch.Tensor, alpha: float = 0.25, gamma: float = 2.0,
                       reduction: str = "none") -> torch.Tensor:
    """Focal loss for dense detection (JAX ``sigmoid_focal_loss``), with the
    stable binary cross entropy of logits."""
    p = torch.sigmoid(inputs)
    ce = torch.clamp_min(inputs, 0) - inputs * targets + torch.log1p(torch.exp(-inputs.abs()))
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return _reduce(loss, reduction)


def _iou_and_union(boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float):
    (x1, y1, x2, y2), (x1g, y1g, x2g, y2g) = boxes1.unbind(-1), boxes2.unbind(-1)
    inter = (torch.clamp_min(torch.minimum(x2, x2g) - torch.maximum(x1, x1g), 0)
             * torch.clamp_min(torch.minimum(y2, y2g) - torch.maximum(y1, y1g), 0))
    union = (x2 - x1) * (y2 - y1) + (x2g - x1g) * (y2g - y1g) - inter
    return inter / (union + eps), union


def generalized_box_iou_loss(boxes1: torch.Tensor, boxes2: torch.Tensor, reduction: str = "none",
                             eps: float = 1e-7) -> torch.Tensor:
    """1 - GIoU of aligned (x1, y1, x2, y2) pairs (JAX ``generalized_box_iou_loss``)."""
    (x1, y1, x2, y2), (x1g, y1g, x2g, y2g) = boxes1.unbind(-1), boxes2.unbind(-1)
    iou, union = _iou_and_union(boxes1, boxes2, eps)
    area_c = (torch.maximum(x2, x2g) - torch.minimum(x1, x1g)) * (torch.maximum(y2, y2g) - torch.minimum(y1, y1g))
    return _reduce(1.0 - (iou - (area_c - union) / (area_c + eps)), reduction)


def distance_box_iou_loss(boxes1: torch.Tensor, boxes2: torch.Tensor, reduction: str = "none",
                          eps: float = 1e-7) -> torch.Tensor:
    """1 - DIoU of aligned pairs (JAX ``distance_box_iou_loss``)."""
    (x1, y1, x2, y2), (x1g, y1g, x2g, y2g) = boxes1.unbind(-1), boxes2.unbind(-1)
    iou, _ = _iou_and_union(boxes1, boxes2, eps)
    diag_sq = (torch.maximum(x2, x2g) - torch.minimum(x1, x1g)) ** 2 \
        + (torch.maximum(y2, y2g) - torch.minimum(y1, y1g)) ** 2 + eps
    cdist = ((x1 + x2) * 0.5 - (x1g + x2g) * 0.5) ** 2 + ((y1 + y2) * 0.5 - (y1g + y2g) * 0.5) ** 2
    return _reduce(1.0 - iou + cdist / diag_sq, reduction)


def complete_box_iou_loss(boxes1: torch.Tensor, boxes2: torch.Tensor, reduction: str = "none",
                          eps: float = 1e-7) -> torch.Tensor:
    """1 - CIoU of aligned pairs (JAX ``complete_box_iou_loss``); the aspect
    term's weight alpha takes no gradient."""
    diou = distance_box_iou_loss(boxes1, boxes2, "none", eps)
    (x1, y1, x2, y2), (x1g, y1g, x2g, y2g) = boxes1.unbind(-1), boxes2.unbind(-1)
    v = (4.0 / math.pi ** 2) * (torch.atan((x2g - x1g) / (y2g - y1g)) - torch.atan((x2 - x1) / (y2 - y1))) ** 2
    iou, _ = _iou_and_union(boxes1, boxes2, eps)
    alpha = (v / (1 - iou + v + eps)).detach()
    return _reduce(diou + alpha * v, reduction)
