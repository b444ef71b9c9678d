"""Bounding-box ops: the IoU family, conversion, clipping, NMS.

Counterpart of the JAX package's ``ops/boxes.py`` (the reference's
``torchvision/ops/boxes.py``), same formulas in the same order.  Boxes are
``(x1, y1, x2, y2)`` rows, (N, 4) unless stated.  NMS returns a boolean keep
mask, not a list of indices, and takes leading batch dimensions of
independent problems: each call site of a detector is one call.

``nms(..., backend=None|"kernel"|"plain")``: ``None`` runs the hand-written
CUDA kernel ``ops.kernels.nms_sorted`` on a CUDA tensor and its plain twin on
a CPU tensor, and sends a shape the kernel does not take (more than
``MAX_BOXES`` boxes a problem or ``MAX_PROBLEMS`` problems) to the twin,
counted in ``nms_sorted.plain_routes``; ``"kernel"`` runs the kernel and
raises on a CPU tensor or on a shape it does not take; ``"plain"`` runs the
twin anywhere.  (The JAX
package runs its Pallas NMS only when asked, on a TPU; there it lost to XLA.)
Boxes are widened to float32 for the IoUs, as the Pallas kernel does.

``top_k`` is ``jax.lax.top_k`` with its tie order: equal values come lower
index first (a stable descending sort, sliced), which ``torch.topk`` does not
promise.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .kernels import _build
from .kernels import nms as _nms_kernel

__all__ = [
    "box_area",
    "box_iou",
    "generalized_box_iou",
    "distance_box_iou",
    "complete_box_iou",
    "box_convert",
    "clip_boxes_to_image",
    "remove_small_boxes",
    "masks_to_boxes",
    "nms",
    "nms_padded",
    "batched_nms",
]

NMS_BACKENDS = (None, "kernel", "plain")


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries along the last dim and their indices, in
    descending order, equal values lower index first (``jax.lax.top_k``)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """(x2-x1)·(y2-y1) (reference ``box_area``, ``ops/boxes.py:235``)."""
    return (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])


def _box_inter_union(boxes1: torch.Tensor, boxes2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[:, :, 0] * wh[:, :, 1]
    union = area1[:, None] + area2[None, :] - inter
    return inter, union


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU (N, M) (reference ``box_iou``, ``ops/boxes.py:271``)."""
    inter, union = _box_inter_union(boxes1, boxes2)
    return inter / union


def _enclosing_wh(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    lti = torch.minimum(boxes1[:, None, :2], boxes2[None, :, :2])
    rbi = torch.maximum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    return (rbi - lti).clamp_min(0)


def generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """GIoU (reference ``generalized_box_iou``, ``ops/boxes.py:294``)."""
    inter, union = _box_inter_union(boxes1, boxes2)
    iou = inter / union
    whi = _enclosing_wh(boxes1, boxes2)
    areai = whi[:, :, 0] * whi[:, :, 1]
    return iou - (areai - union) / areai


def _box_diou_iou(boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = 1e-7):
    iou = box_iou(boxes1, boxes2)
    whi = _enclosing_wh(boxes1, boxes2)
    diag_sq = whi[:, :, 0] ** 2 + whi[:, :, 1] ** 2 + eps
    x_p = (boxes1[:, 0] + boxes1[:, 2]) * 0.5
    y_p = (boxes1[:, 1] + boxes1[:, 3]) * 0.5
    x_g = (boxes2[:, 0] + boxes2[:, 2]) * 0.5
    y_g = (boxes2[:, 1] + boxes2[:, 3]) * 0.5
    centers_sq = (x_p[:, None] - x_g[None, :]) ** 2 + (y_p[:, None] - y_g[None, :]) ** 2
    return iou - centers_sq / diag_sq, iou


def distance_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """DIoU (reference ``distance_box_iou``, ``ops/boxes.py:360``)."""
    diou, _ = _box_diou_iou(boxes1, boxes2, eps)
    return diou


def complete_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """CIoU (reference ``complete_box_iou``, ``ops/boxes.py:327``)."""
    diou, iou = _box_diou_iou(boxes1, boxes2, eps)
    w_pred = boxes1[:, None, 2] - boxes1[:, None, 0]
    h_pred = boxes1[:, None, 3] - boxes1[:, None, 1]
    w_gt = boxes2[:, 2] - boxes2[:, 0]
    h_gt = boxes2[:, 3] - boxes2[:, 1]
    v = (4.0 / math.pi**2) * (torch.arctan(w_pred / h_pred) - torch.arctan(w_gt / h_gt)) ** 2
    alpha = (v / (1 - iou + v + eps)).detach()
    return diou - alpha * v


def box_convert(boxes: torch.Tensor, in_fmt: str, out_fmt: str) -> torch.Tensor:
    """Convert between 'xyxy', 'xywh', 'cxcywh' (reference ``box_convert``,
    ``ops/boxes.py:177`` + ``ops/_box_convert.py``)."""
    fmts = ("xyxy", "xywh", "cxcywh")
    if in_fmt not in fmts or out_fmt not in fmts:
        raise ValueError(f"formats must be one of {fmts}")
    if in_fmt == out_fmt:
        return boxes
    a, b, c, d = boxes.unbind(-1)
    if in_fmt == "xywh":
        xyxy = torch.stack([a, b, a + c, b + d], dim=-1)
    elif in_fmt == "cxcywh":
        xyxy = torch.stack([a - c * 0.5, b - d * 0.5, a + c * 0.5, b + d * 0.5], dim=-1)
    else:
        xyxy = boxes
    if out_fmt == "xyxy":
        return xyxy
    x1, y1, x2, y2 = xyxy.unbind(-1)
    if out_fmt == "xywh":
        return torch.stack([x1, y1, x2 - x1, y2 - y1], dim=-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1], dim=-1)


def clip_boxes_to_image(boxes: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Clip to [0, W] x [0, H]; ``size`` is (height, width) (reference
    ``clip_boxes_to_image``, ``ops/boxes.py:127``)."""
    h, w = size
    x = boxes[..., 0::2].clamp(0, w)
    y = boxes[..., 1::2].clamp(0, h)
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], dim=-1)


def remove_small_boxes(boxes: torch.Tensor, min_size: float) -> torch.Tensor:
    """Boolean mask of boxes with both sides >= min_size (fixed-shape analog
    of reference ``remove_small_boxes``, ``ops/boxes.py:157``, which returns
    indices)."""
    ws = boxes[:, 2] - boxes[:, 0]
    hs = boxes[:, 3] - boxes[:, 1]
    return (ws >= min_size) & (hs >= min_size)


def masks_to_boxes(masks: torch.Tensor) -> torch.Tensor:
    """(N, H, W) masks -> (N, 4) float32 xyxy boxes (reference
    ``masks_to_boxes``, ``ops/boxes.py:402``).  All-zero masks give zeros."""
    _, h, w = masks.shape
    masks = masks.bool()
    any_mask = masks.any(dim=(1, 2))
    xs = torch.arange(w, dtype=torch.float32, device=masks.device)
    ys = torch.arange(h, dtype=torch.float32, device=masks.device)
    big = torch.tensor(1e9, dtype=torch.float32, device=masks.device)
    mx = torch.where(masks, xs[None, None, :], big).amin(dim=(1, 2))
    big_x = torch.where(masks, xs[None, None, :], -big).amax(dim=(1, 2))
    my = torch.where(masks, ys[None, :, None], big).amin(dim=(1, 2))
    big_y = torch.where(masks, ys[None, :, None], -big).amax(dim=(1, 2))
    boxes = torch.stack([mx, my, big_x, big_y], dim=-1)
    return torch.where(any_mask[:, None], boxes, torch.zeros((), dtype=torch.float32, device=masks.device))


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        backend: Optional[str] = None) -> torch.Tensor:
    """Greedy NMS keep mask (..., N) bool for boxes (..., N, 4) and scores
    (..., N); leading dims are independent problems.

    Exact semantics of the reference kernel
    (``csrc/ops/cpu/nms_kernel.cpp:48-75``): boxes are taken in descending
    score order (a stable sort, as ``jnp.argsort(-scores)``), and a box is
    kept iff no higher-scored *kept* box has ``IoU > iou_threshold`` with it.
    """
    if backend not in NMS_BACKENDS:
        raise ValueError(f"backend must be one of {NMS_BACKENDS}, got {backend!r}")
    if boxes.shape[-1:] != (4,) or boxes.shape[:-1] != scores.shape:
        raise ValueError(f"expects boxes (..., N, 4) and scores (..., N), got {tuple(boxes.shape)} and "
                         f"{tuple(scores.shape)}")
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    sorted_boxes = torch.take_along_dim(boxes, order[..., None], dim=-2)
    if backend is None and not _nms_kernel.kernel_takes(sorted_boxes):
        _build.count_plain_route(_nms_kernel.nms_sorted)
        backend = "plain"
    if backend == "plain":
        keep_sorted = _nms_kernel.nms_sorted_plain(sorted_boxes, iou_threshold)
    else:
        if backend == "kernel":
            _nms_kernel.require_kernel(sorted_boxes)
        keep_sorted = _nms_kernel.nms_sorted(sorted_boxes, iou_threshold)
    return torch.zeros_like(keep_sorted).scatter_(-1, order, keep_sorted)


def nms_padded(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_output_size: Optional[int] = None,
    backend: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """NMS returning fixed-size ``(indices, count)``: ``indices`` (..., K) of
    the kept boxes in descending score order, padded with -1; ``count`` the
    number of valid entries."""
    n = boxes.shape[-2]
    k = n if max_output_size is None else min(max_output_size, n)
    keep = nms(boxes, scores, iou_threshold, backend)
    masked = torch.where(keep, scores, torch.tensor(-math.inf, dtype=scores.dtype, device=scores.device))
    top_scores, top_idx = top_k(masked, k)
    valid = top_scores > -math.inf
    return torch.where(valid, top_idx, -1), valid.sum(dim=-1)


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    idxs: torch.Tensor,
    iou_threshold: float,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Class-aware NMS keep mask via the coordinate-offset trick (reference
    ``batched_nms`` / ``_batched_nms_coordinate_trick``, ``ops/boxes.py:44-96``):
    boxes of different ``idxs`` never overlap.  The offsets are computed in
    the boxes' dtype, from the largest coordinate of each problem (leading
    dims are independent problems, as in ``nms``)."""
    if boxes.shape[-2] == 0:
        return torch.zeros(boxes.shape[:-1], dtype=torch.bool, device=boxes.device)
    max_coord = boxes.amax(dim=(-2, -1))
    offsets = idxs.to(boxes.dtype) * (max_coord + 1.0)[..., None]
    shifted = boxes + offsets[..., None]
    return nms(shifted, scores, iou_threshold, backend)
