"""Region Proposal Network, serving (counterpart of the JAX package's
``models/detection/rpn.py``; reference ``torchvision/models/detection/rpn.py``:
``RPNHead`` :15, ``RegionProposalNetwork`` :113-380).

Fixed shapes as in the JAX package: per level the top ``pre_nms_top_n``
anchors by objectness, decoded and clipped, with a zero score where a side is
under ``min_size``; NMS per level, the levels of one candidate count batched
into one call over (levels x images) problems; then the top
``post_nms_top_n`` of each image.  Every top-k gives ties to the lower index,
as ``jax.lax.top_k``.  ``compute_loss`` serves training and is not ported
yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ...ops.boxes import clip_boxes_to_image, nms, top_k
from ._utils import BoxCoder
from .anchor_utils import AnchorGenerator
from .backbone_utils import conv_block_nhwc, conv_nhwc

__all__ = ["RPNHead", "RegionProposalNetwork"]


class RPNHead(nn.Module):
    """3x3 tower + objectness and box deltas (reference ``RPNHead``,
    ``rpn.py:15``; ``conv_depth=2`` is the v2 recipe's head).  Keys
    ``conv.{d}.0``, ``cls_logits``, ``bbox_pred`` as torchvision's."""

    def __init__(self, in_channels: int, num_anchors: int, conv_depth: int = 1):
        super().__init__()
        self.num_anchors = num_anchors
        self.conv = nn.Sequential(*[nn.Sequential(nn.Conv2d(in_channels, in_channels, 3, padding=1), nn.ReLU())
                                    for _ in range(conv_depth)])
        self.cls_logits = nn.Conv2d(in_channels, num_anchors, 1)
        self.bbox_pred = nn.Conv2d(in_channels, num_anchors * 4, 1)

    def forward(self, features: Sequence[torch.Tensor]) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """NHWC levels -> per level objectness (N, H*W*A) and deltas (N, H*W*A, 4)."""
        logits, deltas = [], []
        for f in features:
            t = f
            for block in self.conv:
                t = conv_block_nhwc(t, block)
            n, h, w, _ = t.shape
            logits.append(conv_nhwc(t, self.cls_logits).reshape(n, h * w * self.num_anchors))
            deltas.append(conv_nhwc(t, self.bbox_pred).reshape(n, h * w * self.num_anchors, 4))
        return logits, deltas


class RegionProposalNetwork(nn.Module):
    """(reference ``RegionProposalNetwork``, ``rpn.py:113``).  ``nms`` is the
    route of the per-level NMS (``ops.boxes.nms``'s ``backend``), set by
    ``FasterRCNN.set_nms``."""

    def __init__(self, in_channels: int = 256,
                 anchor_sizes: Sequence[Sequence[float]] = ((32,), (64,), (128,), (256,), (512,)),
                 aspect_ratios: Sequence[Sequence[float]] = ((0.5, 1.0, 2.0),) * 5,
                 pre_nms_top_n: int = 1000, post_nms_top_n: int = 1000, nms_thresh: float = 0.7,
                 min_size: float = 1e-3, conv_depth: int = 1):
        super().__init__()
        self.anchor_sizes = tuple(anchor_sizes)
        self.aspect_ratios = tuple(aspect_ratios)
        self.pre_nms_top_n = pre_nms_top_n
        self.post_nms_top_n = post_nms_top_n
        self.nms_thresh = nms_thresh
        self.min_size = min_size
        self.nms: Optional[str] = None
        self.coder = BoxCoder(weights=(1.0, 1.0, 1.0, 1.0))
        self.head = RPNHead(in_channels, len(anchor_sizes[0]) * len(aspect_ratios[0]), conv_depth)
        self._anchors: Dict[int, AnchorGenerator] = {}

    def anchors(self, image_size: Tuple[int, int], features: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Per-level anchors for NHWC ``features`` of an ``image_size`` canvas."""
        levels = len(features)
        if levels not in self._anchors:
            self._anchors[levels] = AnchorGenerator(self.anchor_sizes[:levels], self.aspect_ratios[:levels])
        shapes = [(f.shape[1], f.shape[2]) for f in features]
        return self._anchors[levels](image_size, shapes, features[0].device)

    def forward(self, features: Sequence[torch.Tensor], image_size: Tuple[int, int]):
        """Returns (proposals (N, post_nms_top_n, 4), their scores, and the
        per-anchor raw outputs: objectness (N, A), deltas (N, A, 4), anchors
        (A, 4))."""
        logits, deltas = self.head(features)
        anchors = self.anchors(image_size, features)
        proposals, scores = self.filter_proposals(logits, deltas, anchors, image_size)
        return proposals, scores, (torch.cat(logits, 1), torch.cat(deltas, 1), torch.cat(anchors, 0))

    def filter_proposals(self, logits: Sequence[torch.Tensor], deltas: Sequence[torch.Tensor],
                         anchors: Sequence[torch.Tensor], image_size: Tuple[int, int]):
        """Per level: objectness (N, A_l), deltas (N, A_l, 4), anchors (A_l,
        4) -> proposals (N, post_nms_top_n, 4) and scores (reference
        ``filter_proposals``, ``rpn.py:247``)."""
        cand_boxes, cand_scores = [], []
        for lg, dl, anc in zip(logits, deltas, anchors):
            top_s, top_i = top_k(lg, min(self.pre_nms_top_n, lg.shape[1]))
            boxes = self.coder.decode(torch.take_along_dim(dl, top_i[..., None], dim=1), anc[top_i])
            boxes = clip_boxes_to_image(boxes, image_size)
            ok = (boxes[..., 2] - boxes[..., 0] >= self.min_size) & (boxes[..., 3] - boxes[..., 1] >= self.min_size)
            scores = torch.where(ok, torch.sigmoid(top_s), torch.zeros((), dtype=top_s.dtype, device=top_s.device))
            cand_boxes.append(boxes)
            cand_scores.append(scores)

        # NMS within each level (levels never suppress each other), the levels
        # of one candidate count as one call over (levels x images) problems
        kept_scores: List[Optional[torch.Tensor]] = [None] * len(cand_boxes)
        by_k: Dict[int, List[int]] = {}
        for i, b in enumerate(cand_boxes):
            by_k.setdefault(b.shape[1], []).append(i)
        for k_lvl, idxs in by_k.items():
            bs = torch.stack([cand_boxes[i] for i in idxs])  # (L, N, k, 4)
            ss = torch.stack([cand_scores[i] for i in idxs])
            n_lvl, n_img = bs.shape[:2]
            keep = nms(bs.reshape(n_lvl * n_img, k_lvl, 4), ss.reshape(n_lvl * n_img, k_lvl), self.nms_thresh,
                       self.nms).reshape(n_lvl, n_img, k_lvl)
            for j, i in enumerate(idxs):
                kept_scores[i] = torch.where(keep[j], cand_scores[i], torch.zeros((), dtype=cand_scores[i].dtype,
                                                                                 device=keep.device))
        boxes = torch.cat(cand_boxes, dim=1)  # (N, K_total, 4)
        scores = torch.cat(kept_scores, dim=1)
        top_s, top_i = top_k(scores, min(self.post_nms_top_n, scores.shape[1]))
        return torch.take_along_dim(boxes, top_i[..., None], dim=1), top_s
