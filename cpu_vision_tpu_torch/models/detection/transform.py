"""GeneralizedRCNNTransform (counterpart of the JAX package's
``models/detection/transform.py``; reference
``torchvision/models/detection/transform.py:86-300``): normalise, resize by
the min/max-size rule (bilinear, no antialias, ``ops.resize``), pad onto one
static canvas divisible by 32, and map detections back to each image's own
coordinates.  ``size_bucket`` rounds each target size up to a multiple of
the bucket, as there.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..._layout import as_tensor
from ...ops.resize import resize as _resize

__all__ = ["GeneralizedRCNNTransform"]


class GeneralizedRCNNTransform:
    def __init__(self, min_size: int = 800, max_size: int = 1333,
                 image_mean: Sequence[float] = (0.485, 0.456, 0.406), image_std: Sequence[float] = (0.229, 0.224, 0.225),
                 size_divisible: int = 32, fixed_size: Optional[Tuple[int, int]] = None,
                 size_bucket: Optional[int] = 64):
        self.min_size = min_size
        self.max_size = max_size
        self.image_mean = torch.tensor(image_mean, dtype=torch.float32)
        self.image_std = torch.tensor(image_std, dtype=torch.float32)
        self.size_divisible = size_divisible
        self.fixed_size = fixed_size
        self.size_bucket = size_bucket

    def _target_size(self, h: int, w: int) -> Tuple[int, int]:
        """The min/max-size rule (reference ``_resize_image_and_masks``),
        rounded up to ``size_bucket`` and clamped to the canvas."""
        if self.fixed_size is not None:
            return self.fixed_size
        scale = min(self.min_size / min(h, w), self.max_size / max(h, w))
        th, tw = int(round(h * scale)), int(round(w * scale))
        if self.size_bucket:
            ch, cw = self.canvas_size()
            b = self.size_bucket
            th = min(math.ceil(th / b) * b, ch)
            tw = min(math.ceil(tw / b) * b, cw)
        return th, tw

    def canvas_size(self) -> Tuple[int, int]:
        """The static padded canvas every batch uses."""
        h, w = self.fixed_size if self.fixed_size is not None else (self.max_size, self.max_size)
        d = self.size_divisible
        return math.ceil(h / d) * d, math.ceil(w / d) * d

    def __call__(self, images, boxes=None):
        """images: a list of HWC float images (numpy arrays go to the card), or
        one NHWC batch.  Returns (the NHWC batch on the canvas, the scaled
        boxes or None, each image's (sy, sx) scale factors)."""
        if not isinstance(images, (list, tuple)):
            images = as_tensor(images)
            images = list(images) if images.ndim == 4 else [images]
        ch, cw = self.canvas_size()
        out_imgs, out_boxes, scales = [], [], []
        images = [as_tensor(img) for img in images]
        mean, std = self.image_mean.to(images[0].device), self.image_std.to(images[0].device)
        for i, img in enumerate(images):
            h, w = img.shape[0], img.shape[1]
            img = (img - mean) / std
            th, tw = self._target_size(h, w)
            img = _resize(img, (th, tw), "bilinear", antialias=False)
            out_imgs.append(F.pad(img, (0, 0, 0, cw - tw, 0, ch - th)))
            scales.append((th / h, tw / w))
            if boxes is not None:
                sy, sx = th / h, tw / w
                out_boxes.append(as_tensor(boxes[i]) * torch.tensor([sx, sy, sx, sy], dtype=torch.float32,
                                                                    device=img.device))
        return torch.stack(out_imgs), (out_boxes if boxes is not None else None), scales

    def postprocess_boxes(self, boxes: torch.Tensor, scales, index: int) -> torch.Tensor:
        """Map predicted boxes back to the original image's coordinates
        (reference ``postprocess``, ``transform.py:257``)."""
        sy, sx = scales[index]
        x1, y1, x2, y2 = boxes.unbind(-1)  # each divided by its factor rounded to float32, as a float32 vector would
        return torch.stack([x1 / sx, y1 / sy, x2 / sx, y2 / sy], dim=-1)
