"""Quantised (int8/uint8) op variants: tensors carried as (values, scale,
zero_point).

Counterpart of the JAX package's ``ops/quantized.py`` (the reference's
QuantizedCPU kernels ``csrc/ops/quantized/cpu/{qnms,qroi_align}_kernel.cpp``):
they dequantise on the fly, compute in float32 and requantise at the end, over
the port's ``nms`` and ``roi_align``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .boxes import nms as _nms
from .roi import roi_align as _roi_align

__all__ = ["quantize", "dequantize", "qnms", "qroi_align"]


def quantize(x: torch.Tensor, scale: float, zero_point: int, dtype: torch.dtype = torch.uint8) -> torch.Tensor:
    """``clip(rint(x / scale) + zero_point)`` to the range of ``dtype``."""
    info = torch.iinfo(dtype)
    q = torch.round(x / scale) + zero_point
    return torch.clamp(q, info.min, info.max).to(dtype)


def dequantize(q: torch.Tensor, scale: float, zero_point: int) -> torch.Tensor:
    return (q.float() - zero_point) * scale


def qnms(qboxes: torch.Tensor, qscores: torch.Tensor, iou_threshold: float, boxes_scale: float = 1.0,
         boxes_zero_point: int = 0, backend: Optional[str] = None) -> torch.Tensor:
    """NMS keep mask of quantised boxes (reference ``qnms_kernel.cpp``): IoUs on
    the dequantised coordinates; the scores only order, so their scale does not
    matter.  ``backend`` as ``ops.nms``."""
    boxes = dequantize(qboxes, boxes_scale, boxes_zero_point)
    return _nms(boxes, qscores.float(), iou_threshold, backend)


def qroi_align(qfeatures: torch.Tensor, rois: torch.Tensor, output_size, scale: float, zero_point: int,
               spatial_scale: float = 1.0, sampling_ratio: int = -1,
               aligned: bool = False) -> Tuple[torch.Tensor, float, int]:
    """RoIAlign of a quantised NHWC feature map (reference
    ``qroi_align_kernel.cpp``): dequantise, pool in float32, requantise with
    the input's (scale, zero_point); returns (values, scale, zero_point)."""
    feats = dequantize(qfeatures, scale, zero_point)
    out = _roi_align(feats, rois, output_size, spatial_scale, sampling_ratio, aligned)
    return quantize(out, scale, zero_point, qfeatures.dtype), scale, zero_point
