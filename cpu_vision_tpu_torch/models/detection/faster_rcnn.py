"""Faster R-CNN ResNet-50 FPN, v1 and v2, serving (counterpart of the JAX
package's ``models/detection/faster_rcnn.py``; reference
``torchvision/models/detection/faster_rcnn.py`` + ``generalized_rcnn.py:15``):
ResNet-50 FPN backbone, RPN, RoI heads and the postprocess, every stage with
fixed shapes.

The modules use torchvision's ``state_dict`` names (``backbone.body.*``,
``backbone.fpn.*``, ``rpn.head.*``, ``roi_heads.box_head.*``,
``roi_heads.box_predictor.*``); ``models._convert.faster_rcnn_state_dict_from_numpy``
carries the JAX package's variables in.  Parameters are float32; ``dtype``
(float32 or bfloat16) is the compute dtype, and float32 runs in full float32
on the card, not TF32.  ``set_nms(None|"kernel"|"plain")`` routes the three
NMS calls of a forward (two in the RPN, one in the postprocess) as
``ops.boxes.nms``'s ``backend`` (``None`` until set).  The MobileNet builders and training
(``forward_train``) are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..._dtype import full_float32
from ..._layout import as_tensor
from .._api import register_model
from ..layers import lecun_normal_
from ..resnet import Bottleneck, ResNet
from .backbone_utils import BackboneWithFPN
from .roi_heads import RoIHeads
from .rpn import RegionProposalNetwork

__all__ = ["FasterRCNN", "fasterrcnn_resnet50_fpn", "fasterrcnn_resnet50_fpn_v2"]


class FasterRCNN(nn.Module):
    """(reference ``FasterRCNN``, ``faster_rcnn.py:31-287``).  ``variant="v2"``
    is the v2 recipe: batch norms in the FPN, a 2-conv RPN head and the conv-fc
    box head.  ``forward`` takes an NHWC batch (a numpy array goes to the
    card) and returns the padded detections dict of ``RoIHeads.postprocess``."""

    def __init__(self, num_classes: int = 91, rpn_pre_nms_top_n: int = 1000, rpn_post_nms_top_n: int = 512,
                 max_detections: int = 100, box_score_thresh: float = 0.05, box_nms_thresh: float = 0.5,
                 variant: str = "v1", dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if variant not in ("v1", "v2"):
            raise ValueError(f"variant is 'v1' or 'v2', got {variant!r}")
        if dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"dtype is float32 or bfloat16, got {dtype}")
        self.dtype = dtype
        v2 = variant == "v2"
        body = ResNet(Bottleneck, (3, 4, 6, 3), num_classes=None, dtype=dtype, generator=generator)
        self.backbone = BackboneWithFPN(body, (256, 512, 1024, 2048), 256, fpn_norm="batch" if v2 else None)
        self.rpn = RegionProposalNetwork(256, pre_nms_top_n=rpn_pre_nms_top_n, post_nms_top_n=rpn_post_nms_top_n,
                                         conv_depth=2 if v2 else 1)
        self.roi_heads = RoIHeads(num_classes, max_detections=max_detections, score_thresh=box_score_thresh,
                                  nms_thresh=box_nms_thresh, box_head_type="convfc" if v2 else "mlp")
        self.reset_parameters(generator)
        self.requires_grad_(False)  # serving only: no stage records a graph
        self.eval()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX modules' initialisers for the FPN and the heads (the body
        drew its own): variance-scaling normal kernels, zero biases, batch
        norms at scale 1; drawn from ``generator``, not the JAX package's
        values for the same seed."""
        for part in (self.backbone.fpn, self.rpn, self.roi_heads):
            for m in part.modules():
                if isinstance(m, nn.Conv2d):
                    lecun_normal_(m.weight, m.weight[0].numel(), generator)
                    if m.bias is not None:
                        nn.init.zeros_(m.bias)
                elif isinstance(m, nn.Linear):
                    lecun_normal_(m.weight, m.in_features, generator)
                    nn.init.zeros_(m.bias)
                elif isinstance(m, nn.BatchNorm2d):
                    m.reset_parameters()

    def set_nms(self, nms: Optional[str]) -> None:
        """Route every NMS of the forward through ``nms`` (None, "kernel" or "plain")."""
        self.rpn.nms = nms
        self.roi_heads.nms = nms

    @torch.no_grad()
    def forward(self, images, train: bool = False):
        if train:
            raise NotImplementedError("serving only: forward_train and the losses are not ported yet")
        images = as_tensor(images)
        image_size = (images.shape[1], images.shape[2])
        with full_float32():
            features = self.backbone(images)
            proposals, _, _ = self.rpn(features, image_size)
            # RoI pooling uses the levels without the max-pool one (reference featmap_names 0..3)
            class_logits, box_deltas = self.roi_heads(features[:-1], proposals, image_size)
            return self.roi_heads.postprocess(class_logits, box_deltas, proposals, image_size)


def _build(variant: str, num_classes: int, dtype: torch.dtype, device, kwargs) -> FasterRCNN:
    model = FasterRCNN(num_classes=num_classes, variant=variant, dtype=dtype, **kwargs)
    return model.to("cuda" if device is None else device).to(memory_format=torch.channels_last)


@register_model("fasterrcnn_resnet50_fpn")
def fasterrcnn_resnet50_fpn(*, num_classes: int = 91, dtype: torch.dtype = torch.float32, device=None,
                            **kwargs) -> FasterRCNN:
    """Faster R-CNN ResNet-50 FPN (reference ``fasterrcnn_resnet50_fpn``).
    ``generator`` seeds the parameters, ``device`` defaults to the first
    CUDA card; other keywords go to ``FasterRCNN``."""
    return _build("v1", num_classes, dtype, device, kwargs)


@register_model("fasterrcnn_resnet50_fpn_v2")
def fasterrcnn_resnet50_fpn_v2(*, num_classes: int = 91, dtype: torch.dtype = torch.float32, device=None,
                               **kwargs) -> FasterRCNN:
    """The v2 recipe: FPN batch norms, 2-conv RPN head, conv-fc box head
    (reference ``fasterrcnn_resnet50_fpn_v2``, ``faster_rcnn.py:400-460``)."""
    return _build("v2", num_classes, dtype, device, kwargs)
