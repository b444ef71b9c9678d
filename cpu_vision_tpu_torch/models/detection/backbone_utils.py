"""FPN and backbone-with-FPN (counterpart of the JAX package's
``models/detection/backbone_utils.py``; reference
``torchvision/ops/feature_pyramid_network.py:36-238`` and
``models/detection/backbone_utils.py:13``), under torchvision's
``state_dict`` names: ``body.*`` (the ResNet without ``fc``),
``fpn.inner_blocks.{i}.0`` / ``fpn.layer_blocks.{i}.0`` and, with
``norm="batch"``, their batch norms ``.1``.

Maps are NHWC at the interfaces, as in the JAX package; inside, the
convolutions run on NCHW views of channels-last memory, as in the port's
ResNet.  ``LastLevelP6P7`` (RetinaNet, FCOS) is not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..resnet import BN_EPS, ResNet, _bn

__all__ = ["FeaturePyramidNetwork", "LastLevelMaxPool", "BackboneWithFPN"]


def conv_nhwc(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` (with its bias, if any) on an NHWC map, in the map's dtype."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(x.dtype), bias, conv.stride, conv.padding)
    return y.permute(0, 2, 3, 1)


def conv_block_nhwc(x: torch.Tensor, block: nn.Sequential) -> torch.Tensor:
    """A ``Conv2dNormActivation``-shaped block on an NHWC map: the conv, its
    batch norm from the running statistics (in float32) if the block has one,
    and its ReLU if it has one."""
    y = conv_nhwc(x, block[0])
    for layer in list(block)[1:]:
        if isinstance(layer, nn.BatchNorm2d):
            y = _bn(y.permute(0, 3, 1, 2), layer).permute(0, 2, 3, 1)
        elif isinstance(layer, nn.ReLU):
            y = torch.relu(y)
    return y


def _conv_norm(cin: int, cout: int, kernel: int, norm: Optional[str]) -> nn.Sequential:
    layers: List[nn.Module] = [nn.Conv2d(cin, cout, kernel, padding=kernel // 2, bias=norm is None)]
    if norm == "batch":
        layers.append(nn.BatchNorm2d(cout, eps=BN_EPS))
    return nn.Sequential(*layers)


class FeaturePyramidNetwork(nn.Module):
    """Top-down pyramid with lateral 1x1s and output 3x3s (reference
    ``FeaturePyramidNetwork``, ``ops/feature_pyramid_network.py:36``).
    ``norm="batch"`` puts a batch norm after every conv and drops the conv
    biases (the v2 recipe's FPN)."""

    def __init__(self, in_channels_list: Sequence[int], out_channels: int = 256, norm: Optional[str] = None):
        super().__init__()
        if norm not in (None, "batch"):
            raise ValueError(f"norm is None or 'batch', got {norm!r}")
        self.inner_blocks = nn.ModuleList(_conv_norm(c, out_channels, 1, norm) for c in in_channels_list)
        self.layer_blocks = nn.ModuleList(_conv_norm(out_channels, out_channels, 3, norm) for _ in in_channels_list)

    def forward(self, features: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        names = sorted(features)  # layer1..layer4, ascending depth
        laterals = [conv_block_nhwc(features[n], blk) for n, blk in zip(names, self.inner_blocks)]
        # top-down: nearest-resize to the target level's size with the JAX
        # package's integer index (arange(th) * sh) // th, and add
        results = [None] * len(laterals)
        last = laterals[-1]
        results[-1] = last
        for i in range(len(laterals) - 2, -1, -1):
            target = laterals[i]
            th, tw = target.shape[1], target.shape[2]
            sh, sw = last.shape[1], last.shape[2]
            up = last
            if (sh, sw) != (th, tw):
                iy = torch.arange(th, device=last.device) * sh // th
                ix = torch.arange(tw, device=last.device) * sw // tw
                up = last.index_select(1, iy).index_select(2, ix)
            last = target + up
            results[i] = last
        return {n: conv_block_nhwc(r, blk) for n, r, blk in zip(names, results, self.layer_blocks)}


class LastLevelMaxPool(nn.Module):
    """Extra P-level by a 1x1 max pool of stride 2, that is every other row
    and column (reference ``LastLevelMaxPool``,
    ``ops/feature_pyramid_network.py:207``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x[:, ::2, ::2]


class BackboneWithFPN(nn.Module):
    """The four stages of a ResNet + FPN + the max-pool level (reference
    ``BackboneWithFPN``, ``detection/backbone_utils.py:13``; the JAX module's
    other taps and its P6/P7 levels serve models not ported yet)."""

    def __init__(self, body: ResNet, in_channels_list: Sequence[int], out_channels: int = 256,
                 fpn_norm: Optional[str] = None):
        super().__init__()
        self.body = body
        self.fpn = FeaturePyramidNetwork(in_channels_list, out_channels, norm=fpn_norm)
        self.extra_pool = LastLevelMaxPool()

    def forward(self, x) -> List[torch.Tensor]:
        """NHWC images -> [P2, P3, P4, P5, pool], NHWC."""
        fpn = self.fpn(self.body(x, features_only=True))
        outs = [fpn[k] for k in sorted(fpn)]
        return outs + [self.extra_pool(outs[-1])]
