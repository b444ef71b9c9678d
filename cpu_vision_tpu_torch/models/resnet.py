"""ResNet family (reference ``torchvision/models/resnet.py``): ``BasicBlock``,
``Bottleneck`` (stride on the 3x3, the "V1.5" variant), ``ResNet`` and its ten
registered variants, resnet18 to wide_resnet101_2.

Counterpart of the JAX package's ``models/resnet.py``, serving
(``train=False``) only.  Input and feature maps are NHWC as there; inside,
the maps are NCHW tensors in channels-last memory, so no copy is made.
Parameters are float32 under torchvision's ``state_dict`` keys; ``dtype``
(float32 or bfloat16) is the compute dtype.  Every operator is stock PyTorch
(``conv2d``, ``batch_norm``, ``max_pool2d``): the JAX model runs no
hand-written kernel either.  Float32 runs in full float32 on the card, not
TF32 (``_dtype.full_float32``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Type, Union

import torch
import torch.nn.functional as F
from torch import nn

from .._dtype import full_float32
from .._layout import as_tensor
from ._api import register_model
from .layers import lecun_normal_

__all__ = ["ResNet", "BasicBlock", "Bottleneck", "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
           "resnext50_32x4d", "resnext101_32x8d", "resnext101_64x4d", "wide_resnet50_2", "wide_resnet101_2"]

BN_EPS = 1e-5


def _conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    return F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride, conv.padding, conv.dilation, conv.groups)


def _bn(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Inference batch norm from the running statistics, in float32."""
    out = F.batch_norm(x.float(), bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, bn.eps)
    return out.to(x.dtype)


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False), nn.BatchNorm2d(cout, eps=BN_EPS))


class BasicBlock(nn.Module):
    """Two 3x3 convolutions (reference ``BasicBlock``).  As there, it has no
    grouped, widened or dilated form and refuses one, where the JAX module
    builds the plain block without a word."""

    expansion = 1

    def __init__(self, inplanes: int, features: int, strides: int = 1, downsample: bool = False, groups: int = 1,
                 base_width: int = 64, dilation: int = 1, zero_init_residual: bool = True):
        super().__init__()
        if groups != 1 or base_width != 64:
            raise ValueError("BasicBlock only supports groups=1 and base_width=64")
        if dilation > 1:
            raise NotImplementedError("dilation > 1 is not supported in BasicBlock")
        self.conv1 = nn.Conv2d(inplanes, features, 3, strides, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(features, eps=BN_EPS)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(features, eps=BN_EPS)
        self.downsample = _downsample(inplanes, features, strides) if downsample else None
        self.zero_init_residual = zero_init_residual

    @property
    def last_bn(self) -> nn.BatchNorm2d:
        return self.bn2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(_bn(_conv(x, self.conv1), self.bn1))
        out = _bn(_conv(out, self.conv2), self.bn2)
        if self.downsample is not None:
            x = _bn(_conv(x, self.downsample[0]), self.downsample[1])
        return torch.relu(out + x)


class Bottleneck(nn.Module):
    """1x1 → 3x3 (stride, groups, dilation) → 1x1 ×4 (reference ``Bottleneck``)."""

    expansion = 4

    def __init__(self, inplanes: int, features: int, strides: int = 1, downsample: bool = False, groups: int = 1,
                 base_width: int = 64, dilation: int = 1, zero_init_residual: bool = True):
        super().__init__()
        width = int(features * (base_width / 64.0)) * groups
        out = features * self.expansion
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width, eps=BN_EPS)
        self.conv2 = nn.Conv2d(width, width, 3, strides, dilation, dilation, groups, bias=False)
        self.bn2 = nn.BatchNorm2d(width, eps=BN_EPS)
        self.conv3 = nn.Conv2d(width, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out, eps=BN_EPS)
        self.downsample = _downsample(inplanes, out, strides) if downsample else None
        self.zero_init_residual = zero_init_residual

    @property
    def last_bn(self) -> nn.BatchNorm2d:
        return self.bn3

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(_bn(_conv(x, self.conv1), self.bn1))
        out = torch.relu(_bn(_conv(out, self.conv2), self.bn2))
        out = _bn(_conv(out, self.conv3), self.bn3)
        if self.downsample is not None:
            x = _bn(_conv(x, self.downsample[0]), self.downsample[1])
        return torch.relu(out + x)


class ResNet(nn.Module):
    """Reference ``ResNet``: 7x7/2 stem and 3x3/2 max pool, four stages of
    [64, 128, 256, 512] width, global average pool, ``fc``.  ``forward`` takes
    an NHWC tensor on the parameters' device, or a numpy array, which goes to
    the card; with ``features_only`` it returns the four stages' NHWC maps.
    ``num_classes=None`` builds no ``fc`` (a detector's body, whose
    ``state_dict`` torchvision keeps without it) and runs ``features_only``."""

    def __init__(self, block: Type[Union[BasicBlock, Bottleneck]], layers: Sequence[int],
                 num_classes: Optional[int] = 1000,
                 groups: int = 1, width_per_group: int = 64, zero_init_residual: bool = True,
                 replace_stride_with_dilation: Sequence[bool] = (False, False, False),
                 dtype: torch.dtype = torch.float32, in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"dtype is float32 or bfloat16, got {dtype}")
        if len(replace_stride_with_dilation) != 3:
            raise ValueError("replace_stride_with_dilation takes three flags")
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=BN_EPS)
        inplanes, dilation = 64, 1
        for i, (width, n_blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stage_stride = 2 if i > 0 else 1
            # dilate instead of striding when asked; the stage's first block
            # keeps the dilation of the stage before
            prev_dilation = dilation
            if i > 0 and replace_stride_with_dilation[i - 1]:
                dilation *= stage_stride
                stage_stride = 1
            blocks = []
            for j in range(n_blocks):
                strides = stage_stride if j == 0 else 1
                downsample = j == 0 and (strides != 1 or inplanes != width * block.expansion)
                blocks.append(block(inplanes, width, strides, downsample, groups, width_per_group,
                                    prev_dilation if j == 0 else dilation, zero_init_residual))
                inplanes = width * block.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(inplanes, num_classes) if num_classes is not None else None
        self.reset_parameters(generator)
        self.eval()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX module's initialisers: variance-scaling normal kernels,
        zero biases, batch-norm scale 1 but 0 on each block's last one (so a
        block starts as the identity), drawn from ``generator``; not the JAX
        package's values for the same seed."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, m.weight[0].numel(), generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, nn.Linear):
                lecun_normal_(m.weight, m.in_features, generator)
                nn.init.zeros_(m.bias)
        for m in self.modules():
            if isinstance(m, (BasicBlock, Bottleneck)) and m.zero_init_residual:
                nn.init.zeros_(m.last_bn.weight)

    @torch.no_grad()
    def forward(self, x, train: bool = False, features_only: bool = False):
        if train:
            raise NotImplementedError("serving only: batch statistics and the backward are not ported yet")
        x = as_tensor(x).to(self.dtype).permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels-last
        feats: Dict[str, torch.Tensor] = {}
        with full_float32():
            x = torch.relu(_bn(_conv(x, self.conv1), self.bn1))
            x = F.max_pool2d(x, 3, 2, 1)  # pads with -inf
            for i in range(1, 5):
                x = getattr(self, f"layer{i}")(x)
                feats[f"layer{i}"] = x.permute(0, 2, 3, 1)
            if features_only or self.fc is None:
                return feats
            x = x.float().mean(dim=(2, 3)).to(self.dtype)
            return F.linear(x, self.fc.weight.to(self.dtype), self.fc.bias.to(self.dtype))


def _make(name: str, block, layers: Sequence[int], extra: Optional[dict] = None):
    extra = extra or {}

    def build(*, num_classes: int = 1000, dtype: torch.dtype = torch.float32, device=None, **kwargs) -> ResNet:
        model = ResNet(block, layers, num_classes=num_classes, dtype=dtype, **{**extra, **kwargs})
        return model.to("cuda" if device is None else device).to(memory_format=torch.channels_last)

    build.__name__ = name
    build.__doc__ = (f"{name}: ``dtype`` float32 or bfloat16, ``generator`` seeds the parameters, ``device`` "
                       "defaults to the first CUDA card; other keywords go to ``ResNet``.")
    return register_model(name)(build)


resnet18 = _make("resnet18", BasicBlock, (2, 2, 2, 2))
resnet34 = _make("resnet34", BasicBlock, (3, 4, 6, 3))
resnet50 = _make("resnet50", Bottleneck, (3, 4, 6, 3))
resnet101 = _make("resnet101", Bottleneck, (3, 4, 23, 3))
resnet152 = _make("resnet152", Bottleneck, (3, 8, 36, 3))
resnext50_32x4d = _make("resnext50_32x4d", Bottleneck, (3, 4, 6, 3), {"groups": 32, "width_per_group": 4})
resnext101_32x8d = _make("resnext101_32x8d", Bottleneck, (3, 4, 23, 3), {"groups": 32, "width_per_group": 8})
resnext101_64x4d = _make("resnext101_64x4d", Bottleneck, (3, 4, 23, 3), {"groups": 64, "width_per_group": 4})
wide_resnet50_2 = _make("wide_resnet50_2", Bottleneck, (3, 4, 6, 3), {"width_per_group": 128})
wide_resnet101_2 = _make("wide_resnet101_2", Bottleneck, (3, 4, 23, 3), {"width_per_group": 128})
