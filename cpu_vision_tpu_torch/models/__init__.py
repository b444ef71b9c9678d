"""Models of the port (``torch.nn``, NHWC input) with a name registry.

Counterpart of the JAX package's ``models``: so far the Vision Transformer,
whose encoder layers run the hand-written ``attention_block``, ``flash_mha``
and ``mlp_block`` kernels; Swin v1, v2 and the channel-padded Swin-T on
``window_attention_block`` and ``mlp_block``; ConvNeXt on ``cn_mlp_block`` and
``depthwise_conv2d``; the ResNet family on stock operators; and, in
``models.detection``, Faster R-CNN ResNet-50 FPN (v1 and v2) on the
``nms_sorted`` kernel, served through ``detection.detect``; and the int8
serving engines ``Int8ViT`` (on ``mlp_block_int8`` and ``attention_block_int8``)
and ``Int8ResNet`` (its 1x1 convolutions on ``int8_matmul_requant``).
``get_model(name, dtype=..., generator=..., device=...)`` builds one on the
first CUDA card unless ``device`` says otherwise; ``_convert`` carries the JAX
package's parameters across.
"""

from ._api import get_model, get_model_builder, list_models, register_model  # noqa: F401
from ._convert import (  # noqa: F401
    convnext_state_dict_from_numpy,
    faster_rcnn_state_dict_from_numpy,
    int8_scales_from_numpy,
    pointwise_state_dict_from_numpy,
    resnet_state_dict_from_numpy,
    swin_state_dict_from_numpy,
    vit_state_dict_from_numpy,
)
from . import detection  # noqa: F401
from .convnext import CNBlock, ConvNeXt, convnext_base, convnext_large, convnext_small, convnext_tiny  # noqa: F401
from .layers import DepthwiseConv, MaskedLayerNorm, PatchifyDense, StochasticDepth  # noqa: F401
from .quantization_resnet import Int8ResNet  # noqa: F401
from .quantization_vit import Int8ViT  # noqa: F401
from .resnet import (  # noqa: F401
    BasicBlock,
    Bottleneck,
    ResNet,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
    resnext50_32x4d,
    resnext101_32x8d,
    resnext101_64x4d,
    wide_resnet50_2,
    wide_resnet101_2,
)
from .swin import (  # noqa: F401
    PatchMerging,
    SwinBlock,
    SwinTransformer,
    WindowAttention,
    swin_b,
    swin_s,
    swin_t,
    swin_v2_b,
    swin_v2_s,
    swin_v2_t,
)
from .swin_padded import pad_swin_state_dict, swin_t_padded  # noqa: F401
from .vision_transformer import (  # noqa: F401
    EncoderBlock,
    FusedMHA,
    VisionTransformer,
    vit_b_16,
    vit_b_32,
    vit_h_14,
    vit_l_16,
    vit_l_32,
)
