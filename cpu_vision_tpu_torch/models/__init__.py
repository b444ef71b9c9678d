"""Models of the port (``torch.nn``, NHWC input) with a name registry.

Counterpart of the JAX package's ``models``: so far the Vision Transformer,
whose encoder layers run the hand-written ``attention_block``, ``flash_mha``
and ``mlp_block`` kernels, and the ResNet family on stock operators.
``get_model(name, dtype=..., generator=..., device=...)`` builds one on the
first CUDA card unless ``device`` says otherwise; ``_convert`` carries the JAX
package's parameters across.
"""

from ._api import get_model, get_model_builder, list_models, register_model  # noqa: F401
from ._convert import resnet_state_dict_from_numpy, vit_state_dict_from_numpy  # noqa: F401
from .layers import PatchifyDense  # noqa: F401
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
