"""Hand-written CUDA kernels for Hopper, with their plain PyTorch twins.

Counterpart of ``cpu_vision_tpu.ops.pallas``: the fused stencil pipelines
(``stencil.py``, sources in ``cpu_vision_tpu_torch/csrc/stencil.cu``), the
fused conv3x3 + ReLU + pool stage (``conv_block.py``, ``csrc/conv_block.cu``),
fused multi-head attention (``flash_attention.py``, ``csrc/attention.cu``)
and the fused attention and MLP sub-blocks of a transformer encoder layer
(``transformer_block.py``, ``csrc/transformer_block.cu``).  The op-by-op
functions of ``cpu_vision_tpu_torch.ops`` and the stock-operator routes of
``cpu_vision_tpu_torch.models`` are their oracles.
"""

from .conv_block import (  # noqa: F401
    conv3x3_relu_pool,
    fused_conv3x3_relu_pool,
    fused_conv3x3_relu_pool_plain,
)
from .flash_attention import flash_mha, flash_mha_plain  # noqa: F401
from .stencil import (  # noqa: F401
    canny_stage1,
    canny_stage1_in_tile,
    fused_blur_sobel,
    fused_canny,
    fused_gaussian_blur,
    harris_response_fused,
    hysteresis_fixpoint,
    hysteresis_sweeps,
)
from .transformer_block import (  # noqa: F401
    attention_block,
    attention_block_plain,
    mlp_block,
    mlp_block_plain,
)
from . import stencil as _stencil

# Every wrapper that launches a kernel; each counts its launches.
KERNEL_WRAPPERS = (*_stencil.KERNEL_WRAPPERS, fused_conv3x3_relu_pool, flash_mha, attention_block, mlp_block)


def launch_counts() -> dict:
    """``{wrapper name: kernel launches so far}``."""
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    attention_block.kernel_launches = 0
