"""Hand-written CUDA kernels for Hopper, with their plain PyTorch twins.

Counterpart of ``cpu_vision_tpu.ops.pallas``: the fused stencil pipelines
(``stencil.py``, sources in ``cpu_vision_tpu_torch/csrc/stencil.cu``), the
fused conv3x3 + ReLU + pool stage (``conv_block.py``, ``csrc/conv_block.cu``),
fused multi-head attention (``flash_attention.py``, ``csrc/attention.cu``),
the fused attention and MLP sub-blocks of a transformer encoder layer and the
tail of a ConvNeXt block (``transformer_block.py``,
``csrc/transformer_block.cu``), Swin's window attention sub-block
(``swin_attention.py``, ``csrc/swin_attention.cu``) and the depthwise
convolution (``depthwise.py``, ``csrc/depthwise.cu``), the greedy NMS of
boxes sorted by score (``nms.py``, ``csrc/nms.cu``), the int8 product with a
requantising epilogue (``int8_matmul.py``, ``csrc/int8_matmul.cu``) and the
int8 attention and MLP sub-blocks (``int8_transformer.py``,
``csrc/int8_transformer.cu``) and the weight gradient of a pointwise
convolution (``wgrad_matmul.py``, ``csrc/wgrad_matmul.cu``); and, for the
bfloat16 transformer blocks' backward, the attention core's backward
(``flash_attention.attention_core_backward``, ``csrc/tc_attention_bwd.cuh``),
the MLP's gelu backward as a product epilogue
(``transformer_block.mlp_gelu_backward``) and the LayerNorm backward rows
(``transformer_block.ln_backward_rows``, both ``csrc/ln_gemm.cuh``).  The op-by-op
functions of ``cpu_vision_tpu_torch.ops`` and the stock-operator routes of
``cpu_vision_tpu_torch.models`` are their oracles.
"""

from .conv_block import (  # noqa: F401
    conv3x3_relu_pool,
    fused_conv3x3_relu_pool,
    fused_conv3x3_relu_pool_plain,
)
from .depthwise import depthwise_conv2d, depthwise_conv2d_plain  # noqa: F401
from .flash_attention import (  # noqa: F401
    attention_core_backward,
    attention_core_backward_plain,
    flash_mha,
    flash_mha_plain,
)
from .int8_matmul import int8_matmul_requant, int8_matmul_requant_plain  # noqa: F401
from .int8_transformer import (  # noqa: F401
    attention_block_int8,
    attention_block_int8_plain,
    mlp_block_int8,
    mlp_block_int8_plain,
    quantize_weight,
)
from .nms import nms_sorted, nms_sorted_plain  # noqa: F401
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
from .swin_attention import window_attention_block, window_attention_block_plain  # noqa: F401
from .transformer_block import (  # noqa: F401
    attention_block,
    attention_block_plain,
    bf16_product,
    bf16_product_plain,
    attention_block_backward_plain,
    cn_mlp_block,
    cn_mlp_block_plain,
    ln_backward_plain,
    ln_backward_rows,
    mlp_block,
    mlp_block_backward_plain,
    mlp_block_plain,
    mlp_gelu_backward,
    mlp_gelu_backward_plain,
)
from .wgrad_matmul import wgrad_matmul, wgrad_matmul_plain  # noqa: F401
from . import _build
from . import stencil as _stencil

# Every wrapper that launches a kernel; each counts its launches.  bf16_product, alone a test entry, runs the
# activation gradients of the bf16 blocks' backward.
KERNEL_WRAPPERS = (*_stencil.KERNEL_WRAPPERS, fused_conv3x3_relu_pool, flash_mha, attention_block, mlp_block,
                   cn_mlp_block, window_attention_block, depthwise_conv2d, nms_sorted, int8_matmul_requant,
                   mlp_block_int8, attention_block_int8, wgrad_matmul, bf16_product, mlp_gelu_backward,
                   attention_core_backward, ln_backward_rows)


def launch_counts() -> dict:
    """``{wrapper name: kernel launches so far}``."""
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def launch_counts_by_shape() -> dict:
    """``{wrapper name: {(shape of the kernel's input, its dtype): launches so far}}``."""
    return {fn.__name__: dict(fn.launches_by_shape) for fn in KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        _build.reset_count(fn)
    _stencil.hysteresis_fixpoint.host_reads = 0
    attention_block.kernel_launches = 0
    mlp_block.kernel_launches = 0
    cn_mlp_block.kernel_launches = 0
    window_attention_block.kernel_launches = 0
    attention_block_int8.kernel_launches = 0
    mlp_block_int8.kernel_launches = 0
    attention_core_backward.kernel_launches = 0
