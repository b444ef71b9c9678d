"""Hand-written CUDA kernels for Hopper, with their plain PyTorch twins.

Counterpart of ``cpu_vision_tpu.ops.pallas``: the fused stencil pipelines
(``stencil.py``, sources in ``cpu_vision_tpu_torch/csrc/stencil.cu``) and the
fused conv3x3 + ReLU + pool stage (``conv_block.py``, ``csrc/conv_block.cu``).
The op-by-op functions of ``cpu_vision_tpu_torch.ops`` are their oracles.
"""

from .conv_block import (  # noqa: F401
    conv3x3_relu_pool,
    fused_conv3x3_relu_pool,
    fused_conv3x3_relu_pool_plain,
)
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
from . import stencil as _stencil

# Every wrapper that launches a kernel; each counts its launches.
KERNEL_WRAPPERS = (*_stencil.KERNEL_WRAPPERS, fused_conv3x3_relu_pool)


def launch_counts() -> dict:
    """``{wrapper name: kernel launches so far}``."""
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
