"""Hand-written CUDA kernels for Hopper, with their plain PyTorch twins.

Counterpart of ``cpu_vision_tpu.ops.pallas``: the fused stencil pipelines
(``stencil.py``, sources in ``cpu_vision_tpu_torch/csrc/stencil.cu``).  The
op-by-op functions of ``cpu_vision_tpu_torch.ops`` are their oracles.
"""

from .stencil import (  # noqa: F401
    KERNEL_WRAPPERS,
    canny_stage1,
    fused_blur_sobel,
    fused_canny,
    harris_response_fused,
    hysteresis_fixpoint,
    hysteresis_sweeps,
    launch_counts,
    reset_launch_counts,
)
