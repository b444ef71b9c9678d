"""cpu_vision_tpu_torch — the PyTorch/CUDA port of ``cpu_vision_tpu``.

Same public functions, semantics and module layout as the JAX package,
on PyTorch tensors, with the fused stencil pipelines and the CNN's fused
conv stage as hand-written CUDA kernels for Hopper (``ops/kernels``,
sources in ``csrc/``).  Images are
channels-last (HW / HWC / NHWC).  A tensor is computed on its own device;
any other input (a numpy array) goes to the first CUDA card.

Subpackages
-----------
``ops``   color, filters (blur, Sobel, ...), Canny and Harris, resize,
          pyramids, warps, the small CNN, and the fused kernels in
          ``ops.kernels``
"""

__version__ = "0.1.0"

from . import _dtype, _layout, ops  # noqa: F401
from ._dtype import to_dtype  # noqa: F401
