"""Image ops (PyTorch): op-by-op implementations, and the fused CUDA
kernels in ``ops.kernels``."""

from .color import grayscale_to_rgb, rgb_to_grayscale  # noqa: F401
from .edges import canny, canny_nms, harris, harris_response, hysteresis  # noqa: F401
from .filters import (  # noqa: F401
    adjust_sharpness,
    box_blur,
    filter2d,
    gaussian_blur,
    get_gaussian_kernel1d,
    get_gaussian_kernel2d,
    laplacian,
    pad2d,
    scharr_kernels,
    separable_filter2d,
    sobel,
    sobel_gradients,
    sobel_kernels,
    spatial_gradient,
    unsharp_mask,
)
from . import kernels  # noqa: F401
