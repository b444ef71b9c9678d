"""Image ops (PyTorch): op-by-op implementations, and the fused CUDA
kernels in ``ops.kernels``."""

from .boxes import (  # noqa: F401
    batched_nms,
    box_area,
    box_convert,
    box_iou,
    clip_boxes_to_image,
    complete_box_iou,
    distance_box_iou,
    generalized_box_iou,
    masks_to_boxes,
    nms,
    nms_padded,
    remove_small_boxes,
)
from .cnn import cnn_forward, cnn_init, cnn_params_from_numpy  # noqa: F401
from .color import (  # noqa: F401
    adjust_brightness,
    adjust_contrast,
    adjust_gamma,
    adjust_hue,
    adjust_saturation,
    autocontrast,
    blend,
    equalize,
    grayscale_to_rgb,
    hsv_to_rgb,
    invert,
    normalize,
    posterize,
    rgb_to_grayscale,
    rgb_to_hsv,
    solarize,
)
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
from .losses import (  # noqa: F401
    complete_box_iou_loss,
    distance_box_iou_loss,
    generalized_box_iou_loss,
    sigmoid_focal_loss,
)
from .pointwise import PointwiseConv, conv1x1  # noqa: F401
from .poolers import LevelMapper, MultiScaleRoIAlign, multiscale_roi_align  # noqa: F401
from .quantized import dequantize, qnms, qroi_align, quantize  # noqa: F401
from .pyramid import (  # noqa: F401
    gaussian_pyramid,
    laplacian_pyramid,
    pyr_down,
    pyr_up,
    reconstruct_from_laplacian,
)
from .regularizers import drop_block2d, drop_block3d, stochastic_depth  # noqa: F401
from .resize import rescale, resize, resize_weight_matrix  # noqa: F401
from .roi import roi_align, roi_align_pyramid  # noqa: F401
from .warp import (  # noqa: F401
    affine,
    affine_grid,
    elastic,
    get_inverse_affine_matrix,
    get_rotation_matrix,
    grid_sample,
    perspective,
    perspective_grid,
    rotate,
    warp_affine,
)
from . import kernels  # noqa: F401
